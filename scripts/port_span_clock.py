"""The port's crt.* spans on the host's clock, with no profiler recording.

    python3 scripts/port_span_clock.py [--cells defaults.export,c4.export,c4.caption]
        [--calls 64] [--seed N] [--out FILE]

On a CUDA device. First the cost of one span: ``perf.span`` entered and
left 10^6 times with no profiler (the median of 5 runs), 10^5 times under
a recording torch.profiler (the median of 3), and the same for this
script's recorder. Then, for each benchmark cell, the cell's engine is
built and warmed as ``portbench.run`` builds it, ``perf.span`` is swapped
for the recorder (``time.perf_counter_ns`` at each enter and exit) and
``--calls`` calls are driven, at most two in flight, by the harness's
Driver. The recorded spans go, as host events of a trace, through the
benchmark's own readers (call_ms, inputs_ms, wrapper_us, launch_us), so
the readings are those of a traced run without the profiler's cost:
each line gives them beside the harness's dispatch_ms of the same calls,
the quartiles of each over the calls, the share of each call the spans
inside it cover, and each span's count per call and median duration.
One JSON line per measurement, on standard output and in ``--out``.
"""

import argparse
import contextlib
import io
import json
import os
import statistics
import sys
import time
from types import SimpleNamespace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from portbench import run as prun  # noqa: E402
from portbench import spans, trace as ptrace  # noqa: E402

READERS = ("call_ms", "inputs_ms", "wrapper_us", "launch_us")


class Recorder:
    """A span that logs (name, start µs, duration µs) on the host's clock."""

    __slots__ = ("name", "t0")
    log: list = []

    def __init__(self, name: str) -> None:
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter_ns()

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        Recorder.log.append((self.name, self.t0 / 1e3, (t1 - self.t0) / 1e3))


def per_span_us(make, n: int, runs: int) -> list:
    """µs per enter and exit of ``make(name)``, one value per run."""
    out = []
    for _ in range(runs):
        t = time.perf_counter()
        for _ in range(n):
            with make("crt.cost"):
                pass
        out.append((time.perf_counter() - t) / n * 1e6)
        Recorder.log.clear()
    return out


def span_costs() -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from pythoncrt_tpu_torch import perf

    off = per_span_us(perf.span, 10**6, 5)
    rec = per_span_us(Recorder, 10**6, 5)
    on = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            on += per_span_us(perf.span, 10**5, 1)
    assert not torch.autograd.profiler._is_profiler_enabled
    return {"what": "span_cost_us", "off": statistics.median(off), "off_runs": off,
            "on": statistics.median(on), "on_runs": on, "recorder": statistics.median(rec),
            "recorder_runs": rec}


def quartiles(values) -> list:
    return statistics.quantiles(values, n=4) if len(values) > 1 else list(values) * 3


def cell(workload: str, seed: int, calls: int) -> dict:
    import torch

    from pythoncrt_tpu_torch import perf

    dev = torch.device("cuda")
    _, _, cfg, traffic = prun.cell_spec(workload)
    ecfg = prun.effective_cfg(cfg, traffic)
    entry = prun.load_module("entries", traffic["entry"]).Entry(ecfg, traffic)
    entry.build(seed, dev, prun.overlay_for(traffic, int(cfg["height"]), int(cfg["width"]),
                                            seed))
    ring = prun.make_ring(seed, traffic, entry.shape, dev)
    pool = [torch.empty(entry.shape, dtype=torch.uint8, device=dev) for _ in range(3)]
    drv = prun.Driver(entry, ring, dev)
    drv.drive(lambda k: pool[k % 3], calls=prun.WARM_CALLS + 2)
    torch.cuda.synchronize()
    Recorder.log.clear()
    saved, perf.span = perf.span, Recorder
    try:
        recs = drv.drive(lambda k: pool[k % 3], calls=calls)
    finally:
        perf.span = saved
    host = sorted(Recorder.log, key=lambda h: h[1])
    Recorder.log.clear()
    entry.release()
    tr = ptrace.Trace(host=host, calls=len(recs), frames=len(recs) * entry.frames)
    ctx = SimpleNamespace(cfg=ecfg, trace=tr, library=set(),
                          dispatch_s=[r[2] - r[1] for r in recs])
    with contextlib.redirect_stderr(io.StringIO()):  # the readers' notes on a traced run
        res = {m: prun.load_module("metrics", m).read(ctx) for m in READERS}
    res["dispatch_ms"] = statistics.median(ctx.dispatch_s) * 1e3
    # each reading call by call: its quartiles over the calls
    per_call = {"call_ms": [], "inputs_ms": [], "wrapper_us": [], "launch_us": [],
                "dispatch_ms": [s * 1e3 for s in ctx.dispatch_s]}
    for _, ts, dur in spans.named(tr, spans.CALL):
        inner = [h for h in host if h[1] >= ts and h[1] + h[2] <= ts + dur]
        launch = [d for n, _, d in inner if n == spans.LAUNCH]
        wrap = sum(d for n, _, d in inner if n in spans.WRAPPERS)
        per_call["call_ms"].append(dur / 1e3)
        per_call["inputs_ms"].append(sum(d for n, _, d in inner if n in spans.INPUTS) / 1e3)
        if launch:
            per_call["wrapper_us"].append((wrap - sum(launch)) / len(launch))
            per_call["launch_us"].append(sum(launch) / len(launch))
    names: dict = {}
    for n, _, d in host:
        names.setdefault(n, []).append(d)
    cover = spans.call_coverage(tr)
    return {"what": "cell", "workload": workload, "seed": seed, "calls": len(recs),
            "readings": res, "quartiles": {k: quartiles(v) for k, v in per_call.items() if v},
            "coverage_min": min(cover), "coverage_median": statistics.median(cover),
            "spans": {n: {"per_call": len(d) / len(recs), "median_us": statistics.median(d)}
                      for n, d in sorted(names.items())}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cells", default="defaults.export,c4.export,c4.caption")
    ap.add_argument("--calls", type=int, default=64)
    ap.add_argument("--seed", type=int, default=2**31 + 7)
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    prun.cache_dirs()
    import torch

    if not torch.cuda.is_available():
        print("port_span_clock: needs a CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(1)  # as the harness runs
    lines = [dict(span_costs(), card=prun.card())]
    for k, w in enumerate(filter(None, a.cells.split(","))):
        lines.append(cell(w, a.seed + k, a.calls))
    for line in lines:
        print(json.dumps(line), flush=True)
    if a.out:
        with open(a.out, "w") as f:
            f.writelines(json.dumps(line) + "\n" for line in lines)
    return 0


if __name__ == "__main__":
    sys.exit(main())
