"""One run of one cell of the port's benchmark.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds BENCHMARK.json. The cell names a
configuration (its file under portbench/configs/) and a traffic mix
(portbench/traffic/<traffic>.json), whose entry (portbench/entries/) builds
the port's engine and says how a call drives it. A run:

1. makes the CUDA context, has the entry load the port's kernel library
   (built into the checkout at its first use there) and build the engine,
   makes its input ring on the card from the seed and warms the cell's one
   call shape with two calls: set-up, whose phases go to standard error;
2. drives the calls for ``--seconds``, at most two in flight as the render
   loop keeps them, each call's completion seen by waiting on its event
   before a third is enqueued; the frame indices rise through the stream
   and the persistence state is carried from call to call;
3. with ``--trace 1``, profiles a short stretch of further calls and reads
   the cell's per-layer metrics from it (portbench/metrics/);
4. reads the peak device memory, frees the port's state and holds the
   frames of three calls of the window (its first, one drawn from the
   seed, and its last) to the plain reference
   (portbench/reference/), each number beside its limit
   (portbench/limits/<cell>.json);
5. prints one JSON line: ``correct``, ``attempted``, ``failed``,
   ``metrics``, ``device`` (and ``breakdown`` with ``--trace 1``), the
   card, and last the compared numbers with their limits.

The process runs torch with one intra-op thread, where the port's CLI keeps
torch's default of one per core (PERF.md says why). It exits 2 without
enough CUDA devices, and 3 when a module of JAX, Flax
or the JAX package (pythoncrt_tpu, compared by whole top-level name) is
loaded once the window has closed; neither prints a result.
"""

import time

T_START = time.perf_counter()  # the set-up time counts from here

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from collections import deque  # noqa: E402
from types import SimpleNamespace  # noqa: E402

import numpy as np  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "portbench")
BANNED = ("jax", "jaxlib", "flax", "pythoncrt_tpu")
WARM_CALLS = 2  # the stream's first call (no carried state) and one that carries it
IN_FLIGHT = 2


def banned_modules(names) -> list:
    """The banned top-level packages among module names, compared whole:
    pythoncrt_tpu_torch is not pythoncrt_tpu."""
    return sorted({n.split(".")[0] for n in names} & set(BANNED))


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """portbench/<kind>/<name>.py, by file: the names of BENCHMARK.json may
    hold dots."""
    path = os.path.join(HERE, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"portbench_{kind}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_spec(workload: str) -> tuple:
    """(BENCHMARK.json, its cell, the configuration, the traffic)."""
    bench = load_json(ROOT, "BENCHMARK.json")
    cell = next((c for c in bench["workloads"] if c["name"] == workload), None)
    if cell is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    return bench, cell, load_json(ROOT, conf["file"]), load_json(HERE, "traffic",
                                                                  f"{cell['traffic']}.json")


def cache_dirs() -> None:
    """Build caches at fixed paths inside the checkout (the port builds its
    kernel library under pythoncrt_tpu_torch/_build/ by itself)."""
    base = os.path.join(HERE, "_cache")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(base, sub)


def overlay_for(traffic: dict, h: int, w: int, seed: int):
    """(H, W, 4) uint8 RGBA of the traffic's caption: values drawn from the
    seed over its box, clear elsewhere; None without a caption."""
    ov = traffic.get("overlay")
    if not ov:
        return None
    y0, x0, bh, bw = ov["box"]
    img = np.zeros((h, w, 4), np.uint8)
    region = img[y0:y0 + bh, x0:x0 + bw]
    region[...] = np.random.default_rng(seed).integers(0, 256, region.shape, dtype=np.uint8)
    return img


def sample_calls(seed: int) -> tuple[int, int]:
    """The compared calls known before the window: its first, and one of
    the eight after the next drawn from the seed."""
    return WARM_CALLS, WARM_CALLS + 2 + int(np.random.default_rng(seed).integers(0, 8))


def make_ring(seed: int, traffic: dict, shape: tuple, device):
    """The input ring: ``traffic["ring"]`` calls' uint8 frames of ``shape``,
    drawn on the device from the seed in one call."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(0, 256, (int(traffic["ring"]), *shape), generator=gen, device=device,
                         dtype=torch.uint8)


def effective_cfg(cfg: dict, traffic: dict) -> dict:
    """The configuration with the traffic's caption as its text parameters."""
    ov = traffic.get("overlay")
    text = {k: v for k, v in (ov or {}).items() if k != "box"}
    return dict(cfg, params=dict(cfg["params"], text=text))


def card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=60).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi not readable"


class Driver:
    """Drives the entry's calls over the input ring, at most IN_FLIGHT in
    flight, into the given output buffers."""

    def __init__(self, entry, ring, device) -> None:
        import torch

        self.torch, self.entry, self.ring = torch, entry, ring
        self.cuda = device.type == "cuda"
        self.k, self.state = 0, None

    def _retire(self, pending, recs):
        k, t0, t1, ev = pending.popleft()
        if ev is not None:
            ev.synchronize()
        recs.append((k, t0, t1, time.perf_counter()))

    def drive(self, out_for, *, calls=None, until=None) -> list:
        """Calls from self.k on, each writing into out_for(k), for ``calls``
        calls or until the host clock reaches ``until``; every call is waited
        for. Returns (k, enqueue start, enqueue end, completion seen) per call."""
        recs, pending = [], deque()
        n = 0
        while (calls is None or n < calls) and (until is None or time.perf_counter() < until):
            if len(pending) == IN_FLIGHT:
                self._retire(pending, recs)
            k = self.k
            x, idx = self.ring[k % self.ring.shape[0]], self.entry.indices(k)
            t0 = time.perf_counter()
            self.state = self.entry.call(x, idx, self.state, out_for(k))
            t1 = time.perf_counter()
            ev = None
            if self.cuda:
                ev = self.torch.cuda.Event()
                ev.record()
            pending.append((k, t0, t1, ev))
            self.k, n = k + 1, n + 1
        while pending:
            self._retire(pending, recs)
        return recs


def run(workload: str, seed: int, seconds: float, trace: bool, *, device: str = "cuda",
        cfg_over: dict = None, traffic_over: dict = None) -> dict:
    """One run; returns the result line's object. ``device``, ``cfg_over``
    and ``traffic_over`` (sizes) let the tests drive it on the CPU."""
    import torch

    from portbench.reference.chain import lead_frames

    marks = [("import", time.perf_counter())]
    bench, cell, cfg, traffic = cell_spec(workload)
    cfg = dict(cfg, **(cfg_over or {}))
    traffic = dict(traffic, **(traffic_over or {}))
    ecfg = effective_cfg(cfg, traffic)
    dev = torch.device(device)
    h, w = int(cfg["height"]), int(cfg["width"])
    if dev.type == "cuda":
        torch.empty(1, device=dev)  # the CUDA context
    marks.append(("context", time.perf_counter()))
    overlay = overlay_for(traffic, h, w, seed)
    entry = load_module("entries", traffic["entry"]).Entry(ecfg, traffic)
    entry.build(seed, dev, overlay)
    marks.append(("engine", time.perf_counter()))
    ring = make_ring(seed, traffic, entry.shape, dev)
    pool = [torch.empty(entry.shape, dtype=torch.uint8, device=dev) for _ in range(3)]
    k_first, k_mid = sample_calls(seed)
    kept = {k_first: torch.empty_like(pool[0]), k_mid: torch.empty_like(pool[0])}
    drv = Driver(entry, ring, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
    marks.append(("ring", time.perf_counter()))
    drv.drive(lambda k: pool[k % 3], calls=WARM_CALLS)
    marks.append(("warm", time.perf_counter()))
    setup_s = time.perf_counter() - T_START
    t_prev = T_START
    phases = []
    for name, t in marks:
        phases.append(f"{name} {t - t_prev:.3f}")
        t_prev = t
    print(f"set-up {setup_s:.3f} s: {', '.join(phases)}", file=sys.stderr)

    t_w0 = time.perf_counter()
    end = t_w0 + seconds
    recs = drv.drive(lambda k: kept.get(k, pool[k % 3]), until=end)
    done = [r for r in recs if r[3] <= end]
    k_last = recs[-1][0]  # the window's last call: no later call wrote its buffer
    nf = entry.frames
    lat_ms = [(r[3] - r[1]) * 1e3 for r in recs]
    metrics = {}
    breakdown = trace_dev = None
    if trace:
        from portbench import trace as ptrace

        spare = [b for i, b in enumerate(pool) if i != k_last % 3]

        def stretch():
            rs = drv.drive(lambda k: spare[k % 2], calls=int(traffic["profiled_calls"]))
            return len(rs), len(rs) * nf

        tr = ptrace.profile(stretch)
        ctx = SimpleNamespace(
            cfg=ecfg, trace=tr, dispatch_s=[r[2] - r[1] for r in recs],
            library=ptrace.library_kernels(os.path.join(
                os.path.dirname(sys.modules["pythoncrt_tpu_torch"].__file__), "csrc")))
        for m in bench["per_layer"]:
            if "workloads" in m and workload not in m["workloads"]:
                continue
            v = load_module("metrics", m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        breakdown = tr.breakdown()
        trace_dev = {"busy_s": tr.busy_s(), "window_s": tr.wall_s}
        if len(done) > 1:
            period = (done[-1][3] - done[0][3]) / (len(done) - 1)
            print(f"device busy per call {tr.busy_s() / tr.calls} s and device span per call "
                  f"{tr.span_s() / tr.calls} s (profiled); completion period {period} s "
                  f"(unprofiled window)", file=sys.stderr)
    else:
        for m in bench["end_to_end"]:
            if "workloads" in m and workload not in m["workloads"]:
                continue
            v = {"fps": len(done) * nf / seconds if done else None,
                 "batch_ms_p95": float(np.percentile(lat_ms, 95)) if lat_ms else None,
                 "setup_s": setup_s}.get(m["name"])
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    if dev.type == "cuda":
        torch.cuda.synchronize()
        peak = int(torch.cuda.max_memory_allocated(dev))
        kind = torch.cuda.get_device_name(dev)
    else:
        peak, kind = 0, "cpu"
    found = banned_modules(list(sys.modules))
    if found:
        print(f"modules of JAX or the JAX package are loaded: {', '.join(found)}",
              file=sys.stderr)
        raise SystemExit(3)
    per_s = np.bincount([int(r[3] - t_w0) for r in done], minlength=int(np.ceil(seconds)))
    disp = [(r[2] - r[1]) * 1e3 for r in recs]
    print(f"window: {len(recs)} calls of {nf} frames enqueued, {len(done)} completed in "
          f"{seconds} s, per second {per_s.tolist()}; latency ms median "
          f"{float(np.median(lat_ms))}; enqueue ms median {float(np.median(disp))}, p95 "
          f"{float(np.percentile(disp, 95))}; set-up {setup_s} s", file=sys.stderr)

    outs = {k: kept[k] for k in (k_first, k_mid) if any(r[0] == k for r in recs)}
    outs[k_last] = kept.get(k_last, pool[k_last % 3])
    entry.release()
    del drv, pool
    limits = load_json(HERE, "limits", f"{workload}.json")
    from portbench.reference.compare import compare

    t_ref = time.perf_counter()
    lead = lead_frames(ecfg["params"]["persistence"])
    with torch.no_grad():
        nums = compare({k: entry.streams(ring, k, lead, seed, out) for k, out in outs.items()},
                       ecfg, dev, overlay)
    ref_s = time.perf_counter() - t_ref
    checks = {"max_lsb": {"value": nums["max_lsb"], "limit": limits["max_lsb"]},
              "off_share": {"value": nums["off_share"], "limit": limits["off_share"]}}
    correct = (nums["max_lsb"] <= limits["max_lsb"] and nums["off_share"] <= limits["off_share"]
               and len(outs) == 3)
    failed = sum(nf for v in nums["per_call"].values() if v > limits["max_lsb"])
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type, "kind": kind,
                   "count": int(cell["chips"]), "memory_peak_bytes": peak}
    if trace_dev:
        device_info.update(trace_dev)
    res = {"correct": bool(correct), "attempted": len(recs) * nf, "failed": failed,
           "metrics": metrics, "device": device_info}
    if breakdown:
        res["breakdown"] = breakdown
    res["card"] = card() if dev.type == "cuda" else "cpu"
    res["reference_s"] = ref_s
    res["compared_calls"] = sorted(outs)
    res["checks"] = checks
    for name, c in checks.items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="One run of one cell of the port's benchmark.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    cache_dirs()
    import torch

    # one intra-op thread, unlike the port's CLI: with torch's default of one
    # per core, the host's enqueue of a call spread 2-3x wider on the card's
    # shared 8-core host (PERF.md, the spread search)
    torch.set_num_threads(1)
    chips = int(cell_spec(a.workload)[1]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 2
    res = run(a.workload, a.seed, a.seconds, bool(a.trace))
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
