"""Where the time of one GUI preview tick goes, on one GPU.

    python3 scripts/port_preview_profile.py [--out preview_profile.json] [--ticks 20]

For each GUI preview configuration of ``chip_smoke.py`` (``PREVIEW_CONFIGS``:
the CLI defaults, c3, c4, c3-angled, defaults-angled, c4-text; its seeded
synthetic text overlay), ``--ticks`` stateful ticks of
``gui_qt.render_preview_frame`` from 1920x1080 frames (fitted to 960x540)
on a warm preview engine (cache hits):

- the whole ticks on the host clock, with no profiler (median, min, max);
- the same ticks under torch.profiler, read from its trace by
  portbench/trace.py: the function's own ``preview.<step>`` ranges (fit,
  grain, engine, d2h, blend, to_uint8; the median ms of each), their sum
  beside the profiled tick's median (the difference is what no range
  covers), and the device's kernel and copy time per tick (the largest
  eight by name). The engine range enqueues the step and the d2h range
  waits for the card and copies the frame back, so the card's share of
  those two ranges and of the whole tick is given.

Also the cost of one range (enter and exit) with no profiler running, in
microseconds. Prints one JSON object per configuration and writes them to
--out. Imports nothing of JAX or of the JAX package; exits 2 without a
CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import FPS, H, PREVIEW_CONFIGS, W, synth_overlay  # noqa: E402
from portbench import trace as ptrace  # noqa: E402

STEPS = ("fit", "grain", "engine", "d2h", "blend", "to_uint8")


def smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    return out.splitlines()[0] if out else "nvidia-smi: no output"


def span_cost_us(n: int = 20000) -> float:
    """µs of one preview range (``perf.span``), entered and left, with no profiler."""
    from pythoncrt_tpu_torch import perf

    t0 = time.perf_counter()
    for _ in range(n):
        with perf.span("preview.cost"):
            pass
    return (time.perf_counter() - t0) / n * 1e6


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="preview_profile.json")
    ap.add_argument("--ticks", type=int, default=20)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("port_preview_profile: no CUDA device available", file=sys.stderr)
        return 2
    from pythoncrt_tpu_torch import EffectParams, TextParams, gui_qt

    gui_qt.overlay_for = lambda w, h, t: synth_overlay(h, w, 4) if t.enabled else None
    frames = np.random.default_rng(4).integers(0, 256, (args.ticks, H, W, 3), dtype=np.uint8)
    card, cost, results = smi(), span_cost_us(), []

    def run(p) -> list:
        """ms of each of --ticks stateful ticks of p, on the host clock."""
        ms, st = [], None
        for k in range(args.ticks):
            t0 = time.perf_counter()
            _, st = gui_qt.render_preview_frame(frames[k], p, k / FPS, st, True, device="cuda")
            ms.append((time.perf_counter() - t0) * 1e3)
        return ms

    for name, (kw, text) in PREVIEW_CONFIGS.items():
        p = EffectParams(**kw, text=TextParams(**(text or {})))
        pw, ph = gui_qt._preview_size(W, H)
        run(p)  # warm: the engine built, the kernels loaded
        ticks = run(p)
        prof_ticks = []

        def profiled(p=p):
            prof_ticks[:] = run(p)
            return args.ticks, args.ticks
        tr = ptrace.profile(profiled)
        spans = {s: [] for s in STEPS}
        for hname, _, dur in tr.host:  # the host's ranges
            if hname.startswith("preview.") and hname[8:] in spans:
                spans[hname[8:]].append(dur / 1e3)
        dev = {}  # device ms per tick of the kernels and copies, by name
        for dname, _, _, dur in tr.device:
            dev[dname] = dev.get(dname, 0.0) + dur / 1e3 / args.ticks
        dev_tick = sum(dev.values())
        top = dict(sorted(dev.items(), key=lambda kv: -kv[1])[:8])
        med = {k: statistics.median(v) if v else 0.0 for k, v in spans.items()}
        eng = gui_qt._get_preview_engine(p, pw, ph, "cuda")
        res = dict(config=name, preview=(pw, ph), source=(W, H), ticks=args.ticks, card=card,
                   persistence=p.persistence, staged=eng._staged, bloom_route=eng.bloom_route,
                   tick_ms_median=statistics.median(ticks), tick_ms_min=min(ticks),
                   tick_ms_max=max(ticks), step_ms_median=med,
                   steps_sum_ms=sum(med.values()),
                   profiled_tick_ms_median=statistics.median(prof_ticks),
                   device_ms_per_tick=dev_tick, device_ms_per_tick_top=top,
                   device_share_of_engine_and_d2h=dev_tick / (med["engine"] + med["d2h"]),
                   device_share_of_tick=dev_tick / statistics.median(ticks),
                   range_cost_us=cost)
        print(json.dumps(res), flush=True)
        results.append(res)
        gui_qt._PREVIEW_ENGINES.clear()
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
