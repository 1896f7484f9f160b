"""torch.profiler over a stretch of calls, read back from its Chrome trace.

``profile`` runs a function under the profiler (CPU and CUDA activity) and
returns the device operations it recorded (kernels, copies and fills:
name, category, start and length in microseconds) and the host spans
(operators, runtime calls, annotations). ``busy_s`` is the union of the
device operations' intervals, ``span_s`` the stretch of device time they lie in;
``breakdown`` lists the device operations
that took most time and the longest idle gaps between them, each named by
the host span that covered most of it.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
import time
from collections import defaultdict
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
OUTER = "portbench.profiled"  # the annotation around the whole stretch: names no gap


@dataclass
class Trace:
    device: list = field(default_factory=list)  # (name, cat, ts_us, dur_us), by start
    host: list = field(default_factory=list)  # (name, ts_us, dur_us)
    wall_s: float = 0.0
    calls: int = 0
    frames: int = 0

    def busy_s(self) -> float:
        busy, end = 0.0, None
        for _, _, ts, dur in self.device:
            if end is None or ts >= end:
                busy += dur
                end = ts + dur
            elif ts + dur > end:
                busy += ts + dur - end
                end = ts + dur
        return busy / 1e6

    def span_s(self) -> float:
        """From the first device operation's start to the last one's end."""
        if not self.device:
            return 0.0
        return (max(ts + dur for _, _, ts, dur in self.device) - self.device[0][2]) / 1e6

    def kernels(self, pattern: str) -> list:
        """The kernels whose name holds ``pattern`` as a whole word."""
        rx = re.compile(rf"\b{re.escape(pattern)}\b")
        return [d for d in self.device if d[1] == "kernel" and rx.search(d[0])]

    def breakdown(self, top: int = 10) -> dict:
        by_name: dict = defaultdict(float)
        for name, _, _, dur in self.device:
            by_name[name[:200]] += dur / 1e6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps, end = [], None
        for _, _, ts, dur in self.device:
            if end is not None and ts > end:
                gaps.append((end, ts))
            end = ts + dur if end is None else max(end, ts + dur)
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
        named = []
        for g0, g1 in gaps:
            best, best_key = "host code outside any recorded span", None
            for name, ts, dur in self.host:
                over = min(g1, ts + dur) - max(g0, ts)
                if over > 0 and name != OUTER:
                    key = (over, -dur)
                    if best_key is None or key > best_key:
                        best, best_key = name[:200], key
            named.append([best, (g1 - g0) / 1e6])
        return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": named}


def profile(fn, attempts: int = 3) -> Trace:
    """``fn`` (which runs a stretch of calls and waits for them; it returns
    (calls, frames)) under torch.profiler. A window in which no device
    operation arrived is taken again, up to ``attempts`` times."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        for _ in range(attempts):
            with torch.profiler.profile(activities=acts) as prof:
                with torch.profiler.record_function(OUTER):
                    t0 = time.perf_counter()
                    calls, frames = fn()
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
            tr = Trace(wall_s=wall, calls=calls, frames=frames)
            for e in events:
                if e.get("ph") != "X":
                    continue
                cat = e.get("cat", "")
                if cat in DEVICE_CATS:
                    tr.device.append((e["name"], cat, float(e["ts"]), float(e.get("dur", 0.0))))
                elif cat in HOST_CATS:
                    tr.host.append((e["name"], float(e["ts"]), float(e.get("dur", 0.0))))
            tr.device.sort(key=lambda d: d[2])
            if tr.device:
                return tr
    raise RuntimeError(f"torch.profiler recorded no device operation in {attempts} windows")


def library_kernels(csrc_dir: str) -> set:
    """The names of the __global__ functions in the port's CUDA sources."""
    names = set()
    for fn in sorted(os.listdir(csrc_dir)):
        if not fn.endswith(".cu"):
            continue
        with open(os.path.join(csrc_dir, fn)) as f:
            src = f.read()
        for m in re.finditer(r"\b__global__\b", src):
            pos = m.end()
            while True:  # the first identifier that opens a parameter list, past
                ident = re.compile(r"([A-Za-z_]\w*)\s*\(").search(src, pos)  # __attr__(...)
                if ident is None:
                    break
                if not ident.group(1).startswith("__"):
                    names.add(ident.group(1))
                    break
                depth, pos = 1, ident.end()
                while depth and pos < len(src):
                    depth += {"(": 1, ")": -1}.get(src[pos], 0)
                    pos += 1
    return names
