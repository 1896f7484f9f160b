"""The port's ``crt.*`` spans in a profiled stretch (portbench/trace.py).

The port enters a span at each layer boundary (``pythoncrt_tpu_torch.perf
.span``): ``crt.call`` around a public engine call, ``crt.aux`` and
``crt.upload`` for its per-frame inputs, ``crt.step`` around each batch's
step of the call, ``crt.torch_ops`` for stages run as torch ops, one span
per kernel wrapper call (``WRAPPERS``) and ``crt.launch`` in
``kernels/_build.launch``. They reach the Chrome trace as ``cpu_op``
events, on the device operations' clock. A tree that has no such spans
gives empty lists here, and the readers that use them give None.
"""

from __future__ import annotations

import re

CALL, LAUNCH = "crt.call", "crt.launch"
INPUTS = ("crt.aux", "crt.upload")
WRAPPERS = ("crt.draws", "crt.fused", "crt.warp", "crt.bloom", "crt.glitch", "crt.persist")
HARNESS = "harness"  # time no crt.* span covers


def named(trace, *names) -> list:
    """(name, ts_us, dur_us) of the host spans of these names."""
    return [h for h in trace.host if h[0] in names] if trace is not None else []


def durations_us(trace, *names) -> list:
    return [h[2] for h in named(trace, *names)]


def own_kernels(trace, library) -> list:
    """The device kernels named after a __global__ of the port's csrc/."""
    if not library:
        return []
    own = re.compile(r"\b(" + "|".join(map(re.escape, sorted(library))) + r")\b")
    return [d for d in trace.device if d[1] == "kernel" and own.search(d[0])]


def _union_us(pieces) -> float:
    total, end = 0.0, None
    for a, b in sorted(pieces):
        if end is None or a >= end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def call_coverage(trace) -> list:
    """Per crt.call span: the share of its duration that the crt.* spans
    inside it cover."""
    crt = [h for h in trace.host if h[0].startswith("crt.")] if trace is not None else []
    shares = []
    for _, ts, dur in named(trace, CALL):
        if dur <= 0:
            continue
        inner = [(t, t + d) for n, t, d in crt if n != CALL and t >= ts and t + d <= ts + dur]
        shares.append(_union_us(inner) / dur)
    return shares


def owners(trace, t0: float, t1: float) -> dict:
    """µs of [t0, t1] by the innermost (shortest) crt.* span that covers
    each part of it; HARNESS where none does."""
    evs = [(t, t + d, d, n) for n, t, d in trace.host
           if n.startswith("crt.") and t < t1 and t + d > t0]
    cuts = sorted({t0, t1, *(max(a, t0) for a, *_ in evs), *(min(b, t1) for _, b, *_ in evs)})
    out: dict = {}
    for a, b in zip(cuts, cuts[1:]):
        cover = [(d, n) for s, e, d, n in evs if s <= a and e >= b]
        name = min(cover)[1] if cover else HARNESS
        out[name] = out.get(name, 0.0) + (b - a)
    return out


def gaps(trace, top: int = 10) -> list:
    """The ``top`` longest idle gaps between device operations (as
    Trace.breakdown finds them), each (µs, owners of it)."""
    found, end = [], None
    for _, _, ts, dur in trace.device:
        if end is not None and ts > end:
            found.append((end, ts))
        end = ts + dur if end is None else max(end, ts + dur)
    found = sorted(found, key=lambda g: g[0] - g[1])[:top]
    return [(g1 - g0, owners(trace, g0, g1)) for g0, g1 in found]
