"""Named-stage performance accounting for the port.

The report contract of the reference's perf subsystem
(crt_filter.py:58-101): thread-safe accumulators keyed by stage name and
a plain-text report sorted by total time with per-call averages. Stage
namespaces: ``io.*`` host I/O (io/video.py and the pipeline's decode and
encode threads), ``fx.*`` the effect step.

``span`` marks a layer of the port for torch.profiler: the engine's calls
(``crt.call``), its per-frame inputs (``crt.aux``, ``crt.upload``), each
batch's step of a call's step loop (``crt.step``), the multi-clip engine's
clip states placed before the steps and gathered after them
(``crt.carry``), its torch-op stages (``crt.torch_ops``), each kernel wrapper (``crt.draws``,
``crt.fused``, ``crt.warp``, ``crt.bloom``, ``crt.text``, ``crt.glitch``, ``crt.persist``),
each launch (``crt.launch``) and the GUI preview's steps (``preview.*``).
The spans land in the profiler's Kineto trace, on one clock with the
device operations, and record nothing while no profiler is recording.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict

_lock = threading.Lock()
_totals: dict[str, float] = defaultdict(float)
_counts: dict[str, int] = defaultdict(int)


def _add(name: str, dt: float) -> None:
    with _lock:
        _totals[name] += float(dt)
        _counts[name] += 1


@contextlib.contextmanager
def timed(name: str):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _add(name, time.perf_counter() - t0)


def perf_reset() -> None:
    with _lock:
        _totals.clear()
        _counts.clear()


def perf_report(total_frames: int, total_seconds: float, print_fn=print) -> str:
    """Plain-text report in the reference's format (crt_filter.py:69-76)."""
    with _lock:
        snap = {k: (_totals[k], _counts[k]) for k in _totals}
    lines = [f"perf total {total_seconds:.3f}s", f"perf frames {total_frames}"]
    if total_seconds > 0 and total_frames:
        lines.append(f"perf fps {total_frames / total_seconds:.1f}")
    for k, (tot, cnt) in sorted(snap.items(), key=lambda kv: kv[1][0], reverse=True):
        avg = (tot / cnt * 1000.0) if cnt else 0.0
        lines.append(f"{k} total={tot:.3f}s count={cnt} avg_ms={avg:.2f}")
    text = "\n".join(lines)
    if print_fn is not None:
        print_fn(text)
    return text


_span_type = None


def span(name: str):
    """A context manager that records the range ``name`` in a recording
    torch.profiler trace (as a ``cpu_op`` event) and costs about half a
    microsecond while none records: torch's ``_RecordFunctionFast``,
    resolved at first use."""
    global _span_type
    if _span_type is None:
        from torch._C._profiler import _RecordFunctionFast

        _span_type = _RecordFunctionFast
    return _span_type(name)
