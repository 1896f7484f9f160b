"""Named-stage performance accounting for the port.

The accumulators and the report are the JAX package's own
(pythoncrt_tpu.perf, which imports no JAX at module level), so the host
I/O stages timed by pythoncrt_tpu.io.video (``io.*``) and the port's
effect stages (``fx.*``) land in one report of the reference's format.
Only ``device_trace`` differs: it annotates torch.profiler traces.
"""

from __future__ import annotations

import contextlib

from pythoncrt_tpu.perf import perf_report, perf_reset, timed  # noqa: F401


@contextlib.contextmanager
def device_trace(name: str):
    """Annotate a region for torch.profiler traces (a cheap no-op when
    no profiler is recording)."""
    import torch

    with torch.profiler.record_function(name):
        yield
