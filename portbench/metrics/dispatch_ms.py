"""Engine step: host ms of one call's enqueue (the entry's call, returned
before the device ran it), median over the unprofiled window's calls."""

import statistics
import sys

import numpy as np


def read(ctx):
    if not ctx.dispatch_s:
        return None
    ms = [s * 1e3 for s in ctx.dispatch_s]
    print(f"dispatch_ms: median {statistics.median(ms)}, p95 {float(np.percentile(ms, 95))}, "
          f"over {len(ms)} calls", file=sys.stderr)
    return statistics.median(ms)
