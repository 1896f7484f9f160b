"""Per-frame inputs: ms per engine call of ``make_aux`` (the ``crt.aux``
spans: host f64 math, host-rng fields) and ``upload`` (``crt.upload``:
the scanline rows, pinning and the non-blocking copies), the median over
the ``crt.call`` spans of the profiled stretch of the inputs' time inside
each. A median, as call_ms: the stretch's first call starts on an empty
queue and its pinning takes several times a steady call's."""

import statistics

from portbench import spans


def read(ctx):
    inputs = spans.named(ctx.trace, *spans.INPUTS)
    per_call = [sum(d for _, t, d in inputs if t >= ts and t + d <= ts + dur)
                for _, ts, dur in spans.named(ctx.trace, spans.CALL)]
    if not inputs or not per_call:
        return None
    return statistics.median(per_call) / 1e3
