"""Kernel launch: host µs of one ``kernels/_build.launch`` (the struct
size check, the device guard, the stream lookup, the ctypes call), the
mean of the crt.launch spans. On standard error the count of spans
beside the count of the port's own kernels in the device trace, which
should be equal."""

import sys

from portbench import spans


def read(ctx):
    durs = spans.durations_us(ctx.trace, spans.LAUNCH)
    if not durs:
        return None
    print(f"launch_us: {len(durs)} crt.launch spans, "
          f"{len(spans.own_kernels(ctx.trace, ctx.library))} kernels of the port's library",
          file=sys.stderr)
    return sum(durs) / len(durs)
