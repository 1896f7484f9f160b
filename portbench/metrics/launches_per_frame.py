"""Kernel wrappers: device operations (kernels, copies, fills) in the
profiled stretch over its frames. A count: it repeats exactly."""


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.device or not tr.frames:
        return None
    return len(tr.device) / tr.frames
