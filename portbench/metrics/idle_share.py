"""Device: the share of the profiled stretch's device span, from its first
device operation's start to its last one's end, in which no operation ran,
in %. Busy and span come from the same trace, so the profiler's cost on the
host and on each operation's length counts on both sides alike."""


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.device:
        return None
    busy, span = tr.busy_s(), tr.span_s()
    if span <= 0.0:
        return None
    if busy > span * (1 + 1e-9):
        raise RuntimeError(f"idle_share: device busy {busy} s over its span {span} s")
    return (1.0 - busy / span) * 100.0
