"""Kernel wrappers: host µs per launch spent in the wrappers around the
launch (plans, argument structs, operand checks): the wrapper spans'
time (crt.draws, crt.fused, crt.warp, crt.bloom, crt.glitch, crt.persist)
less the crt.launch spans inside them, over the count of crt.launch."""

from portbench import spans


def read(ctx):
    launches = spans.durations_us(ctx.trace, spans.LAUNCH)
    wrappers = spans.durations_us(ctx.trace, *spans.WRAPPERS)
    if not launches or not wrappers:
        return None
    return (sum(wrappers) - sum(launches)) / len(launches)
