"""Engine step, from inside: ms of one public engine call's enqueue, the
median of the ``crt.call`` spans in the profiled stretch (the inside twin
of dispatch_ms, which the harness times around the entry's call).

On standard error: the share of each call that the crt.* spans inside it
cover, and the longest idle gaps of the device and the host time before
its first operation and after its last one in the stretch, each put down
to the innermost crt.* span covering it (or to the harness)."""

import statistics
import sys

from portbench import spans
from portbench.trace import OUTER


def _fmt(own: dict) -> str:
    return ", ".join(f"{n} {us:.1f}" for n, us in sorted(own.items(), key=lambda kv: -kv[1]))


def read(ctx):
    tr = ctx.trace
    durs = spans.durations_us(tr, spans.CALL)
    if not durs:
        return None
    cover = spans.call_coverage(tr)
    print(f"call_ms: {len(durs)} crt.call spans, median {statistics.median(durs) / 1e3} ms; "
          f"covered by crt.* spans inside them: min {min(cover)}, median "
          f"{statistics.median(cover)}", file=sys.stderr)
    for us, own in spans.gaps(tr):
        print(f"call_ms: idle gap {us:.1f} us: {_fmt(own)}", file=sys.stderr)
    outer = next((h for h in tr.host if h[0] == OUTER), None)
    if outer is not None and tr.device:
        first = tr.device[0][2]
        last = max(ts + dur for _, _, ts, dur in tr.device)
        for where, t0, t1 in (("before the first device operation", outer[1], first),
                              ("after the last device operation", last, outer[1] + outer[2])):
            if t1 > t0:
                print(f"call_ms: {t1 - t0:.1f} us of the stretch {where}: "
                      f"{_fmt(spans.owners(tr, t0, t1))}", file=sys.stderr)
    return statistics.median(durs) / 1e3
