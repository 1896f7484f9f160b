"""Text after the effects (stage 13, engine._effects, kernels/text.py,
csrc/text.cu): device ms per frame of the kernels named after
``text_after_kernel``. On standard error its launches per call: one a
call of c5.batch's one step, the box grid. A tree without the kernel
reads nothing."""

import sys


def read(ctx):
    tr = ctx.trace
    ks = tr.kernels("text_after_kernel") if tr is not None and tr.frames else []
    if not ks:
        return None
    print(f"text_kernel_ms: {len(ks)} launches of text_after_kernel over {tr.calls} calls "
          f"({len(ks) / max(tr.calls, 1)} a call)", file=sys.stderr)
    return sum(k[3] for k in ks) / 1e3 / tr.frames
