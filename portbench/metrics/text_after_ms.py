"""Text after the effects (stage 13, engine._effects, ops/color.composite_text):
device ms per frame of the kernels that carry no __global__ of
pythoncrt_tpu_torch/csrc in their name. Stage 13 runs as torch ops: the
frames times one minus the overlay's alpha, the overlay's colour times its
alpha, their sum and the clamp. In c5.batch every other kernel of the step
is the port's own (the draws, the fused kernel, the glitch shear, the
persistence kernel's multi-clip launch): on the card each kernel this reads
was launched inside stage 13's ``crt.torch_ops`` span, so it reads stage 13
alone."""

import re


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.frames or not ctx.library:
        return None
    own = re.compile(r"\b(" + "|".join(map(re.escape, sorted(ctx.library))) + r")\b")
    other = [d for d in tr.device if d[1] == "kernel" and not own.search(d[0])]
    if not other:
        return None
    return sum(d[3] for d in other) / 1e3 / tr.frames
