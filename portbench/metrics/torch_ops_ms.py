"""Torch ops: device ms per frame of the kernels that are not the port's
own (no __global__ of pythoncrt_tpu_torch/csrc in their name), such as the
pre-bloom stages and the text composite that run as torch ops."""

import re


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.frames:
        return None
    own = re.compile(r"\b(" + "|".join(map(re.escape, sorted(ctx.library))) + r")\b")
    other = [d for d in tr.device if d[1] == "kernel" and not own.search(d[0])]
    if not other:
        return None
    return sum(d[3] for d in other) / 1e3 / tr.frames
