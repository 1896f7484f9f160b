"""Stage 13, the text composited after the effects: the CUDA kernel and
its plain twin.

The overlay's alpha-over composite (ops/color.composite_text,
crt_filter.py:595-597) in place on the step's (B, 3, H, W) f32 batch, over
the box where the overlay's alpha is not 0 (``find_box``: the rows and
columns it covers, and the alpha and colour cropped to them). The JAX
engine composites by XLA ops over the whole frame; no TPU kernel.

Two grids (csrc/text.cu says why each is exact):

- the box grid (``whole`` False): the box alone. Outside it the composite
  is clip(v), the identity on a batch in [0, 1], as the fused kernel's f32
  emit and the staged step's epilogue are. A clear overlay launches
  nothing.
- the whole-frame grid (``whole`` True): the composite inside the box and
  the clip outside it, for a batch that may leave [0, 1] (the warp's f32
  emit).

Its launch plan (``text_plan``: 16-byte or scalar accesses, threads along
a row; one block per row, plane and frame) is plain Python. CPU tensors
run the plain twin ``composite_box_ref``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from ..ops import color as ocolor
from . import _build, on_card

launches = 0  # CUDA launches made by composite_after
last_plan = None  # the TextPlan of the latest launch

# Threads along a row at most: the box's 1280 columns take two turns of
# 160, a 4K row four of 240.
MAX_TX = 256


class TextBox(NamedTuple):
    """The overlay over its box: ``box`` (y0, y1, x0, x1), the rows and
    columns where its alpha is not 0, () when it is clear; ``alpha`` (bh,
    bw) and ``rgb`` (3, bh, bw) cropped to it, None when clear."""
    box: tuple = ()
    alpha: Optional[torch.Tensor] = None
    rgb: Optional[torch.Tensor] = None


def find_box(alpha: torch.Tensor, rgb: torch.Tensor) -> TextBox:
    """The box of an (H, W) alpha and its (3, H, W) colour, and both
    cropped to it (contiguous, on their device). One host wait."""
    rows = torch.nonzero(alpha.ne(0).any(1)).flatten().tolist()
    if not rows:
        return TextBox()
    cols = torch.nonzero(alpha.ne(0).any(0)).flatten().tolist()
    y0, y1, x0, x1 = rows[0], rows[-1] + 1, cols[0], cols[-1] + 1
    return TextBox((y0, y1, x0, x1), alpha[y0:y1, x0:x1].contiguous(),
                   rgb[:, y0:y1, x0:x1].contiguous())


def composite_box_ref(img: torch.Tensor, tb: TextBox, whole: bool) -> torch.Tensor:
    """The kernel's plain twin, in place on (B, 3, H, W) f32: composite_text
    over the box, then with ``whole`` the clip of the whole batch (the
    identity on the box, whose composite is in [0, 1]). Returns ``img``."""
    if tb.box:
        y0, y1, x0, x1 = tb.box
        img[..., y0:y1, x0:x1] = ocolor.composite_text(img[..., y0:y1, x0:x1], tb.alpha, tb.rgb)
    if whole:
        img.clamp_(0.0, 1.0)
    return img


class TextPlan(NamedTuple):
    """How csrc/text.cu walks the batch: ``vec`` 1 for 16-byte accesses
    of the batch's rows, ``cvec`` 1 for 16-byte loads of the crops'; ``tx``
    threads along a row, each taking four columns (or one) at a time."""
    vec: int
    cvec: int
    tx: int


@functools.lru_cache(maxsize=256)
def text_plan(b: int, h: int, w: int, box: tuple, whole: bool, aligned: bool,
              crops_aligned: bool) -> Optional[TextPlan]:
    """The launch plan for B frames of H x W with the box (y0, y1, x0, x1)
    (or ()), ``aligned``: the batch starts on 16 bytes; ``crops_aligned``:
    the crops do. None where nothing is launched: no frames, or the box
    grid with no box."""
    if b == 0 or not (box or whole):
        return None
    y0, y1, x0, x1 = box or (0, 0, 0, 0)
    vec = int(aligned and w % 4 == 0)
    cvec = int(vec and crops_aligned and x0 % 4 == 0 and (x1 - x0) % 4 == 0)
    span = w if whole else x1 - x0
    units = -(-span // 4) if vec else span
    per_turn = -(-units // -(-units // MAX_TX))  # the turns evenly filled
    tx = 32 * -(-per_turn // 32)  # whole warps
    return TextPlan(vec, cvec, tx)


class _TextArgs(ctypes.Structure):
    """Mirror of TextArgs in csrc/text.cu (checked by size at launch)."""
    _fields_ = [
        ("img", ctypes.c_void_p), ("alpha", ctypes.c_void_p), ("rgb", ctypes.c_void_p),
        ("b", ctypes.c_int32), ("h", ctypes.c_int32), ("w", ctypes.c_int32),
        ("y0", ctypes.c_int32), ("y1", ctypes.c_int32),
        ("x0", ctypes.c_int32), ("x1", ctypes.c_int32),
        ("whole", ctypes.c_int32), ("tx", ctypes.c_int32),
        ("vec", ctypes.c_int32), ("cvec", ctypes.c_int32),
    ]


def _launch(img: torch.Tensor, tb: TextBox, whole: bool) -> None:
    global launches, last_plan
    b, c, h, w = img.shape
    if c != 3 or img.dtype != torch.float32 or not img.is_contiguous():
        raise ValueError("text after: frames must be a contiguous f32 (B, 3, H, W) tensor")
    if b > 65535:
        raise ValueError(f"text after: {b} frames, more than a launch's 65535")
    ptrs = (0, 0)
    if tb.box:
        y0, y1, x0, x1 = tb.box
        if not (0 <= y0 < y1 <= h and 0 <= x0 < x1 <= w):
            raise ValueError(f"text after: box {tb.box} outside the {h}x{w} frame")
        for t, shape in ((tb.alpha, (y1 - y0, x1 - x0)), (tb.rgb, (3, y1 - y0, x1 - x0))):
            if t.device != img.device or t.dtype != torch.float32 \
                    or tuple(t.shape) != shape or not t.is_contiguous():
                raise ValueError(f"text after: crops must be contiguous f32 {shape} tensors "
                                 f"on {img.device}")
        ptrs = (tb.alpha.data_ptr(), tb.rgb.data_ptr())
    plan = text_plan(b, h, w, tuple(tb.box), bool(whole), img.data_ptr() % 16 == 0,
                     ptrs[0] % 16 == 0 and ptrs[1] % 16 == 0)
    if plan is None:
        return
    a = _TextArgs(img.data_ptr(), *ptrs, b, h, w, *(tb.box or (0, 0, 0, 0)), int(whole),
                  plan.tx, plan.vec, plan.cvec)
    _build.launch("crt_text_launch", a, img.device)
    launches += 1
    last_plan = plan


def composite_after(img: torch.Tensor, tb: TextBox, whole: bool) -> torch.Tensor:
    """Stage 13 in place on (B, 3, H, W) f32 frames: the overlay's box
    ``tb`` composited, and with ``whole`` the rest of the frame clipped.
    Returns ``img``."""
    if not on_card(img, "composite_after"):
        return composite_box_ref(img, tb, whole)
    _launch(img, tb, whole)
    return img
