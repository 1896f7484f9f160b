"""Stage 14, the glitch row shear: the CUDA kernel and its plain twin.

Port of pythoncrt_tpu/kernels/glitch.py (shear_planar and
shear_planar_inplace, with the wrappers shear_band_batched[_planar] and
the host maps of _band_maps): each row r of the bottom band is shifted,
with modulo wrap, by a per-(row, segment) pixel offset,

    out[b, c, y0 + r, x] = in[b, c, y0 + r, (x + off[b, r, seg[x]]) mod W]

with off the rint of the f32 per-segment offsets (base + segment is
constant within a segment, so per-segment rint equals the reference's
per-pixel rint, crt_filter.py:853-855) and seg the static segment index
of each column (x // seg_len for the export glitch; all 0 for the
preview glitch's one offset per row).

On the card this is a pure copy (csrc/glitch.cu), bitwise equal to the
oracle's apply_glitch_gather; the TPU kernel's one-hot bf16 MXU matmuls
and their window/dual/clamp variants have no counterpart. One kernel
serves both entries: ``shear_planar_inplace`` on full frames (the
engine's) and ``shear_planar`` out of place on a band. Its launch plan
(``glitch_plan``: 16-byte or scalar copies, threads along a row; one
block per band row, plane and frame) is plain Python, replayed at index
level by the CPU tests. CPU
tensors run the plain twin ``shear_planar_ref``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import _build, on_card

launches = 0  # CUDA launches made by shear_planar and shear_planar_inplace
last_plan = None  # the GlitchPlan of the latest launch


def round_offsets(seg_offsets_px: torch.Tensor) -> torch.Tensor:
    """(B, rows, NSEG) f32 offsets -> int32, rounded half to even (np.rint)."""
    return torch.round(seg_offsets_px).to(torch.int32)


def shear_planar_ref(band: torch.Tensor, off: torch.Tensor,
                     seg_index: torch.Tensor) -> torch.Tensor:
    """The kernel's plain twin: (B, 3, R, W) band, (B, R, NSEG) int32
    offsets, (W,) int32 segment index -> the sheared band (a gather)."""
    b, _, r, w = band.shape
    x = torch.arange(w, device=band.device)
    src = torch.remainder(x + off.long()[:, :, seg_index.long()], w)  # (B, R, W)
    return torch.gather(band, 3, src[:, None].expand(b, 3, r, w))


# Threads along a row at most: a wider row takes turns, each thread's
# 16-byte copies all in flight (two at 1080p, four at 4K), eight blocks
# resident per SM. Of 64 to 1024 threads, 256 measured fastest at the
# preview's, c4's and c5's widths (scripts/port_bloom_ab.py --sweep glitch).
MAX_TX = 256
SMEM_DEFAULT = 48 * 1024  # dynamic shared memory a launch may take unasked


class GlitchPlan(NamedTuple):
    """How csrc/glitch.cu walks a band: ``vec`` 1 for 16-byte copies, 0
    for scalar ones; ``tx`` threads along a row, each taking
    units (four columns, or one) t, t + tx, ...; ``grid`` (band rows,
    planes, frames), one block each; ``smem`` bytes: the row (padded to
    four columns) and its reduced offsets."""
    vec: int
    tx: int
    grid: tuple
    smem: int


@functools.lru_cache(maxsize=256)
def glitch_plan(b: int, rows: int, w: int, nseg: int, aligned: bool) -> GlitchPlan:
    """The launch plan for B frames of a ``rows`` x ``w`` band with
    ``nseg`` offsets per row; ``aligned``: the buffers and seg start on
    16 bytes. A block owns one (row, plane) pair."""
    vec = int(aligned and w % 4 == 0)
    units = w // 4 if vec else w
    per_turn = -(-units // -(-units // MAX_TX))  # the turns evenly filled
    tx = 32 * -(-per_turn // 32)  # whole warps
    return GlitchPlan(vec, tx, (rows, 3, b), 4 * (-(-w // 4) * 4 + nseg))


class _GlitchArgs(ctypes.Structure):
    """Mirror of GlitchArgs in csrc/glitch.cu (checked by size at launch)."""
    _fields_ = [
        ("src", ctypes.c_void_p), ("dst", ctypes.c_void_p),
        ("off", ctypes.c_void_p), ("seg", ctypes.c_void_p),
        ("b", ctypes.c_int32), ("hs", ctypes.c_int32), ("w", ctypes.c_int32),
        ("y0", ctypes.c_int32), ("rows", ctypes.c_int32), ("nseg", ctypes.c_int32),
        ("tx", ctypes.c_int32), ("vec", ctypes.c_int32), ("smem", ctypes.c_int32),
        ("raise_smem", ctypes.c_int32),
    ]


_smem_raised = set()  # devices whose kernel may take more than SMEM_DEFAULT


def _launch(src: torch.Tensor, dst: torch.Tensor, y0: int, off: torch.Tensor,
            seg_index: torch.Tensor) -> None:
    global launches, last_plan
    b, c, hs, w = src.shape
    rows = hs - y0
    if c != 3 or src.dtype != torch.float32 or not src.is_contiguous():
        raise ValueError("glitch shear: frames must be a contiguous f32 (B, 3, H, W) tensor")
    if not 0 <= y0 < hs:
        raise ValueError(f"glitch shear: band start {y0} outside the {hs} rows")
    if off.device != src.device or off.dtype != torch.int32 or off.ndim != 3 \
            or tuple(off.shape[:2]) != (b, rows) or not off.is_contiguous():
        raise ValueError(f"glitch shear: offsets must be a contiguous int32 "
                         f"({b}, {rows}, NSEG) tensor on {src.device}")
    if seg_index.device != src.device or seg_index.dtype != torch.int32 \
            or tuple(seg_index.shape) != (w,) or not seg_index.is_contiguous():
        raise ValueError(f"glitch shear: seg_index must be a contiguous int32 ({w},) "
                         f"tensor on {src.device}")
    if b == 0:
        return
    if b > 65535:
        raise ValueError(f"glitch shear: {b} frames, more than a launch's 65535")
    ptrs = (src.data_ptr(), dst.data_ptr(), off.data_ptr(), seg_index.data_ptr())
    nseg = off.shape[2]
    plan = glitch_plan(b, rows, w, nseg, ptrs[0] % 16 == 0 and ptrs[1] % 16 == 0
                       and ptrs[3] % 16 == 0)
    raise_smem = plan.smem > SMEM_DEFAULT and src.device not in _smem_raised
    a = _GlitchArgs(*ptrs, b, hs, w, y0, rows, nseg, plan.tx, plan.vec, plan.smem, raise_smem)
    _build.launch("crt_glitch_launch", a, src.device)
    if raise_smem:
        _smem_raised.add(src.device)
    launches += 1
    last_plan = plan


def shear_planar(band: torch.Tensor, off: torch.Tensor,
                 seg_index: torch.Tensor) -> torch.Tensor:
    """Out of place on a band: (B, 3, R, W) f32 -> a new sheared band."""
    if not on_card(band, "shear_planar"):
        return shear_planar_ref(band, off, seg_index)
    out = torch.empty_like(band)
    _launch(band, out, 0, off, seg_index)
    return out


def shear_planar_inplace(imgs: torch.Tensor, y0: int, off: torch.Tensor,
                         seg_index: torch.Tensor) -> torch.Tensor:
    """In place on full frames: rows [y0, H) of (B, 3, H, W) f32 frames
    are sheared by (B, H - y0, NSEG) int32 offsets; the rows above y0 are
    not touched. Returns ``imgs``."""
    if not on_card(imgs, "shear_planar_inplace"):
        imgs[:, :, y0:] = shear_planar_ref(imgs[:, :, y0:], off, seg_index)
        return imgs
    _launch(imgs, imgs, y0, off, seg_index)
    return imgs
