"""The stand-alone gaussian and banded blooms' one CUDA kernel: its launch
plan, its replay and its launcher.

csrc/bloom_walk.cu computes, per (H, W) plane of a (B, 3, H, W) f32
batch,

    out = clip(x + strength * V(H(knee(x))))

where H and V are 1-D passes over a band of offsets d0..d1 whose weights
come from one of three sources (``src``):

- ``FOLD`` (bloom3's gaussian, kernels/bloom3.py): constant taps, taps
  that leave the frame add nothing, then the summed left and right border
  coefficients times the edge sample (ops/blur.py);
- ``CLAMP`` (the stripe bloom, kernels/bloom.py): constant taps, every tap
  reads the replicate-clamped sample, in tap order;
- ``TABLE`` (bloom2 and its pipelined entry, kernels/bloom2.py):
  per-position weights hw (ndh, W) and vw (ndv, H), clamped samples.

A block owns a strip of ``sw`` output columns of one plane and walks down
a run of ``run`` output rows in chunks of ``step`` source rows: the next
chunk's raw rows (the strip plus the horizontal reach, clamped to the
frame) are staged while this one is filtered, the horizontal pass runs
once per row into a ring of ``depth`` filtered rows, and each output row
is the vertical sum over that ring, composited with its pre-knee value
from a ring of ``xdepth`` staged rows of the strip. ``walk_plan`` sizes
all of it on the host; ``walk_chunks`` replays the kernel's walk
(tests/test_torch_walk_plan.py holds it to each twin's reads).

A band too wide for a block's shared memory at the narrowest strip takes
the scratch route: a horizontal pass into a (B * 3, H, W) device buffer,
then a vertical pass from it, both in the same source (``plan.scratch``).
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..ops import blur as oblur
from . import _build

FOLD, CLAMP, TABLE = 0, 1, 2
SRC_NAMES = {FOLD: "fold", CLAMP: "clamp", TABLE: "table"}
MAX_TAPS = 63  # taps carried in the launch arguments (csrc/bloom_walk.cu MAXK); more: a table
SMEM_MAX = 232448  # shared memory one block may use on sm_90 (227 KB)
STRIP_WIDTHS = (128, 64, 32, 16, 8, 4)  # output columns per block, widest that fits first
STEPS = (16, 8, 4, 2, 1)  # source rows per chunk, largest that fits first
RUN = 64  # output rows per block


def _a16(n: int) -> int:
    return -(-n // 16) * 16


def _clamp(v, lo, hi):
    return min(max(v, lo), hi)


@dataclass(frozen=True)
class WalkPlan:
    """How csrc/bloom_walk.cu covers a plane: strips of ``sw`` columns,
    runs of ``run`` rows, chunks of ``step`` rows; ``depth`` filtered rows
    and ``xdepth`` pre-knee strip rows held; ``win`` the staged row pitch
    in floats; ``smem`` the block's shared memory in bytes. ``scratch``:
    the band fits no block, and two passes through a device buffer run
    instead (the other sizes are then 0)."""
    src: int
    h: int
    w: int
    hd0: int
    hd1: int
    vd0: int
    vd1: int
    sw: int = 0
    step: int = 0
    run: int = 0
    depth: int = 0
    xdepth: int = 0
    win: int = 0
    smem: int = 0
    scratch: bool = False

    @property
    def strips(self) -> int:
        return -(-self.w // self.sw)


def strip_window(w: int, sw: int, hd0: int, hd1: int, s: int, gran: int = 4) -> tuple:
    """Strip s's staged columns (a0, n): the strip and its horizontal reach
    clamped to the frame, the start aligned down to ``gran`` columns and
    the length up to ``gran`` (csrc/bloom_walk.cu computes the same)."""
    x0 = s * sw
    xe = min(x0 + sw, w)
    c0 = _clamp(x0 + min(hd0, 0), 0, w - 1)
    c1 = _clamp(xe - 1 + max(hd1, 0), 0, w - 1) + 1
    a0 = c0 // gran * gran
    return a0, -(-(c1 - a0) // gran) * gran


def walk_chunks(plan: WalkPlan, y0: int) -> list:
    """Replay csrc/bloom_walk.cu's walk of the run that starts at output
    row y0: one tuple per chunk, (d, e, nxt, ye, alive): source rows
    [d, e) staged and filtered, then output rows [nxt, ye) written;
    ``alive`` is the oldest filtered row those outputs read (what the ring
    must still hold)."""
    h, vd0, vd1 = plan.h, plan.vd0, plan.vd1
    y1 = min(y0 + plan.run, h)
    pa, pb = _clamp(y0 + vd0, 0, h - 1), _clamp(y1 - 1 + vd1, 0, h - 1)
    nxt, chunks = y0, []
    for d in range(pa, pb + 1, plan.step):
        e = min(d + plan.step, pb + 1)
        ye = y1 if e >= h else max(nxt, min(y1, e - vd1))
        chunks.append((d, e, nxt, ye, _clamp(nxt + vd0, 0, h - 1)))
        nxt = ye
    if nxt != y1:
        raise RuntimeError(f"walk plan: the walk of rows {y0}..{y1} stopped at {nxt}")
    return chunks


def walk_smem(src: int, hd0: int, hd1: int, sw: int, step: int, depth: int, xdepth: int,
              win: int) -> int:
    """Shared memory of one block in bytes, csrc/bloom_walk.cu's
    walk_layout: two staged chunks, the filtered ring, the pre-knee strip
    ring, the weight table (the strip's columns of hw; or the taps, and
    for the fold both border arrays, which the runtime-radius instances
    read from shared memory)."""
    nd = hd1 - hd0 + 1
    tab = nd * sw if src == TABLE else nd + (2 * hd1 if src == FOLD else 0)
    return (_a16(2 * step * win * 4) + _a16(depth * sw * 4) + _a16(xdepth * sw * 4)
            + _a16(tab * 4))


@functools.lru_cache(maxsize=64)
def walk_plan(src: int, h: int, w: int, hd0: int, hd1: int, vd0: int, vd1: int) -> WalkPlan:
    """The widest strip (then the largest chunk) whose block fits in shared
    memory, with the ring depths the walk needs; the scratch route when
    none fits."""
    if src not in SRC_NAMES or h < 1 or w < 1 or hd0 > hd1 or vd0 > vd1:
        raise ValueError(f"walk plan: bad source or band ({src}, {hd0}..{hd1}, {vd0}..{vd1})")
    run = min(RUN, h)
    for sw in STRIP_WIDTHS:
        win = max(strip_window(w, sw, hd0, hd1, s)[1] for s in range(-(-w // sw)))
        for step in STEPS:
            probe = WalkPlan(src, h, w, hd0, hd1, vd0, vd1, sw, step, run)
            depth = xdepth = 1
            for y0 in range(0, h, run):
                for d, e, nxt, ye, alive in walk_chunks(probe, y0):
                    depth, xdepth = max(depth, e - alive), max(xdepth, e - nxt)
            smem = walk_smem(src, hd0, hd1, sw, step, depth, xdepth, win)
            if smem <= SMEM_MAX:
                return WalkPlan(src, h, w, hd0, hd1, vd0, vd1, sw, step, run, depth, xdepth,
                                win, smem)
    return WalkPlan(src, h, w, hd0, hd1, vd0, vd1, scratch=True)


class _WalkArgs(ctypes.Structure):
    """Mirror of WalkArgs in csrc/bloom_walk.cu (checked by size at launch)."""
    _fields_ = [
        ("img", ctypes.c_void_p), ("out", ctypes.c_void_p),
        ("hw", ctypes.c_void_p), ("vw", ctypes.c_void_p),
        ("tapdev", ctypes.c_void_p), ("scratch", ctypes.c_void_p),
        ("n", ctypes.c_int32), ("h", ctypes.c_int32), ("w", ctypes.c_int32),
        ("src", ctypes.c_int32),
        ("hd0", ctypes.c_int32), ("hd1", ctypes.c_int32),
        ("vd0", ctypes.c_int32), ("vd1", ctypes.c_int32),
        ("knee_on", ctypes.c_int32), ("thr", ctypes.c_float), ("rden", ctypes.c_float),
        ("strength", ctypes.c_float), ("limbs", ctypes.c_int32),
        ("sw", ctypes.c_int32), ("lg_nq", ctypes.c_int32), ("step", ctypes.c_int32),
        ("run", ctypes.c_int32), ("depth", ctypes.c_int32), ("xdepth", ctypes.c_int32),
        ("win", ctypes.c_int32), ("smem", ctypes.c_int32),
        ("copy16", ctypes.c_int32), ("vec_ok", ctypes.c_int32),
        ("scratch_on", ctypes.c_int32),
        ("taps", ctypes.c_float * MAX_TAPS),
        ("edge_l", ctypes.c_float * MAX_TAPS),
        ("edge_r", ctypes.c_float * MAX_TAPS),
    ]


def tap_table(taps: tuple, fold: bool, device) -> torch.Tensor:
    """The taps (and for the fold, edge_l and edge_r) as one f32 device
    table: what a band too wide for the launch arguments, or the scratch
    route, reads."""
    parts = [np.asarray(taps, np.float32)]
    r = len(taps) // 2
    if fold and r > 0:
        left, right = oblur.edge_coefs(taps)
        parts += [left[:r], right[:r]]
    return torch.from_numpy(np.concatenate(parts)).to(device)


def walk_launch(imgs: torch.Tensor, h: int, w: int, name: str, *, src: int, bands: tuple,
                strength: float, threshold: float, taps: tuple = None, tables: tuple = None,
                limbs: int = 3) -> torch.Tensor:
    """Launch csrc/bloom_walk.cu on a (B, 3, h, w) f32 CUDA tensor.

    ``bands`` is (hd0, hd1, vd0, vd1); ``threshold`` the knee's (0: off);
    ``taps`` the constant taps of the fold and the clamp (band -r..r on
    both axes), ``tables`` the (hw, vw) weights of the table source.
    Counts no launch: each entry counts its own."""
    from .fused import knee_consts  # fused imports bloom3, which imports this module

    if imgs.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {imgs.device}")
    if (imgs.ndim != 4 or imgs.shape[1] != 3 or tuple(imgs.shape[2:]) != (h, w)
            or imgs.dtype != torch.float32 or not imgs.is_contiguous()):
        raise ValueError(f"{name}: imgs must be a contiguous f32 (B, 3, {h}, {w}) tensor, "
                         f"got {imgs.dtype} {tuple(imgs.shape)}")
    b = imgs.shape[0]
    hd0, hd1, vd0, vd1 = bands
    plan = walk_plan(src, h, w, hd0, hd1, vd0, vd1)
    out = torch.empty_like(imgs)
    a = _WalkArgs()
    a.img, a.out = imgs.data_ptr(), out.data_ptr()
    tapdev = None
    if src == TABLE:
        for tname, t, shape in (("hw", tables[0], (hd1 - hd0 + 1, w)),
                                ("vw", tables[1], (vd1 - vd0 + 1, h))):
            if (t.device != imgs.device or t.dtype != torch.float32
                    or tuple(t.shape) != shape or not t.is_contiguous()):
                raise ValueError(f"{name}: table {tname} must be a contiguous f32 {shape} "
                                 f"tensor on {imgs.device}")
        a.hw, a.vw = tables[0].data_ptr(), tables[1].data_ptr()
    else:
        if len(taps) != hd1 - hd0 + 1 or bands != (hd0, hd1, hd0, hd1) or hd0 != -hd1:
            raise ValueError(f"{name}: constant taps need the band -r..r on both axes")
        if len(taps) <= MAX_TAPS:
            a.taps[:len(taps)] = [float(np.float32(t)) for t in taps]
            if src == FOLD:
                left, right = oblur.edge_coefs(taps)
                a.edge_l[:len(left)] = [float(v) for v in left]
                a.edge_r[:len(right)] = [float(v) for v in right]
        if len(taps) > MAX_TAPS or plan.scratch:
            tapdev = tap_table(tuple(taps), src == FOLD, imgs.device)
            a.tapdev = tapdev.data_ptr()
    a.n, a.h, a.w, a.src = b * 3, h, w, src
    a.hd0, a.hd1, a.vd0, a.vd1 = bands
    if threshold > 0.0:
        a.knee_on, (a.thr, a.rden) = 1, knee_consts(threshold)
    a.strength = np.float32(strength)
    a.limbs = limbs
    scratch = None
    if plan.scratch:
        scratch = torch.empty_like(imgs)
        a.scratch, a.scratch_on = scratch.data_ptr(), 1
    else:
        a.sw, a.lg_nq, a.step, a.run = plan.sw, (plan.sw // 4).bit_length() - 1, plan.step, \
            plan.run
        a.depth, a.xdepth, a.win, a.smem = plan.depth, plan.xdepth, plan.win, plan.smem
        a.copy16 = int(w % 4 == 0 and a.img % 16 == 0)
        a.vec_ok = int(w % 4 == 0 and a.out % 16 == 0)
    _build.launch("crt_walk_launch", a, torch.cuda.current_stream(imgs.device).cuda_stream)
    del scratch, tapdev  # freed on the stream: the allocator reuses them only after the kernel
    return out
