"""The stand-alone blooms' row walk in CUDA: its launch plans, their
replays and the launchers.

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

The fourth source, ``FAST`` (bloom3's fast bloom), is no band: per plane

    out = clip(x + strength * up(down(knee(x))))

with ``down`` and ``up`` the oracle's resize_bilinear to (H // 2, W // 2)
and back (kernels/fused.py ``fast_tables``). Its walk is the same strip
and run, with a ring of staged source rows (knee'd in place) that the
next chunk is copied into directly, a ring of half-res rows, each
computed once when its two source rows are staged, and, where a knee is
on, the pre-knee strip ring (without one the composite reads the staged
ring, which then keeps each row until its output row is written).
``fast_plan`` sizes it and builds the kernel's tables (the staged window
per strip, the schedule per run, the ring offsets per row);
``fast_chunks`` replays it (tests/test_torch_walk_plan.py).
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..ops import blur as oblur
from . import _build

FOLD, CLAMP, TABLE, FAST = 0, 1, 2, 3
SRC_NAMES = {FOLD: "fold", CLAMP: "clamp", TABLE: "table"}  # the banded sources
MAX_TAPS = 63  # taps carried in the launch arguments (csrc/bloom_walk.cu MAXK); more: a table
SMEM_MAX = 232448  # shared memory one block may use on sm_90 (227 KB)
STRIP_WIDTHS = (128, 64, 32, 16, 8, 4)  # output columns per block, widest that fits first
STEPS = (16, 8, 4, 2, 1)  # source rows per chunk, largest that fits first
RUN = 64  # output rows per block
FAST_STEP, FAST_RUN = 16, 64  # the fast source's source rows per chunk, output rows per block


def _a16(n: int) -> int:
    return -(-n // 16) * 16


def _round4(n: int) -> int:
    return -(-n // 4) * 4


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


@dataclass(eq=False)
class FastPlan:
    """How csrc/bloom_walk.cu's fast source covers a plane: strips of ``sw``
    output columns, runs of ``run`` output rows, chunks of ``step`` source
    rows; rings of ``depth`` staged source rows (pitch ``win`` floats),
    ``xdepth`` pre-knee strip rows (``knee`` on; else 0: the staged ring
    holds them) and ``hdepth`` half-res rows (pitch ``hwin``); ``smem``
    the block's shared memory in bytes. The kernel's tables: ``windows``
    (strips, 4) the staged columns [a0, a0 + n) and the half-res columns
    [j0, j0 + nh) of each strip; ``sched`` (runs, 3 + 2 * chunks) the
    source rows [pa, pe), the first half-res row, then (he, ye) per chunk
    (half-res rows below he and output rows below ye are done after it);
    ``rowtab`` (H, 4) per output row the ring offsets (floats) of its
    pre-knee row (in the pre-knee ring, or without a knee in the staged
    ring) and its two half-res rows and its up-row fraction's bits;
    ``halftab`` (H2, 4) per half-res row the ring offsets of its two
    source rows, its own offset and its down-row fraction's bits. Slot of
    source row s: s % depth (the other rings alike)."""
    h: int
    w: int
    knee: bool
    sw: int
    step: int
    run: int
    depth: int
    xdepth: int
    hdepth: int
    win: int
    hwin: int
    smem: int
    windows: np.ndarray
    sched: np.ndarray
    rowtab: np.ndarray
    halftab: np.ndarray

    @property
    def strips(self) -> int:
        return -(-self.w // self.sw)

    @property
    def h2(self) -> int:
        return max(1, self.h // 2)

    @property
    def w2(self) -> int:
        return max(1, self.w // 2)


def fast_windows(w: int, sw: int, taps: tuple) -> np.ndarray:
    """(strips, 4): the staged columns (a0, n) of each strip (the strip and
    the columns its down taps read; start and length aligned to 4 where
    W % 4 == 0, for 16-byte copies) and its half-res columns (j0, nh)."""
    from .fused import strip_windows  # fused imports bloom3, which imports this module

    gran = 4 if w % 4 == 0 else 1
    c0, c1, j0, j1 = strip_windows(w, sw, 0, taps).T
    a0 = c0 // gran * gran
    return np.stack([a0, -(-(c1 - a0) // gran) * gran, j0, j1 - j0 + 1], 1).astype(np.int32)


def fast_chunks(h: int, run: int, step: int, taps: tuple, y0: int, knee: bool = True) -> list:
    """Replay the fast source's walk of the run that starts at output row
    y0: one tuple per chunk, (d, e, nh, he, nxt, ye, alive, halive):
    source rows [d, e) staged, then half-res rows [nh, he), then output
    rows [nxt, ye) written. ``alive`` is the oldest staged row still to be
    read when the chunk starts (its own rows, the operands of the half-res
    rows not yet computed and, without a knee, the pre-knee rows of the
    output rows not yet written), ``halive`` the oldest half-res row still
    to be read or written."""
    fd_ylo, fu_ylo = np.asarray(taps[0]), np.asarray(taps[4])
    h2 = len(fd_ylo)
    y1 = min(y0 + run, h)
    i0, i1 = int(fu_ylo[y0]), min(int(fu_ylo[y1 - 1]) + 1, h2 - 1)
    pa = min(int(fd_ylo[i0]), y0)
    pb = max(min(int(fd_ylo[i1]) + 1, h - 1), y1 - 1)
    nh, nxt, chunks = i0, y0, []
    for d in range(pa, pb + 1, step):
        e = min(d + step, pb + 1)
        he = nh
        while he <= i1 and min(int(fd_ylo[he]) + 1, h - 1) < e:
            he += 1
        ye = nxt
        while ye < y1 and ye < e and min(int(fu_ylo[ye]) + 1, h2 - 1) < he:
            ye += 1
        alive = min(d, int(fd_ylo[nh])) if nh <= i1 else d
        if not knee and nxt < y1:
            alive = min(alive, nxt)
        halive = min(nh, int(fu_ylo[nxt])) if nxt < y1 else nh
        chunks.append((d, e, nh, he, nxt, ye, alive, halive))
        nh, nxt = he, ye
    if nxt != y1 or nh != i1 + 1:
        raise RuntimeError(f"fast walk: the walk of rows {y0}..{y1} stopped at {nxt}")
    return chunks


def fast_smem(sw: int, depth: int, xdepth: int, hdepth: int, win: int, hwin: int) -> int:
    """Shared memory of one block in bytes, csrc/bloom_walk.cu's
    fast_layout: the staged-row ring, the pre-knee strip ring, the half-res
    ring, the strip's down-column taps."""
    return (_a16(depth * win * 4) + _a16(xdepth * sw * 4) + _a16(hdepth * hwin * 4)
            + 2 * _a16(hwin * 4))


@functools.lru_cache(maxsize=16)
def fast_plan(h: int, w: int, knee: bool) -> FastPlan:
    """The widest strip (then the largest chunk) whose block fits in shared
    memory, the ring depths the walk needs (replayed), and the kernel's
    tables. At the main path's 1080p: 128-column strips, chunks of
    FAST_STEP rows, runs of FAST_RUN."""
    from .fused import fast_tables

    if h < 1 or w < 1:
        raise ValueError(f"fast walk: bad frame {h}x{w}")
    taps = fast_tables(h, w)
    fd_ylo, fd_yf, fu_ylo, fu_yf = (np.asarray(taps[i]) for i in (0, 1, 4, 5))
    h2 = len(fd_ylo)
    run = min(FAST_RUN, h)
    for sw in STRIP_WIDTHS:
        windows = fast_windows(w, sw, taps)
        win = _round4(int(windows[:, 1].max()))
        hwin = _round4(int(windows[:, 3].max()))
        for step in (s for s in STEPS if s <= FAST_STEP):
            depth = hdepth = 1
            xdepth = 1 if knee else 0
            sched = []
            for y0 in range(0, h, run):
                chunks = fast_chunks(h, run, step, taps, y0, knee)
                sched.append([chunks[0][0], chunks[-1][1], chunks[0][2]]
                             + [v for c in chunks for v in (c[3], c[5])])
                for k, (d, e, nh, he, nxt, ye, alive, halive) in enumerate(chunks):
                    # the next chunk is staged while this one is read
                    e_next = chunks[k + 1][1] if k + 1 < len(chunks) else e
                    depth = max(depth, e_next - alive)
                    if knee:
                        xdepth = max(xdepth, e - min(nxt, d))
                    hdepth = max(hdepth, he - halive)
            smem = fast_smem(sw, depth, xdepth, hdepth, win, hwin)
            if smem <= SMEM_MAX:
                break
        else:
            continue
        break
    else:
        raise RuntimeError(f"fast walk: no strip fits a block at {h}x{w}")
    tab = np.zeros((len(sched), max(map(len, sched))), np.int32)
    for i, row in enumerate(sched):
        tab[i, :len(row)] = row
    y, i = np.arange(h), np.arange(h2)
    ulo, lo = fu_ylo.astype(np.int64), fd_ylo.astype(np.int64)
    rowtab = np.stack([y % xdepth * sw if knee else y % depth * win, ulo % hdepth * hwin,
                       np.minimum(ulo + 1, h2 - 1) % hdepth * hwin,
                       fu_yf.astype(np.float32).view(np.int32)], 1).astype(np.int32)
    halftab = np.stack([lo % depth * win, np.minimum(lo + 1, h - 1) % depth * win,
                        i % hdepth * hwin,
                        fd_yf.astype(np.float32).view(np.int32)], 1).astype(np.int32)
    return FastPlan(h, w, knee, sw, step, run, depth, xdepth, hdepth, win, hwin, smem, windows,
                    tab, rowtab, halftab)


class FastTables(NamedTuple):
    """The fast source's operands on one device, built once per frame size
    and knee (``fast_tables``): the oracle's bilinear_taps (lo int32, frac f32) for
    the down rows, down columns, up rows and up columns (the plain twin's
    operands; the kernel reads the column taps), the plan, and the plan's
    tables (windows, sched, rowtab, halftab)."""
    taps: tuple
    plan: FastPlan
    walk: tuple


def fast_tables(h: int, w: int, threshold: float, device="cpu") -> FastTables:
    from .fused import fast_tables as taps_of

    plan = fast_plan(h, w, threshold > 0.0)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return FastTables(tuple(dev(a) for a in taps_of(h, w)), plan,
                      tuple(dev(t) for t in (plan.windows, plan.sched, plan.rowtab,
                                             plan.halftab)))


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
        ("fd_xlo", ctypes.c_void_p), ("fd_xf", ctypes.c_void_p),
        ("fu_xlo", ctypes.c_void_p), ("fu_xf", ctypes.c_void_p),
        ("fwin", ctypes.c_void_p), ("fsched", ctypes.c_void_p),
        ("frow", ctypes.c_void_p), ("fhalf", ctypes.c_void_p),
        ("w2", ctypes.c_int32), ("hdepth", ctypes.c_int32), ("hwin", ctypes.c_int32),
        ("sched_stride", ctypes.c_int32),
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
    _build.launch("crt_walk_launch", a, imgs.device)
    del scratch, tapdev  # freed on the stream: the allocator reuses them only after the kernel
    return out


def fast_launch(imgs: torch.Tensor, tables: FastTables, name: str, *, strength: float,
                threshold: float) -> torch.Tensor:
    """Launch csrc/bloom_walk.cu's fast source on a (B, 3, H, W) f32 CUDA
    tensor with the tables of its frame size on its device. Counts no
    launch: the entry counts its own."""
    from .fused import knee_consts

    plan = tables.plan
    h, w = plan.h, plan.w
    if plan.knee != (threshold > 0.0):
        raise ValueError(f"{name}: the tables were planned for the knee "
                         f"{'on' if plan.knee else 'off'}")
    if imgs.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {imgs.device}")
    if (imgs.ndim != 4 or imgs.shape[1] != 3 or tuple(imgs.shape[2:]) != (h, w)
            or imgs.dtype != torch.float32 or not imgs.is_contiguous()):
        raise ValueError(f"{name}: imgs must be a contiguous f32 (B, 3, {h}, {w}) tensor, "
                         f"got {imgs.dtype} {tuple(imgs.shape)}")
    h2, w2 = plan.h2, plan.w2
    want = ((h2,), (h2,), (w2,), (w2,), (h,), (h,), (w,), (w,))
    for i, (t, shape) in enumerate(zip(tables.taps, want)):
        dt = torch.int32 if i % 2 == 0 else torch.float32
        if (t.device != imgs.device or t.dtype != dt or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(f"{name}: tap table {i} must be a {dt} {shape} tensor on "
                             f"{imgs.device}")
    for t, src in zip(tables.walk, (plan.windows, plan.sched, plan.rowtab, plan.halftab)):
        if (t.device != imgs.device or t.dtype != torch.int32 or tuple(t.shape) != src.shape
                or not t.is_contiguous()):
            raise ValueError(f"{name}: the plan's tables must be int32 on {imgs.device}")
    out = torch.empty_like(imgs)
    a = _WalkArgs()
    a.img, a.out = imgs.data_ptr(), out.data_ptr()
    a.n, a.h, a.w, a.src = imgs.shape[0] * 3, h, w, FAST
    if threshold > 0.0:
        a.knee_on, (a.thr, a.rden) = 1, knee_consts(threshold)
    a.strength = np.float32(strength)
    a.sw, a.lg_nq, a.step, a.run = plan.sw, (plan.sw // 4).bit_length() - 1, plan.step, plan.run
    a.depth, a.xdepth, a.win, a.smem = plan.depth, plan.xdepth, plan.win, plan.smem
    a.copy16 = int(w % 4 == 0 and a.img % 16 == 0)
    a.vec_ok = int(w % 4 == 0 and a.out % 16 == 0)
    a.fd_xlo, a.fd_xf = tables.taps[2].data_ptr(), tables.taps[3].data_ptr()
    a.fu_xlo, a.fu_xf = tables.taps[6].data_ptr(), tables.taps[7].data_ptr()
    a.fwin, a.fsched, a.frow, a.fhalf = (t.data_ptr() for t in tables.walk)
    a.w2, a.hdepth, a.hwin = w2, plan.hdepth, plan.hwin
    a.sched_stride = plan.sched.shape[1]
    _build.launch("crt_walk_launch", a, imgs.device)
    return out
