"""Stages 1-11 in one pass: the CUDA fused kernel and its plain twin.

Port of pythoncrt_tpu/kernels/fused.py (fused_pipeline / _fused_kernel):

  u8 planar frame --gather through the pixelate/aberration maps-->
  /255 -> grade -> knee -> bloom core -> composite -> triad ->
  scanlines -> vignette -> flicker -> grain -> f32 or uint8

With ``spec.grain_size`` above 1 the grain operand is the raw (gh, gw)
field of each frame, and the kernel upsamples it (the JAX kernel's
``grain_raw`` branch, fused.py:640-667): per output pixel the oracle's
bilinear taps (``FusedConsts.grain_taps``), rows first, then columns,
each ``lo * (1 - f) + hi * f`` in f32, bit for bit
``ops/resize.resize_bilinear`` of the field. The TPU kernel's 8-row
windows and bf16 column dot have no counterpart: they are its layout's,
and its gate (grain size 2, even H, strength <= 32) is their error
envelope; the port takes any grain size and H, W. The plan sizes the
kernel's raw stage (``FusedPlan.gdepth``, ``gpitch``, ``grows``,
``grawtab``): per chunk the raw rows its output rows read, over the
strip's raw columns, staged a chunk ahead.

The bloom core is the exact gaussian (H then V), the fast half-res
down+up (the oracle's resize_bilinear twice, driven by its bilinear_taps
tables), or off. With ``spec.text_box`` the uint8 input's prologue also
composites the text overlay before the bloom (stage 5, the engine's
route for text before the bloom): after the grade, over the box the
overlay's alpha covers, from crops of its alpha and colour (the
``talpha`` and ``trgb`` operands); outside the box the composite is the
identity, so the kernel skips it there, and each output row inside the
box is a distinct row of the walk (``distinct_rows``). With
``spec.pre`` False (the JAX kernel's ``pre=False``) the input is an f32
image after stages 1-5 and the kernel starts at the knee. The triad reads the
1024-bin tables (the reference's bytes), or with ``spec.lut_exact``
False (``--precision fast``, the JAX kernel's direct-pow branch) takes
pow on the clipped values: csrc/fused.cu's direct-pow instantiations.

The twin is split at the bloom (``prologue_ref``, ``bloom_ref``,
``epilogue_ref``) so that the engine's staged step, which runs the
stand-alone bloom kernel between them, shares its op order.

``fused_pipeline`` launches csrc/fused.cu for CUDA tensors and runs
``fused_pipeline_ref`` (plain PyTorch, the same op order) for CPU
tensors. The spec keeps the JAX kernel's parameter names; the TPU's
stripe height, VMEM sizing and pixel-size/shape gates have no
counterpart here (the CUDA kernel takes any H, W and pixel size).

The kernel walks column strips down runs of rows (csrc/fused.cu).
``fused_plan`` computes on the host what it needs for that: the strip
width, the rows per run and per chunk, the ring depths, the staged
column segments of each strip and the distinct-row tables, and
``plan_chunks`` replays the kernel's walk so that the ring depths are
the ones the walk needs (tests/test_torch_fused_plan.py checks it).

Any gaussian radius: above 31 the taps and border coefficients come from
a device table (``FusedConsts.tapdev``) that the kernel stages in shared
memory, and the plan narrows the strip as the rings grow. Where no strip
fits a block (``FusedPlan.split``), ``fused_pipeline`` runs the chain as
three launches of hand-written kernels with the same bits: the fused
kernel's prologue alone (f32 out), the stand-alone bloom
(kernels/bloom3.py, the row walk of csrc/bloom_walk.cu), and the fused
kernel's epilogue on that f32 image.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import oracle
from ..ops import blur as oblur
from ..ops import color as ocolor
from ..ops import resize as oresize
from . import _build, dest, into
from . import text as ktext

launches = 0  # CUDA launches made by fused_pipeline

MAX_TAPS = 63  # csrc/fused.cu MAXK: taps carried in the launch arguments
MAX_R = MAX_TAPS // 2  # above this radius the taps come from a device table
SMEM_MAX = 232448  # shared memory one block may use on sm_90 (227 KB)
SMEM_SM = 233472  # shared memory of an SM's blocks on sm_90 (228 KB), 1 KB of it reserved per block
DIRECT_TAB = 320  # csrc/triad_pow.cuh TAB: the direct-pow triad's table in floats
STRIP_WIDTHS = (128, 64, 32, 16, 8, 4)  # output columns per block, widest that fits first
# distinct source rows per chunk and output rows per block, by core and
# input: the fastest of a sweep of strips, chunks and runs on an H100
# (PERF.md, the fused kernel's redesign)
WALK = {("gaussian", True): (8, 64), ("gaussian", False): (8, 64),
        ("fast", True): (12, 128), ("fast", False): (6, 128),
        ("big", True): (16, 540), ("big", False): (16, 256)}
BIG_ROWS = 4  # csrc/fused.cu BR: output rows a thread sums at once past MAX_R
# past MAX_R a strip narrower than this leaves the vertical pass too few
# groups of rows to fill a block: two blocks per SM are sought only at
# this width and wider (PERF.md)
BIG_MIN_SW = 32
# the raw grain's stage: where it leaves room for fewer blocks per SM than
# the same walk at grain size 1 (by shared memory and the register cap),
# the first of these shorter chunks that restores them is taken (the CLI
# defaults at --grain-size 2: 8 in place of 12 keeps 4 fast-core blocks
# per SM, faster on an H100, PERF.md)
GRAW_STEPS = (8, 6)


@dataclass(frozen=True)
class FusedSpec:
    h: int
    w: int
    # stage 6 (bloom): gaussian taps, radius r = len(taps) // 2, or the
    # fast half-res down+up core (no taps)
    bloom: bool = True
    taps: tuple = ()
    fast: bool = False
    strength: float = 0.0
    threshold: float = 0.0
    # stages 2-4 (prologue): run by the kernel when pre, else by the
    # caller (prologue_ref) before it hands the kernel an f32 image
    pre: bool = True
    # stage 5 with pre: (y0, y1, x0, x1), the rows and columns of the text
    # overlay's box, composited after the grade; () without text
    text_box: tuple = ()
    px: int = 1
    ab: int = 0
    saturation: float = 1.0
    temp_r: float = 1.0
    temp_b: float = 1.0
    brightness: float = 0.0
    contrast: float = 1.0
    inv_gamma: float = 1.0
    # stages 7-11 (epilogue)
    triad: bool = False
    triad_gamma: float = 2.2
    triad_luma: bool = False
    # the triad's two pow sites: the 1024-bin tables (the reference's
    # bytes), or False (--precision fast) pow on the clipped values
    lut_exact: bool = True
    scanlines: bool = False
    vignette: bool = False
    vig_strength: float = 0.0
    flicker: bool = False
    noise: bool = False
    noise_scale: float = 0.0
    # the grain field's size: above 1 the operand is the raw (gh, gw)
    # field, upsampled by the kernel (grain_hw)
    grain_size: int = 1
    emit: str = "f32"  # "f32" [0, 1] or "u8" clip(rint(x * 255))
    corder: tuple = (0, 1, 2)  # plane i holds colour corder[i]

    @property
    def r(self) -> int:
        return len(self.taps) // 2

    @property
    def grain_hw(self) -> tuple[int, int]:
        """(gh, gw) of the grain operand: the raw field's size (the
        reference's cv2.resize source, crt_filter.py:640-642)."""
        g = self.grain_size
        return (max(1, self.h // g), max(1, self.w // g)) if g > 1 else (self.h, self.w)


def build_fused_spec(h: int, w: int, *, sigma: float = 0.0, strength: float = 0.0,
                     threshold: float = 0.0, fast: bool = False, bloom: bool = True,
                     pre: bool = True, lut_exact: bool = True, **kw) -> FusedSpec:
    """Build a spec from the arguments of the JAX package's
    build_fused_spec (kernels/fused.py:168). ``pre`` False takes the f32
    image (the prologue's fields then describe the caller's prologue).
    ``lut_exact`` False is the JAX kernel's direct-pow triad (fused.py:
    601-631), the whole of ``--precision fast`` here: the TPU's
    single-pass bf16 matmuls have no counterpart in the port's f32
    gathers and sums. Any H, W and radius: the TPU kernel's shape gates
    (H%8, W%128, even sizes for the fast core) have no counterpart. An
    aberration of W columns or more is taken mod W (the roll wraps: the
    same index maps). ``grain_size`` takes the place of the JAX kernel's
    ``grain_g`` and its window forms (``grain_off``, ``grain_frac``,
    ``grain_raw``): above 1 the kernel always upsamples the raw field."""
    if kw.get("emit", "f32") not in ("f32", "u8"):
        raise ValueError(f"unknown emit mode {kw.get('emit')!r}")
    fast = bool(bloom and fast)
    taps = oblur.gaussian_taps(sigma) if bloom and not fast else ()
    if int(kw.get("px", 1)) < 1 or int(kw.get("grain_size", 1)) < 1:
        raise ValueError("pixel size and grain size must be >= 1")
    ab = int(kw.get("ab", 0))
    if abs(ab) >= w:
        kw["ab"] = int(math.fmod(ab, w))
    box = tuple(int(v) for v in kw.get("text_box", ()))
    if box and (not pre or len(box) != 4 or not (0 <= box[0] < box[1] <= h)
                or not (0 <= box[2] < box[3] <= w)):
        raise ValueError(f"text_box {box} must be (y0, y1, x0, x1) inside the {h}x{w} frame, "
                         "with the uint8 input (pre)")
    kw["text_box"] = box
    return FusedSpec(h=int(h), w=int(w), bloom=bool(bloom), taps=taps, fast=fast,
                     strength=float(strength), threshold=float(threshold), pre=bool(pre),
                     lut_exact=bool(lut_exact), **kw)


def triad_mode(spec: FusedSpec) -> int:
    """csrc/fused.cu's triad_mode: 0 off, 1 the clipped multiply, 2 the
    1024-bin tables, 3 pow on the clipped values (--precision fast)."""
    if not spec.triad:
        return 0
    if ocolor.triad_is_multiply(spec.triad_gamma, spec.triad_luma):
        return 1
    return 2 if spec.lut_exact else 3


class FusedConsts(NamedTuple):
    """Device tables of one spec: index maps, the triad tables and the
    fast core's resize taps."""
    y_map: torch.Tensor            # (H,) int32
    x_maps: torch.Tensor           # (3, W) int32, plane order
    lut_fwd: Optional[torch.Tensor]  # (1025,) f32 (triad_mode 2)
    lut_fin: Optional[torch.Tensor]  # (1025,) f32 (triad_mode 2)
    # fast core: (lo int32, frac f32) for the down rows (H2,), down
    # columns (W2,), up rows (H,) and up columns (W,): the oracle's
    # bilinear_taps
    fast_taps: Optional[tuple] = None
    # the CUDA kernel's walk (fused_plan) and its device tables (ydist,
    # ysrc, segs)
    plan: Optional["FusedPlan"] = None
    plan_tables: Optional[tuple] = None
    # radius above MAX_R: (k + 2r,) f32 taps, edge_l, edge_r on the device
    tapdev: Optional[torch.Tensor] = None
    # a plan that fits no block (plan.split): (prologue spec or None,
    # its consts, the stand-alone bloom's Bloom3Spec, epilogue spec, its
    # consts)
    split: Optional[tuple] = None
    # the raw grain's upsample (grain_size > 1 with the noise on): the
    # oracle's bilinear_taps, (lo int32, frac f32) for the rows (H,) and
    # the columns (W,)
    grain_taps: Optional[tuple] = None


@dataclass(eq=False)
class FusedPlan:
    """How csrc/fused.cu walks a batch: one block per strip of ``sw``
    output columns and run of ``run`` output rows of one frame, walking
    down the run in chunks of ``step`` distinct source rows.

    ``depth`` is the ring of distinct source rows (gaussian: the
    horizontally filtered rows and the pre-knee strip; fast: the knee'd
    window rows and the pre-knee strip), ``hdepth`` the fast core's ring
    of half-res rows. ``win`` and ``hwin`` are the row pitches of the
    full-res and half-res column windows, ``seg_pitch`` the staged row
    pitch per plane in elements (uint8, or f32 when not ``pre``),
    ``gran`` the element alignment of the staged segments and ``smem``
    the block's shared memory in bytes. ``runtab``, ``rowtab`` and
    ``halftab`` are the kernel's tables: the walk's schedule per run, and
    the ring offsets of each output row's and half-res row's operands.
    ``split``: no strip fits a block (the three-launch route of
    ``fused_pipeline``; the walk's sizes and tables are then unset).
    ``direct``: the direct-pow triad (triad_mode 3), which stages its pow
    sites' table (DIRECT_TAB floats) in place of the LUTs.

    ``grain``: (grain size, gh, gw) where the kernel upsamples the raw
    grain field (the noise on at a grain size above 1; else None). Its
    raw stage holds, per chunk, the raw rows its output rows read over
    the strip's raw columns (``gwindows``, from the oracle's column taps)
    and the rows' taps, in two buffers: ``gdepth`` raw rows of ``gpitch``
    floats and ``grows`` output rows at most (grain_stage). ``grawtab``:
    per run and chunk, its first raw row, raw rows and output rows.

    ``text``: the spec's text box, whose rows are distinct rows each;
    ``trow``: per distinct row, its row in the box, or -1 outside it."""
    fast: bool
    pre: bool
    knee: bool
    r: int
    h: int
    w: int
    sw: int
    step: int
    run: int
    depth: int
    hdepth: int
    win: int
    hwin: int
    seg_pitch: int
    gran: int
    smem: int
    ydist: np.ndarray    # (H,) distinct-row index of each row (equal y_map, equal index)
    ysrc: np.ndarray     # (ND,) source row of each distinct row
    segs: np.ndarray     # (strips, 3, 4) staged segments (a0, n0, a1, n1) per plane
    windows: np.ndarray  # (strips, 4) full-res columns [c0, c1), half-res [j0, j1]
    runtab: np.ndarray = None   # (runs, 3 + 2 * chunks): d_lo, d_hi, nh, then (he, ye) per chunk
    rowtab: np.ndarray = None   # (H, 4) fast / (H, 2r + 2) gaussian ring offsets
    halftab: np.ndarray = None  # (H2, 4) fast core: ring offsets of the half-res rows
    split: bool = False
    direct: bool = False
    grain: Optional[tuple] = None
    gwindows: np.ndarray = None  # (strips, 2) GRAW: raw columns [jr0, jr1] of each strip
    grawtab: np.ndarray = None   # (runs, 3 * chunks) GRAW: (g0, gn, rows) per chunk
    gdepth: int = 0
    gpitch: int = 0
    grows: int = 0
    text: tuple = ()
    trow: np.ndarray = None      # (ND,) TEXT: the box row of each distinct row, or -1

    @property
    def strips(self) -> int:
        return -(-self.w // self.sw)

    @property
    def runs(self) -> int:
        return -(-self.h // self.run)

    @property
    def key(self) -> tuple:
        """The plan_key of the specs this plan serves."""
        return (self.h, self.w, self.pre, self.fast, self.r, self.knee, self.direct, self.grain,
                self.text)


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def distinct_rows(y_map: np.ndarray, rows: tuple = ()) -> tuple[np.ndarray, np.ndarray]:
    """(ydist (H,), ysrc (ND,)): rows with the y_map entry of the row
    above share its distinct index, and ysrc holds each index's row.
    Each row of the range ``rows`` (y0, y1), the text box's, where the
    composite makes rows of one source row differ, is a distinct row of
    its own."""
    y = np.asarray(y_map, np.int64)
    new = np.ones(len(y), bool)
    new[1:] = y[1:] != y[:-1]
    if rows:
        new[rows[0]:rows[1] + 1] = True  # the box's rows and the row after it
    return (np.cumsum(new) - 1).astype(np.int32), y[new].astype(np.int32)


def strip_windows(w: int, sw: int, r: int, fast_taps=None) -> np.ndarray:
    """(strips, 4): the full-res columns [c0, c1) a strip's block reads
    and, for the fast core, the half-res columns [j0, j1] it computes
    (csrc/fused.cu computes the same at block start)."""
    x0 = np.arange(0, w, sw)
    xe = np.minimum(x0 + sw, w)
    if fast_taps is None:
        return np.stack([np.maximum(0, x0 - r), np.minimum(w, xe + r),
                         np.zeros_like(x0), np.full_like(x0, -1)], 1)
    fd_xlo, fu_xlo = np.asarray(fast_taps[2]), np.asarray(fast_taps[6])
    j0 = fu_xlo[x0]
    j1 = np.minimum(fu_xlo[xe - 1] + 1, len(fd_xlo) - 1)
    c0 = np.minimum(fd_xlo[j0], x0)
    c1 = np.maximum(np.minimum(fd_xlo[j1] + 1, w - 1), xe - 1) + 1
    return np.stack([c0, c1, j0, j1], 1)


def staged_segments(x_maps, windows: np.ndarray, pre: bool, gran: int):
    """Per strip and plane, the source columns the window reads as at
    most two ranges (a0, n0, a1, n1), starts and lengths aligned to
    ``gran`` elements: the aberration roll wraps (``% w``), so the
    window of the R and B planes at the frame's edges holds columns of
    the far edge. A map with more than one wrap gets one range over all
    its columns. Returns (segs, row pitch in elements)."""
    segs = np.zeros((len(windows), 3, 4), np.int32)
    for s, (c0, c1, _, _) in enumerate(windows):
        for p in range(3):
            v = np.asarray(x_maps[p][c0:c1], np.int64) if pre else np.arange(c0, c1)
            down = np.nonzero(np.diff(v) < 0)[0]
            parts = [v[:down[0] + 1], v[down[0] + 1:]] if len(down) == 1 else [v]
            for k, part in enumerate(parts):
                a0 = int(part.min()) // gran * gran
                segs[s, p, 2 * k:2 * k + 2] = a0, _round_up(int(part.max()) + 1 - a0, gran)
    return segs, _round_up(int((segs[..., 1] + segs[..., 3]).max()), 16)


def plan_chunks(plan: FusedPlan, y0: int, fast_taps=None) -> list:
    """Replay csrc/fused.cu's walk of the run that starts at output row
    y0: one tuple per chunk, (d, e, nh, he, nxt, ye, alive, halive):
    distinct source rows [d, e) produced, then half-res rows [nh, he)
    (fast core), then output rows [nxt, ye) written; ``alive`` and
    ``halive`` are the oldest distinct source row and half-res row still
    needed when the chunk starts (what the rings must keep)."""
    h, r, dist = plan.h, plan.r, plan.ydist
    y1 = min(y0 + plan.run, h)
    if plan.fast:
        fd_ylo, fu_ylo = np.asarray(fast_taps[0]), np.asarray(fast_taps[4])
        h2 = len(fd_ylo)
        i0, i1 = int(fu_ylo[y0]), min(int(fu_ylo[y1 - 1]) + 1, h2 - 1)
        pa = min(int(fd_ylo[i0]), y0)
        pb = max(min(int(fd_ylo[i1]) + 1, h - 1), y1 - 1)
    else:
        i0 = i1 = 0
        pa, pb = max(0, y0 - r), min(h - 1, y1 - 1 + r)
    d_hi = int(dist[pb]) + 1
    nh, nxt, chunks = i0, y0, []
    for d in range(int(dist[pa]), d_hi, plan.step):
        e = min(d + plan.step, d_hi)
        if plan.fast:
            alive = int(dist[nxt])
            if nh <= i1:
                alive = min(alive, int(dist[fd_ylo[nh]]))
            halive = int(fu_ylo[nxt])
            he = nh
            while he <= i1 and dist[min(fd_ylo[he] + 1, h - 1)] < e:
                he += 1
            ye = nxt
            while ye < y1 and min(fu_ylo[ye] + 1, h2 - 1) < he and dist[ye] < e:
                ye += 1
        else:
            alive, halive, he = int(dist[max(0, nxt - r)]), 0, nh
            ye = nxt
            while ye < y1 and dist[min(h - 1, ye + r)] < e:
                ye += 1
        chunks.append((d, e, nh, he, nxt, ye, alive, halive))
        nh, nxt = he, ye
    if nxt != y1:
        raise RuntimeError(f"fused plan: the walk of rows {y0}..{y1} stopped at {nxt}")
    return chunks


def plan_smem(fast: bool, pre: bool, r: int, sw: int, step: int, depth: int, hdepth: int,
              win: int, hwin: int, seg_pitch: int, knee: bool, direct: bool = False,
              graw: Optional[tuple] = None) -> int:
    """Shared memory of one block in bytes: csrc/fused.cu's smem_layout
    (the fast core without a knee reads the pre-knee strip from its
    knee'd ring; the direct-pow triad holds its pow sites' table,
    DIRECT_TAB floats, in place of the two LUTs; a radius above MAX_R adds
    its taps and border coefficients, 4r + 1 floats; ``graw``, the raw
    grain's (gdepth, gpitch, grows, gstride), adds the strip's column taps,
    the raw stage's two buffers and the run's raw schedule, at the end)."""
    def a16(n):
        return _round_up(n, 16)
    n = a16(2 * step * 3 * seg_pitch * (1 if pre else 4))  # staged rows, two buffers
    if fast:
        n += a16(depth * 3 * win * 4) + a16(hdepth * 3 * hwin * 4) + a16((hwin + sw) * 8)
    elif r > 0:
        n += a16(step * 3 * win * 4) + a16(depth * 3 * sw * 4)
    if not fast or knee:
        n += a16(depth * 3 * sw * 4)  # the pre-knee strip
    n += a16(3 * win * 2) + a16((win + 1) * 2) + a16(3 * win * 2)  # offsets, leaders
    luts = DIRECT_TAB if direct else 2 * 1028
    n += a16((luts + 4 * sw) * 4)  # triad tables, triad and vignette rows
    n += 64  # the strip's staged ranges
    if not fast and r > MAX_R:
        n += a16((4 * r + 1) * 4)  # the taps, edge_l and edge_r
    if graw:
        gdepth, gpitch, grows, gstride = graw
        n += a16(sw * 8)  # the strip's column taps (lo, frac)
        n += a16(2 * (gdepth * gpitch + 2 * grows) * 4)  # the raw stage, two buffers
        n += a16(gstride * 4)  # the run's grawtab row
    return n


def blocks_per_sm(smem: int) -> int:
    """Blocks of ``smem`` bytes of shared memory one SM holds at once."""
    return SMEM_SM // (smem + 1024)


def register_blocks(fast: bool, pre: bool, direct: bool, graw: bool) -> int:
    """Blocks per SM an instantiation's register cap leaves room for
    (csrc/fused.cu's __launch_bounds__: 64 registers a thread for the fast
    core, 80 for the gaussian one and for the fast core's direct-pow triad
    with the uint8 input, or with the raw grain)."""
    return 4 if fast and not (direct and (pre or graw)) else 3


def plan_key(spec: "FusedSpec") -> tuple:
    """What of a spec its plan is made for: (H, W, pre, fast core,
    gaussian radius, knee, direct-pow triad, raw grain: (grain size, gh,
    gw) or None, text box). Taps of one radius share a plan."""
    fast = bool(spec.bloom and spec.fast)
    graw = (spec.grain_size, *spec.grain_hw) if spec.noise and spec.grain_size > 1 else None
    return (spec.h, spec.w, bool(spec.pre), fast, spec.r if spec.bloom and not fast else 0,
            bool(spec.bloom and spec.threshold > 0.0), triad_mode(spec) == 3, graw,
            spec.text_box)


def grain_windows(w: int, sw: int, gxlo: np.ndarray) -> np.ndarray:
    """(strips, 2): the raw grain columns [jr0, jr1] a strip stages, each
    output's lo tap and lo + 1 (the oracle's column taps rise with the
    column; lo + 1 is the hi tap but where the field is one column wide,
    and the stage holds column 0 there; csrc/fused.cu computes the same at
    block start)."""
    x0 = np.arange(0, w, sw)
    xe = np.minimum(x0 + sw, w)
    return np.stack([gxlo[x0], gxlo[xe - 1] + 1], 1).astype(np.int64)


def grain_stage(chunks, gylo: np.ndarray) -> list:
    """Per chunk of a run, what the raw stage holds for its output rows
    [nxt, ye): (first raw row, raw rows, output rows), the raw rows
    gylo[nxt] .. gylo[ye - 1] + 1 (each lo tap and lo + 1, as the
    columns); (0, 0, 0) where the chunk completes no row."""
    return [(int(gylo[nxt]), int(gylo[ye - 1]) + 2 - int(gylo[nxt]), ye - nxt) if ye > nxt
            else (0, 0, 0) for _, _, _, _, nxt, ye, _, _ in chunks]


def fused_plan(spec: "FusedSpec", y_map, x_maps, fast_taps=None) -> FusedPlan:
    """The kernel's walk for ``spec`` over the index maps it is given
    (``fast_taps``: the numpy bilinear_taps of fast_tables): the widest
    strip of STRIP_WIDTHS whose block fits in shared memory, and the ring
    depths the walk needs (never more than the frame's distinct rows);
    chunk and run sizes from WALK. Past MAX_R the widest strip of at least
    BIG_MIN_SW columns that leaves room for two blocks per SM is taken
    where there is one, and where WALK's "big" chunk fits no strip the
    gaussian one is tried. With the raw grain, where its stage leaves
    fewer blocks per SM than the first walk's block at grain size 1, the
    first of GRAW_STEPS' shorter chunks that gives them back is taken (else
    that first walk). A plan that fits no strip is ``split``."""
    h, w, _, fast, r, knee, direct, grain, text = plan_key(spec)
    if grain:
        gylo = oracle.ops.bilinear_taps(grain[1], h)[0]
        gxlo = oracle.ops.bilinear_taps(grain[2], w)[0]
    if spec.pre:
        ydist, ysrc = distinct_rows(y_map, text[:2])
        gran = 16 if w % 16 == 0 else 4 if w % 4 == 0 else 1
    else:
        ydist = ysrc = np.arange(h, dtype=np.int32)
        gran = 4 if w % 4 == 0 else 1
    # WALK's key: past MAX_R the kernel blocks its taps (csrc/fused.cu BIG)
    core = "fast" if fast else "big" if r > MAX_R else "gaussian"
    walks = [WALK[core, bool(spec.pre)]]
    if core == "big":  # the gaussian chunk where the big one fits no strip: no earlier split
        walks.append(WALK["gaussian", bool(spec.pre)])
    if grain:  # shorter chunks where the raw stage costs blocks per SM (GRAW_STEPS)
        walks += [(s, walks[0][1]) for s in GRAW_STEPS if s < walks[0][0]]
    # the first walk that fits, and the blocks per SM of its block at grain
    # size 1, which a shorter chunk must give back where the raw stage costs
    first = target = None
    for step, run in walks:
        run = min(run, h)
        plan = FusedPlan(fast, bool(spec.pre), knee, r, h, w, 0, step, run, 0, 0, 0, 0, 0, gran,
                         0, ydist, ysrc, np.zeros((0, 3, 4), np.int32),
                         np.zeros((0, 4), np.int64), direct=direct, grain=grain, text=text)
        depth = hdepth = 1
        gdepth = grows = 0
        sched, gsched = [], []
        for y0 in range(0, h, run):
            chunks = plan_chunks(plan, y0, fast_taps)
            sched.append([chunks[0][0], chunks[-1][1], chunks[0][2]]
                         + [v for c in chunks for v in (c[3], c[5])])
            for d, e, nh, he, nxt, ye, alive, halive in chunks:
                depth = max(depth, e - alive)
                hdepth = max(hdepth, he - halive)
            if grain:
                gsched.append([v for c in grain_stage(chunks, gylo) for v in c])
                gdepth = max(gdepth, *gsched[-1][1::3])
                grows = max(grows, *gsched[-1][2::3])
        depth = min(depth, len(ysrc))  # a ring of every distinct row never evicts one
        fits = None
        for cand in STRIP_WIDTHS:
            windows = strip_windows(w, cand, r, fast_taps if fast else None)
            segs, pitch = staged_segments(x_maps, windows, spec.pre, gran)
            # the fast core shifts its window by up to 3 columns (csrc/fused.cu ksh)
            win = _round_up(int((windows[:, 1] - windows[:, 0]).max()) + 3 * fast, 4)
            hwin = _round_up(int((windows[:, 3] - windows[:, 2] + 1).max()), 4) if fast else 0
            gwin = graw = None
            if grain:
                gwin = grain_windows(w, cand, gxlo)
                graw = (gdepth, int((gwin[:, 1] - gwin[:, 0] + 1).max()), grows,
                        max(map(len, gsched)))
            smem = plan_smem(fast, spec.pre, r, cand, step, depth, hdepth, win, hwin, pitch,
                             knee, direct, graw)
            if smem > SMEM_MAX:
                continue
            this = (cand, windows, segs, pitch, win, hwin, smem, gwin, graw)
            fits = fits or this  # the widest strip that fits
            if core != "big" or (cand >= BIG_MIN_SW and blocks_per_sm(smem) >= 2):
                fits = this
                break
        if fits:
            walk = (plan, depth, hdepth, sched, gsched, fits)
            if first is None:
                first, target = walk, min(blocks_per_sm(plan_smem(
                    fast, spec.pre, r, fits[0], step, depth, hdepth, fits[4], fits[5], fits[3],
                    knee, direct)), register_blocks(fast, spec.pre, direct, False))
            if not grain or min(blocks_per_sm(fits[6]),
                                register_blocks(fast, spec.pre, direct, True)) >= target:
                break
    else:
        if first is None:
            plan.split, plan.depth, plan.hdepth = True, depth, hdepth
            return plan
        walk = first
    plan, depth, hdepth, sched, gsched, fits = walk
    cand, windows, segs, pitch, win, hwin, smem, gwin, graw = fits
    plan.sw, plan.depth, plan.hdepth, plan.win, plan.hwin = cand, depth, hdepth, win, hwin
    plan.seg_pitch, plan.smem, plan.segs, plan.windows = pitch, smem, segs, windows
    plan.runtab = _pad_rows(sched)
    plan.grawtab = np.zeros((1, 3), np.int32)
    if graw:
        plan.gwindows, (plan.gdepth, plan.gpitch, plan.grows, _) = gwin, graw
        plan.grawtab = _pad_rows(gsched)
    plan.rowtab, plan.halftab = _ring_tables(plan, fast_taps)
    if text:
        plan.trow = np.full(len(ysrc), -1, np.int32)
        plan.trow[ydist[text[0]:text[1]]] = np.arange(text[1] - text[0])
    return plan


def _pad_rows(rows: list) -> np.ndarray:
    """Rows of ints as one int32 table, each padded with zeros."""
    out = np.zeros((len(rows), max(map(len, rows))), np.int32)
    for i, row in enumerate(rows):
        out[i, :len(row)] = row
    return out


def _ring_tables(plan: FusedPlan, fast_taps) -> tuple:
    """Per output row, the ring offsets (in floats) of its operands: the
    fast core's pre-knee strip row, its two half-res rows and its up-row
    fraction's bits; the gaussian core's pre-knee strip row and each
    tap's filtered row (clamped to the frame: rows 0 and H - 1 are also
    the border fold's samples). Per half-res row (fast core), its two
    source rows' offsets in the knee'd ring (less the strip's first
    window column), its own slot and its down-row fraction's bits. The
    fast core without a knee reads the pre-knee strip from its knee'd
    ring (the same values)."""
    h, r, dist = plan.h, plan.r, plan.ydist.astype(np.int64)
    y = np.arange(h)
    # the pre-knee strip: its own ring, or the fast core's knee'd ring
    pitch = plan.win if plan.fast and not plan.knee else plan.sw
    strip = dist % plan.depth * 3 * pitch
    if not plan.fast:
        taps = [dist[np.clip(y + k - r, 0, h - 1)] % plan.depth * 3 * plan.sw
                for k in range(2 * r + 1)]
        return np.stack([strip, *taps], 1).astype(np.int32), np.zeros((1, 4), np.int32)
    fd_ylo, fd_yf, fu_ylo, fu_yf = (np.asarray(fast_taps[i]) for i in (0, 1, 4, 5))
    h2 = len(fd_ylo)
    ulo = fu_ylo.astype(np.int64)
    rows = np.stack([strip, ulo % plan.hdepth * 3 * plan.hwin,
                     np.minimum(ulo + 1, h2 - 1) % plan.hdepth * 3 * plan.hwin,
                     fu_yf.astype(np.float32).view(np.int32)], 1)
    lo = fd_ylo.astype(np.int64)
    half = np.stack([dist[lo] % plan.depth * 3 * plan.win,
                     dist[np.minimum(lo + 1, h - 1)] % plan.depth * 3 * plan.win,
                     np.arange(h2) % plan.hdepth * 3 * plan.hwin,
                     fd_yf.astype(np.float32).view(np.int32)], 1)
    return rows.astype(np.int32), half.astype(np.int32)


def fast_tables(h: int, w: int) -> tuple:
    """The fast core's taps, the oracle's resize_bilinear to (H//2, W//2)
    and back (oracle/engine.py apply_effects, stage 6): (lo int32, frac
    f32) for the down rows, down columns, up rows and up columns."""
    h2, w2 = max(1, h // 2), max(1, w // 2)
    return (*oracle.ops.bilinear_taps(h, h2), *oracle.ops.bilinear_taps(w, w2),
            *oracle.ops.bilinear_taps(h2, h), *oracle.ops.bilinear_taps(w2, w))


def fused_consts(spec: FusedSpec, device="cpu", y_map=None, x_maps=None) -> FusedConsts:
    """The spec's device tables and the kernel's plan, over the given
    index maps ((H,) and (3, W) in plane order; by default the spec's
    own plane_index_maps)."""
    if y_map is None:
        y_map, x_maps = oresize.plane_index_maps(spec.h, spec.w, spec.px, spec.ab, spec.corder)
    y_map, x_maps = (np.ascontiguousarray(torch.as_tensor(m).cpu().numpy(), np.int32)
                     for m in (y_map, x_maps))
    fwd = fin = None
    if triad_mode(spec) == 2:
        fwd, fin = ocolor.triad_tables(spec.triad_gamma, device)
    taps = None
    if spec.bloom and spec.fast:
        taps = fast_tables(spec.h, spec.w)
    plan = fused_plan(spec, y_map, x_maps, taps)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32 if a.dtype.kind == "i"
                                                     else np.float32)).to(device)
    tapdev = split = grain_taps = None
    if spec.noise and spec.grain_size > 1:
        gh, gw = spec.grain_hw
        grain_taps = tuple(dev(a) for a in (*oracle.ops.bilinear_taps(gh, spec.h),
                                             *oracle.ops.bilinear_taps(gw, spec.w)))
    if plan.split:
        split = _split_route(spec, device, y_map, x_maps)
    elif plan.r > MAX_R:
        left, right = oblur.edge_coefs(spec.taps)
        tapdev = dev(np.concatenate([np.asarray(spec.taps, np.float32), left, right]))
    return FusedConsts(dev(y_map), dev(x_maps), fwd, fin,
                       None if taps is None else tuple(dev(a) for a in taps),
                       plan, plan_tables(plan, device), tapdev, split, grain_taps)


def _split_route(spec: FusedSpec, device, y_map, x_maps) -> tuple:
    """The three launches of a spec whose plan fits no block: the
    prologue alone (stages 1-4, f32 out; none when the input is already
    the f32 image), the stand-alone gaussian bloom (kernels/bloom3.py),
    and the epilogue on the f32 image (stages 7-11, the spec's emit). The
    specs and consts of the two fused launches, and the bloom's spec."""
    from .bloom3 import Bloom3Spec  # bloom3 imports this module

    none = dict(bloom=False, taps=(), fast=False, strength=0.0, threshold=0.0)
    pre = pre_consts = None
    if spec.pre:
        pre = dataclasses.replace(spec, **none, triad=False, scanlines=False, vignette=False,
                                  flicker=False, noise=False, emit="f32")
        pre_consts = fused_consts(pre, device, y_map, x_maps)
    post = dataclasses.replace(spec, **none, pre=False, text_box=())
    bloom = Bloom3Spec(h=spec.h, w=spec.w, taps=spec.taps, strength=spec.strength,
                       threshold=spec.threshold)
    return pre, pre_consts, bloom, post, fused_consts(post, device, y_map, x_maps)


def check_plan(spec: FusedSpec, consts: FusedConsts) -> FusedPlan:
    """The plan of ``consts``, if it was made for ``spec`` (plan_key):
    the kernel sizes its rings, tables and shared memory by the plan and
    its taps and knee by the spec, so the two must agree."""
    plan = consts.plan
    if plan is None or plan.key != plan_key(spec):
        raise ValueError("fused_pipeline: consts.plan was not made for this spec "
                         f"({None if plan is None else plan.key} vs {plan_key(spec)}); "
                         "build consts with fused_consts(spec)")
    return plan


def plan_tables(plan: FusedPlan, device) -> tuple:
    """The plan's device tables: ysrc, segs, runtab, rowtab, halftab,
    grawtab, and trow with a text box (none for a split plan)."""
    if plan.split:
        return ()
    return tuple(torch.from_numpy(np.ascontiguousarray(t, np.int32)).to(device)
                 for t in (plan.ysrc, plan.segs, plan.runtab, plan.rowtab, plan.halftab,
                           plan.grawtab, plan.trow) if t is not None)


def knee_consts(threshold: float) -> tuple[np.float32, np.float32]:
    # multiply by the rounded reciprocal, as the JAX kernel does
    thr = np.float32(min(0.99, max(0.0, threshold)))
    den = np.float32(max(1e-6, 1.0 - float(thr)))
    return thr, np.float32(1.0 / float(den))


def prologue_ref(img: torch.Tensor, spec: FusedSpec, consts: FusedConsts) -> torch.Tensor:
    """Stages 1-4 on (B, 3, H, W) uint8: the composed index maps, a
    multiply by f32(1/255), the grade."""
    s = spec
    x = oresize.remap_planes(img, consts.y_map, consts.x_maps).float() * np.float32(1.0 / 255.0)
    return ocolor.grade(x, s.saturation, s.temp_r, s.temp_b, s.brightness, s.contrast,
                        s.inv_gamma, s.corder, dim=1)


def bloom_core_ref(x: torch.Tensor, strength: float, threshold: float, *, taps=(),
                   fast_taps: Optional[tuple] = None) -> torch.Tensor:
    """clip(x + strength * blur(knee(x))) over the last two axes: the
    gaussian ``taps``, or with ``fast_taps`` (the oracle's bilinear_taps
    for the down rows, down columns, up rows and up columns, lo int32
    and frac f32) the half-res down and up. The fused kernel's stage 6
    and the stand-alone bloom (kernels/bloom3.py) share it."""
    src = x
    if threshold > 0.0:
        thr, rden = knee_consts(threshold)
        src = torch.clamp((x - thr) * rden, 0.0, 1.0)
    if fast_taps is not None:
        t = [a.long() if i % 2 == 0 else a for i, a in enumerate(fast_taps)]
        bl = oresize.resize_bilinear(oresize.resize_bilinear(src, *t[:4]), *t[4:])
    else:
        bl = oblur.gaussian_blur_replicate(src, taps)
    return torch.clamp(x + np.float32(strength) * bl, 0.0, 1.0)


def bloom_ref(x: torch.Tensor, spec: FusedSpec, consts: FusedConsts) -> torch.Tensor:
    """Stage 6 with the spec's core (the identity when the bloom is off)."""
    if not spec.bloom:
        return x
    return bloom_core_ref(x, spec.strength, spec.threshold, taps=spec.taps,
                          fast_taps=consts.fast_taps if spec.fast else None)


def epilogue_ref(m: torch.Tensor, spec: FusedSpec, consts: FusedConsts, *,
                 grain=None, sl=None, vy2=None, vx2=None, tri=None,
                 flicker=None) -> torch.Tensor:
    """Stages 7-11 and the emit. ``sl`` is the kernel's (B, H) scanline
    multiplier or, in the engine's staged step, the (B, H, W) 2-D mask;
    ``grain`` the (B, gh, gw) field (spec.grain_hw), upsampled here with
    the oracle's taps when the grain size is above 1."""
    s = spec
    if s.triad:
        m = ocolor.apply_triad_planar(m, tri, s.triad_gamma, s.triad_luma, s.corder,
                                      tables=(consts.lut_fwd, consts.lut_fin),
                                      lut_exact=s.lut_exact)
    if s.scanlines:
        m = torch.clamp(m * (sl[:, None, :, None] if sl.ndim == 2 else sl[:, None]), 0.0, 1.0)
    if s.vignette:
        r2 = vy2[:, None] + vx2[None, :]
        v = np.float32(1.0) - np.float32(s.vig_strength) * torch.clamp(r2, 0.0, 1.0)
        m = torch.clamp(m * v, 0.0, 1.0)
    if s.flicker:
        m = torch.clamp(m * flicker[:, None, None, None], 0.0, 1.0)
    if s.noise:
        if s.grain_size > 1:
            t = consts.grain_taps
            grain = oresize.resize_bilinear(grain, t[0].long(), t[1], t[2].long(), t[3])
        m = torch.clamp(m + (grain * np.float32(s.noise_scale))[:, None], 0.0, 1.0)
    return ocolor.to_uint8(m) if s.emit == "u8" else m


def text_ref(x: torch.Tensor, spec: FusedSpec, talpha: torch.Tensor,
             trgb: torch.Tensor) -> torch.Tensor:
    """Stage 5 in place on the prologue's (B, 3, H, W) f32 output: the
    text composited over the spec's box (kernels/text.py's box twin), from
    its alpha (bh, bw) and colour (3, bh, bw) there; outside the box the
    composite is the identity (alpha 0)."""
    return ktext.composite_box_ref(x, ktext.TextBox(spec.text_box, talpha, trgb), False)


def fused_pipeline_ref(img: torch.Tensor, spec: FusedSpec, consts: FusedConsts, *,
                       grain=None, sl=None, vy2=None, vx2=None, tri=None,
                       flicker=None, talpha=None, trgb=None) -> torch.Tensor:
    """The fused kernel's plain PyTorch twin, on any device."""
    x = prologue_ref(img, spec, consts) if spec.pre else img
    if spec.text_box:
        x = text_ref(x, spec, talpha, trgb)
    return epilogue_ref(bloom_ref(x, spec, consts), spec, consts, grain=grain, sl=sl,
                        vy2=vy2, vx2=vx2, tri=tri, flicker=flicker)


class _FusedArgs(ctypes.Structure):
    """Mirror of FusedArgs in csrc/fused.cu (checked by size at launch)."""
    _fields_ = [
        ("img", ctypes.c_void_p), ("imgf", ctypes.c_void_p), ("out", ctypes.c_void_p),
        ("xmap", ctypes.c_void_p),
        ("grain", ctypes.c_void_p), ("sl", ctypes.c_void_p),
        ("vy2", ctypes.c_void_p), ("vx2", ctypes.c_void_p),
        ("tri", ctypes.c_void_p), ("flicker", ctypes.c_void_p),
        ("lut_fwd", ctypes.c_void_p), ("lut_fin", ctypes.c_void_p),
        ("fd_ylo", ctypes.c_void_p), ("fd_yf", ctypes.c_void_p),
        ("fd_xlo", ctypes.c_void_p), ("fd_xf", ctypes.c_void_p),
        ("fu_ylo", ctypes.c_void_p), ("fu_yf", ctypes.c_void_p),
        ("fu_xlo", ctypes.c_void_p), ("fu_xf", ctypes.c_void_p),
        ("ysrc", ctypes.c_void_p), ("segs", ctypes.c_void_p), ("runtab", ctypes.c_void_p),
        ("rowtab", ctypes.c_void_p), ("halftab", ctypes.c_void_p),
        ("tapdev", ctypes.c_void_p),
        ("b", ctypes.c_int32), ("h", ctypes.c_int32), ("w", ctypes.c_int32),
        ("emit_u8", ctypes.c_int32), ("pre_on", ctypes.c_int32),
        ("inv255", ctypes.c_float),
        ("sat_on", ctypes.c_int32), ("sat", ctypes.c_float),
        ("temp_on", ctypes.c_int32), ("gain", ctypes.c_float * 3),
        ("bc_on", ctypes.c_int32), ("brightness", ctypes.c_float),
        ("contrast", ctypes.c_float),
        ("gamma_on", ctypes.c_int32), ("inv_gamma", ctypes.c_float),
        ("ir", ctypes.c_int32), ("ig", ctypes.c_int32), ("ib", ctypes.c_int32),
        ("bloom_on", ctypes.c_int32), ("r", ctypes.c_int32),
        ("knee_on", ctypes.c_int32), ("thr", ctypes.c_float), ("rden", ctypes.c_float),
        ("strength", ctypes.c_float),
        ("taps", ctypes.c_float * MAX_TAPS),
        ("edge_l", ctypes.c_float * MAX_TAPS),
        ("edge_r", ctypes.c_float * MAX_TAPS),
        ("fast_on", ctypes.c_int32), ("h2", ctypes.c_int32), ("w2", ctypes.c_int32),
        ("sw", ctypes.c_int32), ("step", ctypes.c_int32), ("run", ctypes.c_int32),
        ("depth", ctypes.c_int32), ("hdepth", ctypes.c_int32),
        ("win", ctypes.c_int32), ("hwin", ctypes.c_int32),
        ("seg_pitch", ctypes.c_int32), ("copy_bytes", ctypes.c_int32),
        ("run_stride", ctypes.c_int32),
        ("vec_ok", ctypes.c_int32), ("smem", ctypes.c_int32),
        ("triad_mode", ctypes.c_int32), ("luma_on", ctypes.c_int32),
        ("sl_on", ctypes.c_int32), ("vig_on", ctypes.c_int32),
        ("vig_strength", ctypes.c_float),
        ("flicker_on", ctypes.c_int32),
        ("noise_on", ctypes.c_int32), ("noise_scale", ctypes.c_float),
        ("tri_g", ctypes.c_float), ("tri_e", ctypes.c_float),
        ("gylo", ctypes.c_void_p), ("gyf", ctypes.c_void_p),
        ("gxlo", ctypes.c_void_p), ("gxf", ctypes.c_void_p),
        ("grain_raw", ctypes.c_int32), ("gh", ctypes.c_int32), ("gw", ctypes.c_int32),
        ("gdepth", ctypes.c_int32), ("gpitch", ctypes.c_int32), ("grows", ctypes.c_int32),
        ("grawtab", ctypes.c_void_p), ("gstride", ctypes.c_int32),
        ("trow", ctypes.c_void_p), ("talpha", ctypes.c_void_p), ("trgb", ctypes.c_void_p),
        ("text_on", ctypes.c_int32), ("tx0", ctypes.c_int32), ("th", ctypes.c_int32),
        ("tw", ctypes.c_int32),
    ]


def _check(name: str, t, shape, dtype, device) -> int:
    """Validate one operand for the kernel and return its pointer."""
    if t is None:
        raise ValueError(f"fused_pipeline: operand {name} is required by the spec")
    if t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError(
            f"fused_pipeline: {name} must be a contiguous {dtype} {tuple(shape)} "
            f"tensor on {device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    return t.data_ptr()


def _static_args(s: FusedSpec, consts: FusedConsts, dev) -> _FusedArgs:
    """The kernel arguments that follow from the spec and its consts
    alone (the plan, the tables, the grade, bloom and epilogue fields),
    each operand checked."""
    a = _FusedArgs()
    plan = check_plan(s, consts)
    a.xmap = _check("x_maps", consts.x_maps, (3, s.w), torch.int32, dev)
    a.ysrc, a.segs, a.runtab, a.rowtab, a.halftab, a.grawtab = (
        _check(n, t, tuple(ref.shape), torch.int32, dev) for n, t, ref in zip(
            ("ysrc", "segs", "runtab", "rowtab", "halftab", "grawtab"), consts.plan_tables,
            (plan.ysrc, plan.segs, plan.runtab, plan.rowtab, plan.halftab, plan.grawtab)))
    a.triad_mode = triad_mode(s)
    if a.triad_mode == 2:
        a.lut_fwd = _check("lut_fwd", consts.lut_fwd, (1025,), torch.float32, dev)
        a.lut_fin = _check("lut_fin", consts.lut_fin, (1025,), torch.float32, dev)
    if a.triad_mode == 3:  # the exponents as ops/color.py's powf_rn and pow_final round them
        a.tri_g = np.float32(s.triad_gamma)
        a.tri_e = np.float32(1.0 / float(s.triad_gamma))
    a.luma_on = int(s.triad and s.triad_luma)
    a.h, a.w = s.h, s.w
    a.emit_u8 = int(s.emit == "u8")
    a.pre_on = int(s.pre)
    a.inv255 = np.float32(1.0 / 255.0)
    a.sat_on, a.sat = int(s.saturation != 1.0), np.float32(s.saturation)
    a.temp_on = int(s.temp_r != 1.0 or s.temp_b != 1.0)
    by_color = (s.temp_r, 1.0, s.temp_b)
    a.gain[:] = [float(np.float32(by_color[c])) for c in s.corder]
    a.bc_on = int(s.brightness != 0.0 or s.contrast != 1.0)
    a.brightness, a.contrast = np.float32(s.brightness), np.float32(s.contrast)
    a.gamma_on, a.inv_gamma = int(s.inv_gamma != 1.0), np.float32(s.inv_gamma)
    a.ir, a.ig, a.ib = (s.corder.index(c) for c in range(3))
    a.bloom_on, a.r = int(s.bloom), s.r if s.bloom else 0
    a.knee_on = int(s.bloom and s.threshold > 0.0)
    if a.knee_on:
        a.thr, a.rden = knee_consts(s.threshold)
    a.strength = np.float32(s.strength)
    if s.bloom and s.fast:
        a.fast_on = 1
        a.h2, a.w2 = max(1, s.h // 2), max(1, s.w // 2)
        names = ("fd_ylo", "fd_yf", "fd_xlo", "fd_xf", "fu_ylo", "fu_yf", "fu_xlo", "fu_xf")
        lens = (a.h2, a.h2, a.w2, a.w2, s.h, s.h, s.w, s.w)
        for i, (name, n) in enumerate(zip(names, lens)):
            setattr(a, name, _check(name, consts.fast_taps[i], (n,),
                                    torch.int32 if i % 2 == 0 else torch.float32, dev))
    elif s.bloom and s.r > MAX_R:
        a.tapdev = _check("tapdev", consts.tapdev, (4 * s.r + 1,), torch.float32, dev)
    elif s.bloom:
        left, right = oblur.edge_coefs(s.taps)
        a.taps[:len(s.taps)] = [float(np.float32(t)) for t in s.taps]
        a.edge_l[:len(left)] = [float(v) for v in left]
        a.edge_r[:len(right)] = [float(v) for v in right]
    a.sl_on, a.vig_on = int(s.scanlines), int(s.vignette)
    a.vig_strength = np.float32(s.vig_strength)
    a.flicker_on = int(s.flicker)
    a.noise_on, a.noise_scale = int(s.noise), np.float32(s.noise_scale)
    a.gh, a.gw = s.grain_hw
    if s.noise and s.grain_size > 1:
        if consts.grain_taps is None:
            raise ValueError("fused_pipeline: consts.grain_taps are required by the spec's "
                             "grain size; build consts with fused_consts(spec)")
        a.grain_raw = 1
        a.gdepth, a.gpitch, a.grows = plan.gdepth, plan.gpitch, plan.grows
        a.gstride = plan.grawtab.shape[1]
        a.gylo, a.gyf, a.gxlo, a.gxf = (
            _check(n, t, (k,), dt, dev) for n, t, k, dt in zip(
                ("gylo", "gyf", "gxlo", "gxf"), consts.grain_taps, (s.h, s.h, s.w, s.w),
                (torch.int32, torch.float32, torch.int32, torch.float32)))
    if s.text_box:
        y0, y1, a.tx0, x1 = s.text_box
        a.text_on, a.th, a.tw = 1, y1 - y0, x1 - a.tx0
        a.trow = _check("trow", consts.plan_tables[6], plan.trow.shape, torch.int32, dev)
    a.sw, a.step, a.run = plan.sw, plan.step, plan.run
    a.depth, a.hdepth, a.win, a.hwin = plan.depth, plan.hdepth, plan.win, plan.hwin
    a.seg_pitch, a.smem = plan.seg_pitch, plan.smem
    a.run_stride = plan.runtab.shape[1]
    return a


STATIC_CACHE = 16  # (spec, consts, device) triples whose static arguments are kept
_static: dict = {}  # (id(spec), id(consts), device) -> (spec, consts, _FusedArgs)


def static_args(spec: FusedSpec, consts: FusedConsts, dev) -> _FusedArgs:
    """A copy of _static_args for (spec, consts, device), built once and
    kept (an entry holds its spec and consts, so their ids stay theirs
    while it lives): a call checks and fills only its own operands."""
    key = (id(spec), id(consts), dev)
    hit = _static.get(key)
    if hit is None:
        if len(_static) >= STATIC_CACHE:
            _static.pop(next(iter(_static)))  # the oldest
        hit = _static[key] = (spec, consts, _static_args(spec, consts, dev))
    return _FusedArgs.from_buffer_copy(hit[2])


def fused_pipeline(img: torch.Tensor, spec: FusedSpec, consts: FusedConsts, *,
                   grain=None, sl=None, vy2=None, vx2=None, tri=None,
                   flicker=None, talpha=None, trgb=None, out=None) -> torch.Tensor:
    """Run stages 1-11.

    img: (B, 3, H, W) uint8 planar frames, plane i holding colour
    spec.corder[i], or the f32 image after stages 1-5 when spec.pre is
    False. grain: (B, H, W) f32 unscaled noise field [noise];
    sl: (B, H) f32 scanline multiplier [scanlines]; vy2/vx2: (H,)/(W,)
    f32 vignette vectors [vignette]; tri: (3, W) f32 triad rows in plane
    order [triad]; flicker: (B,) f32 [flicker]; talpha/trgb: (bh, bw)/(3,
    bh, bw) f32 text alpha and colour over spec.text_box, in plane order
    [text box]. With spec.grain_size above
    1, grain is the raw (B, gh, gw) field (spec.grain_hw), upsampled by
    the kernel. Returns (B, 3, H, W)
    f32 in [0, 1], or uint8 when spec.emit == "u8", written into ``out``
    when given.

    CPU tensors run the plain twin; CUDA tensors launch the kernel.
    """
    global launches
    if img.device.type == "cpu":
        return into(out, fused_pipeline_ref(img, spec, consts, grain=grain, sl=sl, vy2=vy2,
                                            vx2=vx2, tri=tri, flicker=flicker, talpha=talpha,
                                            trgb=trgb))
    if img.device.type != "cuda":
        raise ValueError(f"fused_pipeline: unsupported device {img.device}")
    if consts.plan is not None and consts.plan.split:
        check_plan(spec, consts)
        return _split_pipeline(img, spec, consts, grain=grain, sl=sl, vy2=vy2, vx2=vx2,
                               tri=tri, flicker=flicker, talpha=talpha, trgb=trgb, out=out)
    s = spec
    b = img.shape[0]
    dev = img.device
    a = static_args(s, consts, dev)
    if s.pre:
        a.img = _check("img", img, (b, 3, s.h, s.w), torch.uint8, dev)
    else:
        a.imgf = _check("img", img, (b, 3, s.h, s.w), torch.float32, dev)
    if s.noise:
        a.grain = _check("grain", grain, (b, *s.grain_hw), torch.float32, dev)
    if s.scanlines:
        a.sl = _check("sl", sl, (b, s.h), torch.float32, dev)
    if s.vignette:
        a.vy2 = _check("vy2", vy2, (s.h,), torch.float32, dev)
        a.vx2 = _check("vx2", vx2, (s.w,), torch.float32, dev)
    if s.flicker:
        a.flicker = _check("flicker", flicker, (b,), torch.float32, dev)
    if s.triad:
        a.tri = _check("tri", tri, (3, s.w), torch.float32, dev)
    if s.text_box:
        a.talpha = _check("talpha", talpha, (a.th, a.tw), torch.float32, dev)
        a.trgb = _check("trgb", trgb, (3, a.th, a.tw), torch.float32, dev)
    out = dest(out, (b, 3, s.h, s.w), torch.uint8 if s.emit == "u8" else torch.float32, dev,
               "fused_pipeline")
    a.out = out.data_ptr()
    a.b = b
    # staged copies of gran elements where the frame pointer allows them
    gb = consts.plan.gran * (1 if s.pre else 4)
    ptr = a.img if s.pre else a.imgf
    a.copy_bytes = gb if ptr % gb == 0 else (4 if gb >= 4 and ptr % 4 == 0 else 1)
    # four values per thread for the stores and the full-size grain's loads
    grain = a.grain if not a.grain_raw else None
    a.vec_ok = int(s.w % 4 == 0 and all(p % 16 == 0 for p in (a.out, grain) if p))
    _build.launch("crt_fused_launch", a, dev)
    launches += 1
    return out


def _split_pipeline(img: torch.Tensor, spec: FusedSpec, consts: FusedConsts, *, talpha,
                    trgb, **operands) -> torch.Tensor:
    """A split plan's chain (fused_consts): the fused kernel's prologue
    (with the text composite), the stand-alone bloom, the fused kernel's
    epilogue. Each launch counts in its own module."""
    from .bloom3 import bloom3_planar  # bloom3 imports this module

    pre, pre_consts, bloom, post, post_consts = consts.split
    x = (fused_pipeline(img, pre, pre_consts, talpha=talpha, trgb=trgb) if pre is not None
         else img)
    return fused_pipeline(bloom3_planar(x, bloom), post, post_consts, **operands)
