"""Stages 1-11 in one pass: the CUDA fused kernel and its plain twin.

Port of pythoncrt_tpu/kernels/fused.py (fused_pipeline / _fused_kernel):

  u8 planar frame --gather through the pixelate/aberration maps-->
  /255 -> grade -> knee -> bloom core -> composite -> triad ->
  scanlines -> vignette -> flicker -> grain -> f32 or uint8

The bloom core is the exact gaussian (H then V), the fast half-res
down+up (the oracle's resize_bilinear twice, driven by its bilinear_taps
tables), or off. With ``spec.pre`` False (the JAX kernel's ``pre=False``,
text composited before the bloom) the input is the engine's f32 image
after stages 1-5 and the kernel starts at the knee.

The twin is split at the bloom (``prologue_ref``, ``bloom_ref``,
``epilogue_ref``) so that the engine's staged step, which runs the
stand-alone bloom kernel between them, shares its op order.

``fused_pipeline`` launches csrc/fused.cu for CUDA tensors and runs
``fused_pipeline_ref`` (plain PyTorch, the same op order) for CPU
tensors. The spec keeps the JAX kernel's parameter names; the TPU's
stripe height, VMEM sizing and pixel-size/shape gates have no
counterpart here (the CUDA kernel takes any H, W and pixel size).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import oracle
from ..ops import blur as oblur
from ..ops import color as ocolor
from ..ops import resize as oresize
from . import _build

launches = 0  # CUDA launches made by fused_pipeline

MAX_TAPS = 63  # csrc/fused.cu MAXK
TILE = 32  # csrc/fused.cu TX, TY: the output tile of one block


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
    scanlines: bool = False
    vignette: bool = False
    vig_strength: float = 0.0
    flicker: bool = False
    noise: bool = False
    noise_scale: float = 0.0
    emit: str = "f32"  # "f32" [0, 1] or "u8" clip(rint(x * 255))
    corder: tuple = (0, 1, 2)  # plane i holds colour corder[i]

    @property
    def r(self) -> int:
        return len(self.taps) // 2


def build_fused_spec(h: int, w: int, *, sigma: float = 0.0, strength: float = 0.0,
                     threshold: float = 0.0, fast: bool = False, bloom: bool = True,
                     pre: bool = True, lut_exact: bool = True, **kw) -> FusedSpec:
    """Build a spec from the arguments of the JAX package's
    build_fused_spec (kernels/fused.py:168). ``pre`` False takes the f32
    image (the prologue's fields then describe the caller's prologue);
    the triad is always LUT-exact. Any H and W: the TPU kernel's shape
    gates (H%8, W%128, even sizes for the fast core) have no
    counterpart."""
    if not lut_exact:
        raise NotImplementedError(
            "the port's fused kernel always runs the LUT-exact triad "
            "(precision fast: ROADMAP.md queue 1, precision fast)")
    if kw.get("emit", "f32") not in ("f32", "u8"):
        raise ValueError(f"unknown emit mode {kw.get('emit')!r}")
    for tpu_only in ("grain_g", "grain_off", "grain_frac", "grain_raw"):
        kw.pop(tpu_only, None)  # the TPU's in-kernel grain upsample forms
    fast = bool(bloom and fast)
    taps = oblur.gaussian_taps(sigma) if bloom and not fast else ()
    if len(taps) > MAX_TAPS:
        raise NotImplementedError(
            f"bloom radius {len(taps) // 2} exceeds the fused kernel's 31 "
            "(ROADMAP.md queue 2: bloom3)")
    if int(kw.get("px", 1)) < 1 or abs(int(kw.get("ab", 0))) >= w:
        raise ValueError("pixel size must be >= 1 and |aberration| < width")
    return FusedSpec(h=int(h), w=int(w), bloom=bool(bloom), taps=taps, fast=fast,
                     strength=float(strength), threshold=float(threshold), pre=bool(pre),
                     **kw)


class FusedConsts(NamedTuple):
    """Device tables of one spec: index maps, the triad tables and the
    fast core's resize taps."""
    y_map: torch.Tensor            # (H,) int32
    x_maps: torch.Tensor           # (3, W) int32, plane order
    lut_fwd: Optional[torch.Tensor]  # (1025,) f32
    lut_fin: Optional[torch.Tensor]  # (1025,) f32
    # fast core: (lo int32, frac f32) for the down rows (H2,), down
    # columns (W2,), up rows (H,) and up columns (W,): the oracle's
    # bilinear_taps
    fast_taps: Optional[tuple] = None
    # fast core: the largest per-tile (rows, columns, half rows, half
    # columns) the kernel holds in shared memory
    fast_extent: Optional[tuple] = None


def _tile_extents(up_lo: np.ndarray, dn_lo: np.ndarray, full: int, half: int):
    """Largest full-res and half-res extents over the tiles of one axis,
    by csrc/fused.cu's fast_window: the half-res range the up pass reads,
    the source range the down pass reads, and the tile itself."""
    t0 = np.arange(0, full, TILE)
    t1 = np.minimum(t0 + TILE, full) - 1
    i0 = up_lo[t0]
    i1 = np.minimum(up_lo[t1] + 1, half - 1)
    s0 = np.minimum(dn_lo[i0], t0)
    s1 = np.maximum(np.minimum(dn_lo[i1] + 1, full - 1), t1)
    return int((s1 - s0 + 1).max()), int((i1 - i0 + 1).max())


def fast_tables(h: int, w: int) -> tuple[tuple, tuple]:
    """The fast core's taps, the oracle's resize_bilinear to (H//2, W//2)
    and back (oracle/engine.py apply_effects, stage 6), and the per-tile
    extents they give."""
    h2, w2 = max(1, h // 2), max(1, w // 2)
    taps = (*oracle.ops.bilinear_taps(h, h2), *oracle.ops.bilinear_taps(w, w2),
            *oracle.ops.bilinear_taps(h2, h), *oracle.ops.bilinear_taps(w2, w))
    rows, hrows = _tile_extents(taps[4], taps[0], h, h2)
    cols, hcols = _tile_extents(taps[6], taps[2], w, w2)
    return taps, (rows, cols, hrows, hcols)


def fused_consts(spec: FusedSpec, device="cpu") -> FusedConsts:
    y_map, x_maps = oresize.plane_index_maps(spec.h, spec.w, spec.px, spec.ab, spec.corder)
    fwd = fin = None
    if spec.triad and not ocolor.triad_is_multiply(spec.triad_gamma, spec.triad_luma):
        fwd, fin = ocolor.triad_tables(spec.triad_gamma, device)
    taps = extent = None
    if spec.bloom and spec.fast:
        taps, extent = fast_tables(spec.h, spec.w)
        taps = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in taps)
    return FusedConsts(torch.from_numpy(y_map).to(device),
                       torch.from_numpy(x_maps).to(device), fwd, fin, taps, extent)


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
    multiplier or, in the engine's staged step, the (B, H, W) 2-D mask."""
    s = spec
    if s.triad:
        m = ocolor.apply_triad_planar(m, tri, s.triad_gamma, s.triad_luma, s.corder,
                                      tables=(consts.lut_fwd, consts.lut_fin))
    if s.scanlines:
        m = torch.clamp(m * (sl[:, None, :, None] if sl.ndim == 2 else sl[:, None]), 0.0, 1.0)
    if s.vignette:
        r2 = vy2[:, None] + vx2[None, :]
        v = np.float32(1.0) - np.float32(s.vig_strength) * torch.clamp(r2, 0.0, 1.0)
        m = torch.clamp(m * v, 0.0, 1.0)
    if s.flicker:
        m = torch.clamp(m * flicker[:, None, None, None], 0.0, 1.0)
    if s.noise:
        m = torch.clamp(m + (grain * np.float32(s.noise_scale))[:, None], 0.0, 1.0)
    return ocolor.to_uint8(m) if s.emit == "u8" else m


def fused_pipeline_ref(img: torch.Tensor, spec: FusedSpec, consts: FusedConsts, *,
                       grain=None, sl=None, vy2=None, vx2=None, tri=None,
                       flicker=None) -> torch.Tensor:
    """The fused kernel's plain PyTorch twin, on any device."""
    x = prologue_ref(img, spec, consts) if spec.pre else img
    return epilogue_ref(bloom_ref(x, spec, consts), spec, consts, grain=grain, sl=sl,
                        vy2=vy2, vx2=vx2, tri=tri, flicker=flicker)


class _FusedArgs(ctypes.Structure):
    """Mirror of FusedArgs in csrc/fused.cu (checked by size at launch)."""
    _fields_ = [
        ("img", ctypes.c_void_p), ("imgf", ctypes.c_void_p), ("out", ctypes.c_void_p),
        ("ymap", ctypes.c_void_p), ("xmap", ctypes.c_void_p),
        ("grain", ctypes.c_void_p), ("sl", ctypes.c_void_p),
        ("vy2", ctypes.c_void_p), ("vx2", ctypes.c_void_p),
        ("tri", ctypes.c_void_p), ("flicker", ctypes.c_void_p),
        ("lut_fwd", ctypes.c_void_p), ("lut_fin", ctypes.c_void_p),
        ("fd_ylo", ctypes.c_void_p), ("fd_yf", ctypes.c_void_p),
        ("fd_xlo", ctypes.c_void_p), ("fd_xf", ctypes.c_void_p),
        ("fu_ylo", ctypes.c_void_p), ("fu_yf", ctypes.c_void_p),
        ("fu_xlo", ctypes.c_void_p), ("fu_xf", ctypes.c_void_p),
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
        ("fs_rows", ctypes.c_int32), ("fs_cols", ctypes.c_int32),
        ("fh_rows", ctypes.c_int32), ("fh_cols", ctypes.c_int32),
        ("triad_mode", ctypes.c_int32), ("luma_on", ctypes.c_int32),
        ("sl_on", ctypes.c_int32), ("vig_on", ctypes.c_int32),
        ("vig_strength", ctypes.c_float),
        ("flicker_on", ctypes.c_int32),
        ("noise_on", ctypes.c_int32), ("noise_scale", ctypes.c_float),
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


def fused_pipeline(img: torch.Tensor, spec: FusedSpec, consts: FusedConsts, *,
                   grain=None, sl=None, vy2=None, vx2=None, tri=None,
                   flicker=None) -> torch.Tensor:
    """Run stages 1-11.

    img: (B, 3, H, W) uint8 planar frames, plane i holding colour
    spec.corder[i], or the f32 image after stages 1-5 when spec.pre is
    False. grain: (B, H, W) f32 unscaled noise field [noise];
    sl: (B, H) f32 scanline multiplier [scanlines]; vy2/vx2: (H,)/(W,)
    f32 vignette vectors [vignette]; tri: (3, W) f32 triad rows in plane
    order [triad]; flicker: (B,) f32 [flicker]. Returns (B, 3, H, W)
    f32 in [0, 1], or uint8 when spec.emit == "u8".

    CPU tensors run the plain twin; CUDA tensors launch the kernel.
    """
    global launches
    if img.device.type == "cpu":
        return fused_pipeline_ref(img, spec, consts, grain=grain, sl=sl, vy2=vy2,
                                  vx2=vx2, tri=tri, flicker=flicker)
    if img.device.type != "cuda":
        raise ValueError(f"fused_pipeline: unsupported device {img.device}")
    s = spec
    b = img.shape[0]
    dev = img.device
    a = _FusedArgs()
    if s.pre:
        a.img = _check("img", img, (b, 3, s.h, s.w), torch.uint8, dev)
    else:
        a.imgf = _check("img", img, (b, 3, s.h, s.w), torch.float32, dev)
    a.ymap = _check("y_map", consts.y_map, (s.h,), torch.int32, dev)
    a.xmap = _check("x_maps", consts.x_maps, (3, s.w), torch.int32, dev)
    if s.noise:
        a.grain = _check("grain", grain, (b, s.h, s.w), torch.float32, dev)
    if s.scanlines:
        a.sl = _check("sl", sl, (b, s.h), torch.float32, dev)
    if s.vignette:
        a.vy2 = _check("vy2", vy2, (s.h,), torch.float32, dev)
        a.vx2 = _check("vx2", vx2, (s.w,), torch.float32, dev)
    if s.flicker:
        a.flicker = _check("flicker", flicker, (b,), torch.float32, dev)
    a.triad_mode = 0
    if s.triad:
        a.tri = _check("tri", tri, (3, s.w), torch.float32, dev)
        a.triad_mode = 1 if ocolor.triad_is_multiply(s.triad_gamma, s.triad_luma) else 2
        if a.triad_mode == 2:
            a.lut_fwd = _check("lut_fwd", consts.lut_fwd, (1025,), torch.float32, dev)
            a.lut_fin = _check("lut_fin", consts.lut_fin, (1025,), torch.float32, dev)
        a.luma_on = int(s.triad_luma)
    out = torch.empty((b, 3, s.h, s.w), device=dev,
                      dtype=torch.uint8 if s.emit == "u8" else torch.float32)
    a.out = out.data_ptr()
    a.b, a.h, a.w = b, s.h, s.w
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
        a.fs_rows, a.fs_cols, a.fh_rows, a.fh_cols = consts.fast_extent
    elif s.bloom:
        left, right = oblur.edge_coefs(s.taps)
        a.taps[:len(s.taps)] = [float(np.float32(t)) for t in s.taps]
        a.edge_l[:len(left)] = [float(v) for v in left]
        a.edge_r[:len(right)] = [float(v) for v in right]
    a.sl_on, a.vig_on = int(s.scanlines), int(s.vignette)
    a.vig_strength = np.float32(s.vig_strength)
    a.flicker_on = int(s.flicker)
    a.noise_on, a.noise_scale = int(s.noise), np.float32(s.noise_scale)
    _build.launch("crt_fused_launch", a, torch.cuda.current_stream(dev).cuda_stream)
    launches += 1
    return out
