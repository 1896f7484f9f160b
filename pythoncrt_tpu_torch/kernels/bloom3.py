"""Stage 6 on its own: the stand-alone bloom kernels and their plain twins.

Port of pythoncrt_tpu/kernels/bloom3.py: ``bloom3_planar`` (the exact
gaussian, _bloom3_kernel) and ``bloom3_fast_planar`` (the half-res
bilinear down and up, _bloom3_fast_kernel), each

    (B, 3, H, W) f32 in [0, 1] -> clip(x + strength * blur(knee(x)))

plane by plane. The engine runs them where the fused kernel cannot take
the whole chain (2-D scanlines); the twins are the fused kernel's stage
6 (kernels/fused.py ``bloom_core_ref``), so the two paths agree bit for
bit.

``bloom3_planar`` launches the FOLD instance of csrc/bloom_walk.cu (the
row walk, kernels/bloom_walk.py) and ``bloom3_fast_planar`` csrc/bloom3.cu
for CUDA tensors; both run their plain twins (``bloom3_planar_ref``,
``bloom3_fast_planar_ref``) for CPU tensors. The specs keep the JAX
names; the TPU's shape gates (H%8, W%128, radius < 8, even sizes for the
fast variant) have no counterpart: any H, W and radius.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..ops import blur as oblur
from . import _build
from . import bloom_walk as kwalk
from .fused import bloom_core_ref, fast_tables, knee_consts

launches = 0  # CUDA launches made by bloom3_planar and bloom3_fast_planar


@dataclass(frozen=True)
class Bloom3Spec:
    h: int
    w: int
    taps: tuple  # gaussian taps, radius r = len(taps) // 2; () for the fast variant
    strength: float
    threshold: float
    fast: bool = False

    @property
    def r(self) -> int:
        return len(self.taps) // 2


def build_bloom3_spec(h: int, w: int, sigma: float, strength: float,
                      threshold: float) -> Bloom3Spec:
    """The gaussian variant: taps of oracle.ops.gaussian_kernel_1d (any
    radius)."""
    return Bloom3Spec(h=int(h), w=int(w), taps=oblur.gaussian_taps(sigma), strength=float(strength),
                      threshold=float(threshold))


def build_bloom3_fast_spec(h: int, w: int, strength: float, threshold: float) -> Bloom3Spec:
    """The fast variant: resize_bilinear to (H//2, W//2) and back."""
    return Bloom3Spec(h=int(h), w=int(w), taps=(), strength=float(strength),
                      threshold=float(threshold), fast=True)


def bloom3_planar_ref(imgs: torch.Tensor, spec: Bloom3Spec) -> torch.Tensor:
    """The gaussian kernel's plain twin (ops/blur.gaussian_blur_replicate)."""
    return bloom_core_ref(imgs, spec.strength, spec.threshold, taps=spec.taps)


def fast_taps(h: int, w: int, device="cpu") -> tuple:
    """The fast variant's oracle bilinear_taps tables on ``device``, (lo
    int32, frac f32) for the down rows, down columns, up rows and up
    columns, and the largest per-tile extents they give."""
    taps, extent = fast_tables(h, w)
    return (tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in taps),
            extent)


def bloom3_fast_planar_ref(imgs: torch.Tensor, spec: Bloom3Spec,
                           tables: Optional[tuple] = None) -> torch.Tensor:
    """The fast kernel's plain twin: ops/resize.resize_bilinear down and up."""
    taps = (tables or fast_taps(spec.h, spec.w, imgs.device))[0]
    return bloom_core_ref(imgs, spec.strength, spec.threshold, fast_taps=taps)


class _Bloom3Args(ctypes.Structure):
    """Mirror of Bloom3Args in csrc/bloom3.cu, the fast kernel's arguments
    (checked by size at launch)."""
    _fields_ = [
        ("img", ctypes.c_void_p), ("out", ctypes.c_void_p),
        ("fd_ylo", ctypes.c_void_p), ("fd_yf", ctypes.c_void_p),
        ("fd_xlo", ctypes.c_void_p), ("fd_xf", ctypes.c_void_p),
        ("fu_ylo", ctypes.c_void_p), ("fu_yf", ctypes.c_void_p),
        ("fu_xlo", ctypes.c_void_p), ("fu_xf", ctypes.c_void_p),
        ("n", ctypes.c_int32), ("h", ctypes.c_int32), ("w", ctypes.c_int32),
        ("knee_on", ctypes.c_int32), ("thr", ctypes.c_float), ("rden", ctypes.c_float),
        ("strength", ctypes.c_float),
        ("h2", ctypes.c_int32), ("w2", ctypes.c_int32),
        ("fs_rows", ctypes.c_int32), ("fs_cols", ctypes.c_int32),
        ("fh_rows", ctypes.c_int32), ("fh_cols", ctypes.c_int32),
    ]


def _launch_fast(imgs: torch.Tensor, spec: Bloom3Spec, tables) -> torch.Tensor:
    global launches
    if imgs.device.type != "cuda":
        raise ValueError(f"bloom3_fast_planar: unsupported device {imgs.device}")
    if (imgs.ndim != 4 or imgs.shape[1] != 3 or tuple(imgs.shape[2:]) != (spec.h, spec.w)
            or imgs.dtype != torch.float32 or not imgs.is_contiguous()):
        raise ValueError(f"bloom3_fast_planar: imgs must be a contiguous f32 (B, 3, {spec.h}, "
                         f"{spec.w}) tensor, got {imgs.dtype} {tuple(imgs.shape)}")
    a = _Bloom3Args()
    out = torch.empty_like(imgs)
    a.img, a.out = imgs.data_ptr(), out.data_ptr()
    a.n, a.h, a.w = imgs.shape[0] * 3, spec.h, spec.w
    a.knee_on = int(spec.threshold > 0.0)
    if a.knee_on:
        a.thr, a.rden = knee_consts(spec.threshold)
    a.strength = np.float32(spec.strength)
    a.h2, a.w2 = max(1, spec.h // 2), max(1, spec.w // 2)
    taps, extent = tables or fast_taps(spec.h, spec.w, imgs.device)
    names = ("fd_ylo", "fd_yf", "fd_xlo", "fd_xf", "fu_ylo", "fu_yf", "fu_xlo", "fu_xf")
    lens = (a.h2, a.h2, a.w2, a.w2, spec.h, spec.h, spec.w, spec.w)
    for i, (tname, n) in enumerate(zip(names, lens)):
        t = taps[i]
        dt = torch.int32 if i % 2 == 0 else torch.float32
        if t.device != imgs.device or t.dtype != dt or tuple(t.shape) != (n,) \
                or not t.is_contiguous():
            raise ValueError(f"bloom3_fast_planar: table {tname} must be a contiguous {dt} "
                             f"({n},) tensor on {imgs.device}")
        setattr(a, tname, t.data_ptr())
    a.fs_rows, a.fs_cols, a.fh_rows, a.fh_cols = extent
    _build.launch("crt_bloom3_launch", a, torch.cuda.current_stream(imgs.device).cuda_stream)
    launches += 1
    return out


def _launch_gauss(imgs: torch.Tensor, spec: Bloom3Spec) -> torch.Tensor:
    global launches
    r = spec.r
    out = kwalk.walk_launch(imgs, spec.h, spec.w, "bloom3_planar", src=kwalk.FOLD,
                            bands=(-r, r, -r, r), strength=spec.strength,
                            threshold=spec.threshold, taps=spec.taps)
    launches += 1
    return out


def bloom3_planar(imgs: torch.Tensor, spec: Bloom3Spec) -> torch.Tensor:
    """(B, 3, H, W) f32 -> clip(x + strength * gaussian(knee(x))). CPU
    tensors run the plain twin; CUDA tensors launch the kernel."""
    if spec.fast:
        raise ValueError("bloom3_planar: the spec is the fast variant's")
    if imgs.device.type == "cpu":
        return bloom3_planar_ref(imgs, spec)
    return _launch_gauss(imgs, spec)


def bloom3_fast_planar(imgs: torch.Tensor, spec: Bloom3Spec,
                       tables: Optional[tuple] = None) -> torch.Tensor:
    """(B, 3, H, W) f32 -> clip(x + strength * up(down(knee(x)))).
    ``tables`` from ``fast_taps`` on the tensor's device (built per call
    when None). CPU tensors run the plain twin; CUDA tensors launch the
    kernel."""
    if not spec.fast:
        raise ValueError("bloom3_fast_planar: the spec is the gaussian variant's")
    if imgs.device.type == "cpu":
        return bloom3_fast_planar_ref(imgs, spec, tables)
    return _launch_fast(imgs, spec, tables)
