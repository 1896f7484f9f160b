"""Stage 6 on its own: the stand-alone bloom kernels and their plain twins.

Port of pythoncrt_tpu/kernels/bloom3.py: ``bloom3_planar`` (the exact
gaussian, _bloom3_kernel) and ``bloom3_fast_planar`` (the half-res
bilinear down and up, _bloom3_fast_kernel), each

    (B, 3, H, W) f32 in [0, 1] -> clip(x + strength * blur(knee(x)))

plane by plane. The engine runs them where the fused kernel cannot take
the whole chain (2-D scanlines); the twins are the fused kernel's stage
6 (kernels/fused.py ``bloom_core_ref``), so the two paths agree bit for
bit.

Both launch csrc/bloom_walk.cu's row walk (kernels/bloom_walk.py) for
CUDA tensors: ``bloom3_planar`` its FOLD source, ``bloom3_fast_planar``
its FAST source with the tables of ``bloom_walk.fast_tables`` (built once
per frame size, knee and device); both run their plain twins
(``bloom3_planar_ref``, ``bloom3_fast_planar_ref``) for CPU tensors. The specs keep the JAX
names; the TPU's shape gates (H%8, W%128, radius < 8, even sizes for the
fast variant) have no counterpart: any H, W and radius.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from ..ops import blur as oblur
from . import bloom_walk as kwalk
from .fused import bloom_core_ref

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


def bloom3_fast_planar_ref(imgs: torch.Tensor, spec: Bloom3Spec,
                           tables: Optional[kwalk.FastTables] = None) -> torch.Tensor:
    """The fast kernel's plain twin: ops/resize.resize_bilinear down and up."""
    taps = (tables or kwalk.fast_tables(spec.h, spec.w, spec.threshold,
                                         imgs.device)).taps
    return bloom_core_ref(imgs, spec.strength, spec.threshold, fast_taps=taps)


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
                       tables: Optional[kwalk.FastTables] = None) -> torch.Tensor:
    """(B, 3, H, W) f32 -> clip(x + strength * up(down(knee(x)))).
    ``tables`` from kernels/bloom_walk.py ``fast_tables`` on the tensor's
    device (built per call when None). CPU tensors run the plain twin;
    CUDA tensors launch the kernel."""
    global launches
    if not spec.fast:
        raise ValueError("bloom3_fast_planar: the spec is the gaussian variant's")
    if imgs.device.type == "cpu":
        return bloom3_fast_planar_ref(imgs, spec, tables)
    tables = tables or kwalk.fast_tables(spec.h, spec.w, spec.threshold, imgs.device)
    if (tables.plan.h, tables.plan.w) != (spec.h, spec.w):
        raise ValueError(f"bloom3_fast_planar: tables of {tables.plan.h}x{tables.plan.w} for a "
                         f"{spec.h}x{spec.w} spec")
    out = kwalk.fast_launch(imgs, tables, "bloom3_fast_planar", strength=spec.strength,
                            threshold=spec.threshold)
    launches += 1
    return out
