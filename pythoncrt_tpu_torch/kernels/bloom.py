"""The stripe gaussian bloom (stage 6 on its own): the CUDA kernel and its
plain twin.

Port of pythoncrt_tpu/kernels/bloom.py (``bloom_nhwc`` / _bloom_kernel),
the gaussian bloom the JAX engine runs when ``PCRT_PALLAS_BLOOM=1``
selects it:

    (B, 3, H, W) f32 in [0, 1] -> clip(x + strength * blur(knee(x)))

plane by plane, where ``blur`` is the oracle's separable blur in its own
op order (oracle/ops.py ``_conv1d_replicate``): every tap reads a
replicate-clamped sample, the horizontal taps sum in tap order, then the
vertical taps in tap order over the clamped rows of the horizontal
result. That is not the border fold of ops/blur.py and the bloom3 kernel
(the out-of-frame taps summed into one coefficient), so the twin is its
own function; the two agree only to an ulp at the borders.

``bloom_planar`` launches the CLAMP instance of csrc/bloom_walk.cu (the
row walk, kernels/bloom_walk.py: constant taps over the band -r..r on
both axes, the index clamped: the oracle's replicate padding) for CUDA
tensors and runs ``bloom_planar_ref`` for CPU tensors.
``build_bloom_spec`` keeps the JAX name; the TPU's gates and stripe
geometry (H%8, W%128, ``ty``, ``sy``, ``wtot``) have no counterpart: any
H, W and radius.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops import blur as oblur
from . import bloom_walk as kwalk
from .fused import knee_consts

launches = 0  # CUDA launches made by bloom_planar


@dataclass(frozen=True)
class BloomSpec:
    h: int
    w: int
    taps: tuple  # the oracle's gaussian taps, radius r = len(taps) // 2
    strength: float
    threshold: float  # 0 disables the knee

    @property
    def radius(self) -> int:
        return len(self.taps) // 2


def build_bloom_spec(h: int, w: int, sigma: float, strength: float,
                     threshold: float) -> BloomSpec:
    """Taps of oracle.ops.gaussian_kernel_1d (k = round(3 sigma) * 2 + 1;
    any radius)."""
    return BloomSpec(h=int(h), w=int(w), taps=oblur.gaussian_taps(sigma), strength=float(strength),
                     threshold=float(min(0.99, max(0.0, threshold))))


def _conv_replicate(x: torch.Tensor, taps, axis: int) -> torch.Tensor:
    """Correlate along ``axis`` over replicate-clamped samples, the taps
    summed in order (oracle/ops.py _conv1d_replicate)."""
    r, n = len(taps) // 2, x.shape[axis]
    idx = torch.arange(-r, n + r, device=x.device).clamp_(0, n - 1)
    padded = x.index_select(axis, idx)
    out = None
    for i, t in enumerate(taps):
        term = np.float32(t) * padded.narrow(axis, i, n)
        out = term if out is None else out + term
    return out


def bloom_planar_ref(imgs: torch.Tensor, spec: BloomSpec) -> torch.Tensor:
    """The kernel's plain twin: knee, the horizontal then the vertical
    pass in the oracle's op order, the composite."""
    src = imgs
    if spec.threshold > 0.0:
        thr, rden = knee_consts(spec.threshold)
        src = torch.clamp((imgs - thr) * rden, 0.0, 1.0)
    blur = _conv_replicate(_conv_replicate(src, spec.taps, imgs.ndim - 1), spec.taps,
                           imgs.ndim - 2)
    return torch.clamp(imgs + np.float32(spec.strength) * blur, 0.0, 1.0)


def bloom_planar(imgs: torch.Tensor, spec: BloomSpec) -> torch.Tensor:
    """(B, 3, H, W) f32 -> clip(x + strength * blur(knee(x))). CPU
    tensors run the plain twin; CUDA tensors launch the kernel."""
    global launches
    if imgs.device.type == "cpu":
        return bloom_planar_ref(imgs, spec)
    r = spec.radius
    out = kwalk.walk_launch(imgs, spec.h, spec.w, "bloom_planar", src=kwalk.CLAMP,
                            bands=(-r, r, -r, r), strength=spec.strength,
                            threshold=spec.threshold, taps=spec.taps)
    launches += 1
    return out
