"""The banded separable bloom (stage 6 on its own): the CUDA kernel and
its plain twin.

Port of pythoncrt_tpu/kernels/bloom2.py: ``bloom2_nhwc`` and
``bloom2_nhwc_pipelined`` (the same function from pipelined pieces, with
a ``limbs`` setting), the bloom the JAX engine runs when
``PCRT_BLOOM2_GAUSS=1`` (gaussian) or ``PCRT_BLOOM2_FAST=1`` (fast)
selects it. Both bloom variants are separable linear maps, one banded
(n, n) matrix per axis:

- gaussian: the oracle's replicate-border blur matrix, the border taps
  summed onto the clipped index in f64 and rounded once to f32;
- fast: the half-res bilinear down and up composed per axis in f64.

The matrices are built by the JAX module's own NumPy arithmetic
(``_gaussian_matrix``, ``_resize_matrix``, ``_fast_matrix``, ``_band``,
copied here: that module imports JAX), so the band weights are its bits.
Per plane the kernel computes

    h[y, x] = sum_d hw[d - d0, x] * knee(x[y, x + d])     (d in order)
    v[y, x] = sum_d vw[d - d0, y] * h[y + d, x]           (d in order)
    out     = clip(x + strength * v)

with out-of-frame taps at weight 0 (index clamped, product kept).

Precision. The TPU forms the horizontal pass as three bf16 MXU products
(hi*hi + hi*lo + lo*hi), about 2^-17 from the f32 product; the port forms
the f32 product (``limbs=3``). The pipelined entry's ``limbs=2`` rounds
the value to bf16 against the hi + lo weight, ``limbs=1`` rounds value
and weight to bf16: one rounding each, what the TPU's reduced settings
compute. The lane pre-pad, lane masks, the bf16 mask pair and the DMA
ring are TPU forms with no counterpart; any H, W and band.

``bloom2_planar`` and ``bloom2_planar_pipelined`` launch the TABLE
instance of csrc/bloom_walk.cu (the row walk, kernels/bloom_walk.py) for
CUDA tensors and run their twins (``bloom2_planar_ref``,
``bloom2_planar_pipelined_ref``) for CPU tensors.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ..oracle.ops import bilinear_taps, gaussian_kernel_1d
from . import bloom_walk as kwalk
from .fused import knee_consts

launches = 0  # CUDA launches made by bloom2_planar and bloom2_planar_pipelined


def _gaussian_matrix(n: int, sigma: float) -> np.ndarray:
    """(n, n) f32 replicate-border blur matrix from the oracle's taps
    (bloom2.py:75-87: border taps fold onto the clipped index in f64)."""
    k = max(1, int(round(sigma * 3)) * 2 + 1)
    taps = gaussian_kernel_1d(k, sigma).astype(np.float64)
    r = k // 2
    m = np.zeros((n, n), np.float64)
    idx = np.arange(n)
    for i, t in enumerate(taps):
        src = np.clip(idx + i - r, 0, n - 1)
        np.add.at(m, (idx, src), t)
    return m.astype(np.float32)


def _resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) f32 matrix of oracle.ops.bilinear_taps resampling."""
    lo, frac = bilinear_taps(n_in, n_out)
    hi = np.minimum(lo + 1, n_in - 1)
    m = np.zeros((n_out, n_in), np.float64)
    idx = np.arange(n_out)
    np.add.at(m, (idx, lo), 1.0 - frac.astype(np.float64))
    np.add.at(m, (idx, hi), frac.astype(np.float64))
    return m.astype(np.float32)


def _fast_matrix(n: int) -> np.ndarray:
    """Half-res bilinear down and up composed along one axis (in f64)."""
    n2 = max(1, n // 2)
    return (_resize_matrix(n, n2).astype(np.float64).T
            @ _resize_matrix(n2, n).astype(np.float64).T).T.astype(np.float32)


def _band(m: np.ndarray):
    """(offsets d0..d1, weights (nd, n)) of a banded (n, n) matrix:
    weights[d - d0, y] = m[y, y + d]."""
    n = m.shape[0]
    ys, xs = np.nonzero(m)
    d0, d1 = int((xs - ys).min()), int((xs - ys).max())
    nd = d1 - d0 + 1
    wts = np.zeros((nd, n), np.float32)
    for d in range(d0, d1 + 1):
        y = np.arange(max(0, -d), min(n, n - d))
        wts[d - d0, y] = m[y, y + d]
    return d0, d1, wts


@dataclass(frozen=True)
class Bloom2Spec:
    h: int
    w: int
    variant: str  # "gaussian" | "fast"
    strength: float
    threshold: float
    hd0: int  # horizontal band offsets
    hd1: int
    vd0: int  # vertical band offsets
    vd1: int
    hw: np.ndarray = field(repr=False)  # (hd1 - hd0 + 1, w) f32
    vw: np.ndarray = field(repr=False)  # (vd1 - vd0 + 1, h) f32


def build_bloom2_spec(h: int, w: int, *, variant: str, sigma: float = 0.0,
                      strength: float = 0.0, threshold: float = 0.0) -> Bloom2Spec:
    """Each axis's band from bloom2's matrices: the horizontal weights by
    the same ``_band`` bloom2 applies to its vertical matrix."""
    if variant == "gaussian":
        hm, vm = _gaussian_matrix(w, sigma), _gaussian_matrix(h, sigma)
    elif variant == "fast":
        hm, vm = _fast_matrix(w), _fast_matrix(h)
    else:
        raise ValueError(f"unknown bloom variant {variant!r}")
    hd0, hd1, hw = _band(hm)
    vd0, vd1, vw = _band(vm)
    return Bloom2Spec(h=int(h), w=int(w), variant=variant, strength=float(strength),
                      threshold=float(min(0.99, max(0.0, threshold))),
                      hd0=hd0, hd1=hd1, vd0=vd0, vd1=vd1, hw=hw, vw=vw)


def _bf16(a: torch.Tensor) -> torch.Tensor:
    return a.to(torch.bfloat16).float()


def bloom2_tables(spec: Bloom2Spec, device="cpu", limbs: int = 3) -> tuple:
    """(hw, vw) f32 weight tables on ``device`` for a ``limbs`` setting:
    the f32 weights (3), hi + lo of their bf16 split (2), hi alone (1)."""
    if limbs not in (1, 2, 3):
        raise ValueError(f"limbs must be 1, 2 or 3, got {limbs}")
    hw = torch.from_numpy(spec.hw)
    if limbs < 3:
        hi = _bf16(hw)
        hw = hi if limbs == 1 else hi + _bf16(hw - hi)  # the two limbs' sum, in f32
    return hw.contiguous().to(device), torch.from_numpy(spec.vw).to(device)


def _ref(imgs: torch.Tensor, spec: Bloom2Spec, tables, limbs: int) -> torch.Tensor:
    hw, vw = tables if tables is not None else bloom2_tables(spec, imgs.device, limbs)
    src = imgs
    if spec.threshold > 0.0:
        thr, rden = knee_consts(spec.threshold)
        src = torch.clamp((imgs - thr) * rden, 0.0, 1.0)
    if limbs < 3:
        src = _bf16(src)
    h, w = spec.h, spec.w
    xs, ys = torch.arange(w, device=imgs.device), torch.arange(h, device=imgs.device)
    hacc = None
    for t, d in enumerate(range(spec.hd0, spec.hd1 + 1)):
        term = hw[t] * src.index_select(-1, (xs + d).clamp(0, w - 1))
        hacc = term if hacc is None else hacc + term
    vacc = None
    for t, d in enumerate(range(spec.vd0, spec.vd1 + 1)):
        term = vw[t][:, None] * hacc.index_select(-2, (ys + d).clamp(0, h - 1))
        vacc = term if vacc is None else vacc + term
    return torch.clamp(imgs + np.float32(spec.strength) * vacc, 0.0, 1.0)


def bloom2_planar_ref(imgs: torch.Tensor, spec: Bloom2Spec,
                      tables: Optional[tuple] = None) -> torch.Tensor:
    """The kernel's plain twin (the f32 product)."""
    return _ref(imgs, spec, tables, 3)


def bloom2_planar_pipelined_ref(imgs: torch.Tensor, spec: Bloom2Spec, limbs: int = 3,
                                tables: Optional[tuple] = None) -> torch.Tensor:
    """The pipelined entry's twin at a ``limbs`` setting."""
    return _ref(imgs, spec, tables, limbs)


def _launch(imgs: torch.Tensor, spec: Bloom2Spec, tables, limbs: int,
            name: str) -> torch.Tensor:
    global launches
    if tables is None and imgs.device.type == "cuda":
        tables = bloom2_tables(spec, imgs.device, limbs)
    out = kwalk.walk_launch(imgs, spec.h, spec.w, name, src=kwalk.TABLE,
                            bands=(spec.hd0, spec.hd1, spec.vd0, spec.vd1),
                            strength=spec.strength, threshold=spec.threshold, tables=tables,
                            limbs=limbs)
    launches += 1
    return out


def bloom2_planar(imgs: torch.Tensor, spec: Bloom2Spec,
                  tables: Optional[tuple] = None) -> torch.Tensor:
    """(B, 3, H, W) f32 -> clip(x + strength * V(H(knee(x)))). ``tables``
    from ``bloom2_tables`` on the tensor's device (built per call when
    None). CPU tensors run the plain twin; CUDA tensors launch the
    kernel."""
    if imgs.device.type == "cpu":
        return bloom2_planar_ref(imgs, spec, tables)
    return _launch(imgs, spec, tables, 3, "bloom2_planar")


def bloom2_planar_pipelined(imgs: torch.Tensor, spec: Bloom2Spec, limbs: int = 3,
                            tables: Optional[tuple] = None) -> torch.Tensor:
    """``bloom2_nhwc_pipelined``'s function at a ``limbs`` setting (3 is
    ``bloom2_planar``); ``tables`` must be built for the same setting."""
    if limbs not in (1, 2, 3):
        raise ValueError(f"limbs must be 1, 2 or 3, got {limbs}")
    if imgs.device.type == "cpu":
        return bloom2_planar_pipelined_ref(imgs, spec, limbs, tables)
    return _launch(imgs, spec, tables, limbs, "bloom2_planar_pipelined")
