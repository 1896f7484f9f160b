"""Separable gaussian blur with replicate borders in PyTorch.

Port of pythoncrt_tpu/ops/blur.py (cv2.GaussianBlur at crt_filter.py:610,
BORDER_REPLICATE). Taps come from oracle.ops.gaussian_kernel_1d and are
summed in tap order, horizontal pass first, as oracle.ops does, so
interior pixels are the oracle's bits. At the borders the taps that the
replicate border clips onto the edge sample are folded into one
coefficient per distance from the edge, added after the in-frame taps
(left/top, then right/bottom): the form both JAX paths and the CUDA
fused kernel use, a few f32 reassociations away from the oracle there.
"""

from __future__ import annotations

import numpy as np
import torch

from ..oracle import ops as oops


def gaussian_taps(sigma: float) -> tuple[float, ...]:
    """The bloom's 1-D taps: k = max(1, round(3*sigma)*2 + 1) (crt_filter.py:609)."""
    k = max(1, int(round(float(sigma) * 3)) * 2 + 1)
    return tuple(float(t) for t in oops.gaussian_kernel_1d(k, float(sigma)))


def edge_coefs(taps) -> tuple[np.ndarray, np.ndarray]:
    """(left, right) folded border coefficients, indexed by the distance
    d < r of a pixel from the left (top) or right (bottom) edge: the f32
    sum, in tap order, of the taps that fall outside the frame. Each sum
    runs sequentially from 0; the distances are summed side by side (one
    vector add per tap), so a radius in the thousands costs O(r) numpy
    adds, not O(r^2) Python ones."""
    t = np.asarray(taps, np.float32)
    r = len(t) // 2
    left = np.zeros(max(r, 1), np.float32)
    right = np.zeros(max(r, 1), np.float32)
    for j in range(r):
        left[:r - j] += t[j]           # tap j lies left of pixels d < r - j
        right[:r - j] += t[r + 1 + j:]  # tap r + d + 1 + j, the j-th outside of pixel d
    return left, right


def _blur_axis(img: torch.Tensor, taps, axis: int) -> torch.Tensor:
    k = len(taps)
    r = k // 2
    n = img.shape[axis]
    pad = [0] * (2 * img.ndim)
    pad[2 * (img.ndim - 1 - axis)] = r
    pad[2 * (img.ndim - 1 - axis) + 1] = r
    padded = torch.nn.functional.pad(img, pad)  # zeros: out-of-frame taps add nothing
    out = None
    for i, t in enumerate(taps):
        term = np.float32(t) * padded.narrow(axis, i, n)
        out = term if out is None else out + term
    left, right = edge_coefs(taps)
    cl = np.zeros(n, np.float32)
    cr = np.zeros(n, np.float32)
    m = min(r, n)
    cl[:m] = left[:m]
    cr[n - m:] = right[:m][::-1]
    shape = [1] * img.ndim
    shape[axis] = n
    out = out + torch.from_numpy(cl).to(img.device).reshape(shape) * img.narrow(axis, 0, 1)
    return out + torch.from_numpy(cr).to(img.device).reshape(shape) * img.narrow(axis, n - 1, 1)


def gaussian_blur_replicate(img: torch.Tensor, taps, h_axis: int = -2,
                            w_axis: int = -1) -> torch.Tensor:
    """Horizontal then vertical pass with the same taps (square kernel)."""
    if len(taps) <= 1:
        return img  # a one-tap kernel is skipped by the reference
    out = _blur_axis(img, taps, w_axis % img.ndim)
    return _blur_axis(out, taps, h_axis % img.ndim)
