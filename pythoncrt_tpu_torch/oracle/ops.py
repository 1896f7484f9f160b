"""Ground-truth NumPy image primitives.

These define the *reference bytes* for the port: its engine must
reproduce them to <= 1 LSB after the uint8 round-trip. They
model the semantics the upstream reference obtains from OpenCV
(cv2.resize INTER_NEAREST/INTER_LINEAR, cv2.GaussianBlur with
BORDER_REPLICATE, cv2.remap INTER_LINEAR with BORDER_CONSTANT), written
from the published OpenCV index/weight conventions:

- nearest resize:  src_index = floor(dst_index * src/dst)
- bilinear resize: fx = (dst+0.5)*scale - 0.5, 2-tap lerp, edge clamp
- remap bilinear:  full-float coordinates (verified: OpenCV 5.0 remap of
  CV_32F images does not fixed-point-quantize), out-of-bounds taps read
  the constant border (0)
- Gaussian kernel: exp(-i^2 / (2 sigma^2)) normalized, computed in f64,
  cast to f32

Everything runs in float32 like the reference chain (crt_filter.py:569).
"""

from __future__ import annotations

import numpy as np


def nearest_index_map(src: int, dst: int) -> np.ndarray:
    """cv2.INTER_NEAREST source index for each destination index."""
    scale = src / float(dst)
    idx = np.floor(np.arange(dst, dtype=np.float64) * scale).astype(np.int64)
    return np.clip(idx, 0, src - 1).astype(np.int32)


def bilinear_taps(src: int, dst: int) -> tuple[np.ndarray, np.ndarray]:
    """(lo_index int32 [dst], frac float32 [dst]) for one axis of a
    cv2.INTER_LINEAR float resize. Edge behaviour: clamp (replicate)."""
    if src == 1:
        return np.zeros(dst, np.int32), np.zeros(dst, np.float32)
    scale = src / float(dst)
    fx = (np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5
    lo = np.floor(fx)
    frac = fx - lo
    lo = np.clip(lo, 0, src - 2).astype(np.int32)
    frac = np.clip(fx - lo, 0.0, 1.0).astype(np.float32)
    return lo, frac


def resize_bilinear(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Bilinear resize of float32 (H, W[, C]) data, separable, edge-clamped."""
    img = np.asarray(img, dtype=np.float32)
    h, w = img.shape[:2]
    ylo, yf = bilinear_taps(h, out_h)
    xlo, xf = bilinear_taps(w, out_w)
    yf_b = yf.reshape(-1, *([1] * (img.ndim - 1)))
    rows = img[ylo] * (1.0 - yf_b) + img[np.minimum(ylo + 1, h - 1)] * yf_b
    xf_b = xf.reshape(1, -1, *([1] * (img.ndim - 2)))
    out = rows[:, xlo] * (1.0 - xf_b) + rows[:, np.minimum(xlo + 1, w - 1)] * xf_b
    return out.astype(np.float32)


def gaussian_kernel_1d(ksize: int, sigma: float) -> np.ndarray:
    """Normalized 1-D Gaussian taps (computed in f64, returned f32)."""
    if ksize <= 1:
        return np.ones(1, dtype=np.float32)
    c = (ksize - 1) / 2.0
    x = np.arange(ksize, dtype=np.float64) - c
    k = np.exp(-(x * x) / (2.0 * float(sigma) * float(sigma)))
    k /= k.sum()
    return k.astype(np.float32)


def _conv1d_replicate(img: np.ndarray, kernel: np.ndarray, axis: int) -> np.ndarray:
    """Correlate float32 data with a 1-D kernel along ``axis`` with edge
    replication. Taps accumulate in kernel order (defines the rounding
    order the port's blur mirrors)."""
    k = kernel.shape[0]
    if k == 1:
        return img * kernel[0]
    r = k // 2
    pad = [(0, 0)] * img.ndim
    pad[axis] = (r, r)
    padded = np.pad(img, pad, mode="edge")
    out = np.zeros_like(img, dtype=np.float32)
    for i in range(k):
        sl = [slice(None)] * img.ndim
        sl[axis] = slice(i, i + img.shape[axis])
        out += kernel[i] * padded[tuple(sl)]
    return out


def gaussian_blur_replicate(
    img: np.ndarray, ksize_x: int, ksize_y: int, sigma_x: float, sigma_y: float
) -> np.ndarray:
    """Separable Gaussian blur with replicate borders on (H, W[, C]) float32.

    Mirrors cv2.GaussianBlur((kx, ky), sigmaX, sigmaY, BORDER_REPLICATE) as
    used at crt_filter.py:610 (bloom, square kernel) and :234 (triad
    softness, horizontal-only (k, 1) kernel).
    """
    out = np.asarray(img, dtype=np.float32)
    if ksize_x > 1:
        out = _conv1d_replicate(out, gaussian_kernel_1d(ksize_x, sigma_x), axis=1)
    if ksize_y > 1:
        out = _conv1d_replicate(out, gaussian_kernel_1d(ksize_y, sigma_y), axis=0)
    return out


def split_map(m: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Split float sample coordinates into (floor int32, f32 fraction).

    Verified against the installed OpenCV (5.0): remap of CV_32F images
    interpolates at full float precision (no 1/32-px fixed-point
    quantization), so the split is a plain floor/frac.
    """
    m = np.asarray(m, dtype=np.float32)
    lo = np.floor(m).astype(np.int32)
    frac = (m - lo).astype(np.float32)
    return lo, frac


def remap_bilinear_const0(img: np.ndarray, map_x: np.ndarray, map_y: np.ndarray) -> np.ndarray:
    """Bilinear gather at float coordinates with constant-0 border.

    Mirrors cv2.remap(..., INTER_LINEAR, BORDER_CONSTANT, 0) as used for
    the barrel warp (crt_filter.py:347).
    """
    img = np.asarray(img, dtype=np.float32)
    h, w = img.shape[:2]
    x0, fx = split_map(map_x)
    y0, fy = split_map(map_y)

    def tap(yi, xi):
        valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        yc = np.clip(yi, 0, h - 1)
        xc = np.clip(xi, 0, w - 1)
        v = img[yc, xc]
        if img.ndim == 3:
            return np.where(valid[..., None], v, 0.0).astype(np.float32)
        return np.where(valid, v, 0.0).astype(np.float32)

    if img.ndim == 3:
        fx_b, fy_b = fx[..., None], fy[..., None]
    else:
        fx_b, fy_b = fx, fy
    w00 = (1.0 - fy_b) * (1.0 - fx_b)
    w01 = (1.0 - fy_b) * fx_b
    w10 = fy_b * (1.0 - fx_b)
    w11 = fy_b * fx_b
    out = (
        w00 * tap(y0, x0)
        + w01 * tap(y0, x0 + 1)
        + w10 * tap(y0 + 1, x0)
        + w11 * tap(y0 + 1, x0 + 1)
    )
    return out.astype(np.float32)


def to_uint8(img: np.ndarray) -> np.ndarray:
    """float[0,1] -> uint8 with round-half-to-even saturation.

    Mirrors cv2.convertScaleAbs(img, alpha=255) (crt_filter.py:696, :1098):
    cvRound rounds half to even, then saturates.
    """
    return np.clip(np.rint(np.asarray(img, np.float32) * 255.0), 0, 255).astype(np.uint8)
