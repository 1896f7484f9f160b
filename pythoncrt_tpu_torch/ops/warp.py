"""Barrel-warp bilinear gather in PyTorch (the warp kernel's plain twin).

Port of pythoncrt_tpu/ops/warp.py. The static inverse map is split on
the host (oracle.ops.split_map over oracle.barrel_warp_maps); the device
does four constant-index gathers with constant-0 out-of-frame taps and
sums them in oracle.ops.remap_bilinear_const0's order. Replaces cv2.remap
at crt_filter.py:347.
"""

from __future__ import annotations

import torch


def bilinear_gather_const0(img: torch.Tensor, y0: torch.Tensor, x0: torch.Tensor,
                           fy: torch.Tensor, fx: torch.Tensor) -> torch.Tensor:
    """Sample (..., H, W) ``img`` at the split coordinates.

    y0/x0: int32 (H, W) floor coordinates (unclamped); fy/fx: f32 (H, W)
    fractions. Taps outside the frame contribute 0 (BORDER_CONSTANT)."""
    h, w = img.shape[-2], img.shape[-1]
    flat = img.reshape(*img.shape[:-2], h * w)
    y0, x0 = y0.long(), x0.long()

    def tap(yi, xi):
        valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        idx = (torch.clamp(yi, 0, h - 1) * w + torch.clamp(xi, 0, w - 1)).reshape(-1)
        v = flat[..., idx].reshape(img.shape)
        return torch.where(valid, v, torch.zeros((), dtype=v.dtype, device=v.device))

    w00 = (1.0 - fy) * (1.0 - fx)
    w01 = (1.0 - fy) * fx
    w10 = fy * (1.0 - fx)
    w11 = fy * fx
    return (w00 * tap(y0, x0) + w01 * tap(y0, x0 + 1)
            + w10 * tap(y0 + 1, x0) + w11 * tap(y0 + 1, x0 + 1))
