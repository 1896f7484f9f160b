"""Static-index resampling in PyTorch.

Port of pythoncrt_tpu/ops/resize.py. The index maps and bilinear taps
come from the port's NumPy oracle (oracle/ops.py), so device
results are the ground truth's: gathers plus f32 lerps in the oracle's
order. Replaces cv2.resize at crt_filter.py:582-583 (pixelate) and :642
(the grain upsample).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import oracle


def plane_index_maps(h: int, w: int, pixel_size: int, aberration_px: int,
                     corder=(0, 1, 2)) -> tuple[np.ndarray, np.ndarray]:
    """Stages 2+3 as index maps on the source frame: (y_map (H,), x_maps
    (3, W)) with x_maps[i] the map of plane i (colour corder[i]).

    Aberration rolls R by +ab and B by -ab (crt_filter.py:740-746) and
    pixelate is a composed nearest gather (:747-753); both are static
    maps on x, so they compose into one map per colour (engine.py:531-537
    of the JAX package)."""
    if pixel_size > 1:
        y_map, x_map = oracle.pixelate_index_maps(h, w, pixel_size)
    else:
        y_map, x_map = np.arange(h), np.arange(w)
    ab = int(aberration_px)
    by_color = ((x_map - ab) % w, x_map, (x_map + ab) % w)
    x_maps = np.stack([by_color[c] for c in corder])
    return y_map.astype(np.int32), x_maps.astype(np.int32)


def remap_planes(frames: torch.Tensor, y_map: torch.Tensor,
                 x_maps: torch.Tensor) -> torch.Tensor:
    """out[b, i, y, x] = frames[b, i, y_map[y], x_maps[i, x]] on (B, 3, H, W)."""
    rows = frames[:, :, y_map.long()]
    idx = x_maps.long()[None, :, None, :].expand(rows.shape[0], 3, rows.shape[2], -1)
    return torch.gather(rows, 3, idx)


def resize_bilinear(img: torch.Tensor, ylo: torch.Tensor, yfrac: torch.Tensor,
                    xlo: torch.Tensor, xfrac: torch.Tensor) -> torch.Tensor:
    """Separable bilinear resize over the last two axes with the oracle's
    taps (oracle.ops.bilinear_taps): rows first, then columns, each
    ``lo * (1 - f) + hi * f`` in f32 (oracle.ops.resize_bilinear)."""
    h, w = img.shape[-2], img.shape[-1]
    yhi = torch.clamp(ylo + 1, max=h - 1)
    xhi = torch.clamp(xlo + 1, max=w - 1)
    fy = yfrac[:, None]
    rows = img[..., ylo, :] * (1.0 - fy) + img[..., yhi, :] * fy
    return rows[..., xlo] * (1.0 - xfrac) + rows[..., xhi] * xfrac

