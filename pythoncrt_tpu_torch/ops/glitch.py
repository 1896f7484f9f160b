"""Row-shear glitch in PyTorch: the plain shear.

Port of pythoncrt_tpu/ops/glitch.py. The per-row and per-segment random
offsets come either from the host (the reference's exact NumPy streams,
oracle.glitch_fields_export / glitch_offsets_preview, for rng="host") or
are drawn on the device, keyed by (seed, frame index) (rng="native": the
reference's distributions, not its bits, as the JAX package's jax.random
draws are): the draw kernel, kernels/rng.py, whose twin's
export_fields_ref and preview_fields_ref are the JAX package's
native_export_fields and native_preview_offsets. The shear itself runs in
the glitch kernel (kernels/glitch.py); ``shear_band`` is the per-pixel
form.
"""

from __future__ import annotations

import torch


def shear_band(img: torch.Tensor, y0: int, offsets_px: torch.Tensor) -> torch.Tensor:
    """Shift rows [y0, H) of (..., H, W) planes by f32 pixel offsets,
    rounded half to even, with modulo wrap; rows above y0 pass through.
    offsets_px: (rows, W) per pixel or (rows,) per row
    (crt_filter.py:852-858 export, :680-685 preview)."""
    h, w = img.shape[-2], img.shape[-1]
    if y0 >= h:
        return img
    offs = torch.round(offsets_px).long()
    if offs.ndim == 1:
        offs = offs[:, None]
    x = torch.arange(w, device=img.device)
    xi = torch.remainder(x[None, :] + offs, w).expand(h - y0, w)
    bottom = img[..., y0:, :]
    sheared = torch.gather(bottom, -1, xi.expand(bottom.shape))
    return torch.cat([img[..., :y0, :], sheared], dim=-2)

