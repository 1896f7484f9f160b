"""Row-shear glitch in PyTorch: the plain shear and the native draws.

Port of pythoncrt_tpu/ops/glitch.py. The per-row and per-segment random
offsets come either from the host (the reference's exact NumPy streams,
oracle.glitch_fields_export / glitch_offsets_preview, for rng="host") or
are drawn on the device from a per-frame ``torch.Generator``
(rng="native": the reference's distributions, not its bits, as the JAX
package's jax.random draws are). The shear itself runs in the glitch
kernel (kernels/glitch.py); ``shear_band`` is the per-pixel form.
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


def native_export_fields(gen: torch.Generator, rows: int, num_segs: int,
                         amp_rows: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One frame's (base (rows,), seg_offsets (rows, num_segs)) in the
    export algorithm's distribution (crt_filter.py:846-850): per-segment
    N(0, 1) * 0.7 * amp and a clipped random-walk base."""
    dev = amp_rows.device
    seg = torch.randn((rows, num_segs), generator=gen, device=dev) * (amp_rows[:, None] * 0.7)
    rw = torch.randn((rows,), generator=gen, device=dev)
    lim = amp_rows * 0.4
    return torch.clamp(torch.cumsum(rw, 0) * 0.1, -lim, lim), seg


def native_preview_offsets(gen: torch.Generator, rows: int,
                           amp_rows: torch.Tensor) -> torch.Tensor:
    """One frame's per-row offsets (rows,) in the preview algorithm's
    distribution (crt_filter.py:670-679): clip(N(0, 0.5), +-1) plus
    +-1 jumps with probability 0.03, times the decaying amplitude."""
    dev = amp_rows.device
    base = torch.clamp(torch.randn((rows,), generator=gen, device=dev) * 0.5, -1.0, 1.0)
    jump = (torch.rand((rows,), generator=gen, device=dev) < 0.03).float()
    sign = torch.where(torch.rand((rows,), generator=gen, device=dev) < 0.5, 1.0, -1.0)
    return torch.clamp((base + jump * sign) * amp_rows, -amp_rows, amp_rows)
