"""Colour stages in PyTorch: grading, the triad, the uint8 cast.

Port of pythoncrt_tpu/ops/color.py. Every function keeps the reference's
f32 op order element for element (the triad's 1024-bin quantize turns a
one-ulp change upstream into a visible step), and these functions are
also the fused kernel's plain twin (kernels/fused.py).

Two rounding rules differ from a plain ``torch.pow``:

- ``powf_rn`` evaluates pow in double and rounds once to float, so the
  grade and the triad tables are the correctly rounded f32 results on
  every device (the CUDA kernel computes the same thing).
- ``pow_final`` is the JAX package's final triad site,
  ``exp2(e * log2(x))``, with each transcendental correctly rounded the
  same way.
"""

from __future__ import annotations

import numpy as np
import torch

REC709_R, REC709_G, REC709_B = 0.2126, 0.7152, 0.0722
TRIAD_LUT_SIZE = 1024


def powf_rn(x: torch.Tensor, e: float) -> torch.Tensor:
    """f32 pow rounded once from double: ``float(pow(double(x), double(f32(e))))``."""
    return torch.pow(x.double(), float(np.float32(e))).float()


def pow_final(x: torch.Tensor, e: float) -> torch.Tensor:
    """exp2(f32(e) * log2(x)) in f32 steps, each transcendental rounded
    once from double (x >= 0; log2(0) = -inf gives 0)."""
    t = torch.log2(x.double()).float()
    y = t * float(np.float32(e))
    return torch.exp2(y.double()).float()


def triad_tables(gamma: float, device="cpu") -> tuple[torch.Tensor, torch.Tensor]:
    """(forward, final) 1025-entry tables over the LUT grid i/1024: the
    triad's two pow sites evaluated once per grid value. The inputs of
    both sites are always on that grid (``_quantize_lut``), so a table
    read is the pow itself."""
    q = torch.arange(TRIAD_LUT_SIZE + 1, dtype=torch.float32) * np.float32(1.0 / TRIAD_LUT_SIZE)
    g = float(gamma)
    return powf_rn(q, g).to(device), pow_final(q, 1.0 / g).to(device)


def rec709_luma(img: torch.Tensor, corder=(0, 1, 2), dim: int = -1) -> torch.Tensor:
    """R*0.2126 + G*0.7152 + B*0.0722 summed in R, G, B order, whatever
    plane order ``corder`` (plane i holds colour corder[i]) the data has."""
    ir, ig, ib = corder.index(0), corder.index(1), corder.index(2)
    sel = lambda i: img.select(dim, i)  # noqa: E731
    return (np.float32(REC709_R) * sel(ir) + np.float32(REC709_G) * sel(ig)
            + np.float32(REC709_B) * sel(ib))


def _channel_vec(vals, img: torch.Tensor, dim: int) -> torch.Tensor:
    shape = [1] * img.ndim
    shape[dim] = 3
    return torch.tensor(np.asarray(vals, np.float32), device=img.device).reshape(shape)


def temperature_gains(temperature: float) -> tuple[float, float]:
    """(red, blue) gains of the temperature stage (crt_filter.py:293-298)."""
    t = float(temperature)
    return (float(np.clip(1.0 + 0.5 * t, 0.5, 1.5)),
            float(np.clip(1.0 - 0.5 * t, 0.5, 1.5)))


def grade(img: torch.Tensor, saturation: float = 1.0, temp_r: float = 1.0,
          temp_b: float = 1.0, brightness: float = 0.0, contrast: float = 1.0,
          inv_gamma: float = 1.0, corder=(0, 1, 2), dim: int = -1) -> torch.Tensor:
    """The grade with its constants resolved: saturation -> per-colour
    gains -> brightness/contrast -> pow(1/gamma), each clipped to [0, 1]
    and skipped at identity. ``dim`` is the channel axis and ``corder``
    its colour order."""
    if saturation != 1.0:
        luma = rec709_luma(img, corder, dim).unsqueeze(dim)
        img = torch.clamp(luma + (img - luma) * np.float32(saturation), 0.0, 1.0)
    if temp_r != 1.0 or temp_b != 1.0:
        by_color = (temp_r, 1.0, temp_b)
        img = torch.clamp(img * _channel_vec([by_color[c] for c in corder], img, dim),
                          0.0, 1.0)
    if brightness != 0.0 or contrast != 1.0:
        img = torch.clamp((img - np.float32(0.5)) * np.float32(contrast)
                          + np.float32(0.5) + np.float32(brightness), 0.0, 1.0)
    if inv_gamma != 1.0:
        img = torch.clamp(powf_rn(img, inv_gamma), 0.0, 1.0)
    return img


def color_adjust(img: torch.Tensor, brightness: float, contrast: float,
                 gamma: float, saturation: float, temperature: float,
                 corder=(0, 1, 2), dim: int = -1) -> torch.Tensor:
    """Saturation -> temperature -> brightness/contrast -> gamma
    (crt_filter.py:279-305), each clipped and skipped at identity."""
    temp_r, temp_b = temperature_gains(temperature) if temperature != 0.0 else (1.0, 1.0)
    inv_gamma = 1.0 / float(gamma) if (gamma != 1.0 and gamma > 0.0) else 1.0
    return grade(img, saturation, temp_r, temp_b, brightness, contrast,
                 inv_gamma, corder, dim)


def _quantize_index(img: torch.Tensor) -> torch.Tensor:
    """LUT bin of each value: trunc(clip(x, 0, 1) * 1024) (crt_filter.py:250)."""
    idx = (torch.clamp(img, 0.0, 1.0) * TRIAD_LUT_SIZE).to(torch.int32)
    return torch.clamp(idx, 0, TRIAD_LUT_SIZE).long()


def _quantize_lut(img: torch.Tensor) -> torch.Tensor:
    """Snap values to the reference's 1024-bin LUT grid."""
    return _quantize_index(img).float() * np.float32(1.0 / TRIAD_LUT_SIZE)


def triad_is_multiply(gamma: float, preserve_luma: bool) -> bool:
    """apply_triad's early-out: a plain clipped multiply (crt_filter.py:247)."""
    g = float(gamma)
    return ((not preserve_luma) and abs(g - 1.0) < 1e-3) or g <= 0.0


def apply_triad_planar(imgs: torch.Tensor, mask: torch.Tensor, gamma: float,
                       preserve_luma: bool, corder=(0, 1, 2), tables=None,
                       lut_exact: bool = True) -> torch.Tensor:
    """The triad on (B, 3, H, W) data. mask: (3, W), row i for plane i.

    ``lut_exact`` True reads the 1024-bin tables (``tables`` from
    ``triad_tables(gamma)``, built when None), the reference's bytes;
    False is ``--precision fast``: both pow sites on the clipped values
    themselves (``powf_rn``, then ``pow_final``), as the JAX package's
    ``apply_triad(lut_exact=False)``."""
    m = mask[None, :, None, :]
    if triad_is_multiply(gamma, preserve_luma):
        return torch.clamp(imgs * m, 0.0, 1.0)
    if lut_exact:
        fwd, fin = tables if tables is not None else triad_tables(gamma, imgs.device)
        lin = fwd[_quantize_index(imgs)]
    else:
        lin = powf_rn(torch.clamp(imgs, 0.0, 1.0), gamma)
    out_lin = lin * m
    if preserve_luma:
        ratio = torch.clamp(rec709_luma(lin, corder, 1)
                            / torch.clamp(rec709_luma(out_lin, corder, 1), min=np.float32(1e-6)),
                            0.5, 2.0)
        out_lin = out_lin * ratio[:, None]
    if lut_exact:
        return torch.clamp(fin[_quantize_index(out_lin)], 0.0, 1.0)
    return torch.clamp(pow_final(torch.clamp(out_lin, 0.0, 1.0), 1.0 / float(gamma)), 0.0, 1.0)


def apply_triad(img: torch.Tensor, mask: torch.Tensor, gamma: float,
                preserve_luma: bool, tables=None, lut_exact: bool = True) -> torch.Tensor:
    """apply_triad_planar on (B, H, W, 3) data with a (W, 3) mask."""
    out = apply_triad_planar(img.permute(0, 3, 1, 2), mask.t(), gamma,
                             preserve_luma, tables=tables, lut_exact=lut_exact)
    return out.permute(0, 2, 3, 1)


def composite_text(img: torch.Tensor, alpha: torch.Tensor, rgb: torch.Tensor) -> torch.Tensor:
    """Alpha-over composite of a text overlay (crt_filter.py:595-597) on
    planar (B, 3, H, W) data: alpha (H, W) and rgb (3, H, W) in the
    data's plane order, both u8 / 255 in f32, built once on the host."""
    return torch.clamp(img * (1.0 - alpha) + rgb * alpha, 0.0, 1.0)


def to_uint8(img: torch.Tensor) -> torch.Tensor:
    """float [0, 1] -> uint8, round half to even, saturate
    (cv2.convertScaleAbs semantics, crt_filter.py:696)."""
    return torch.clamp(torch.round(img * 255.0), 0.0, 255.0).to(torch.uint8)
