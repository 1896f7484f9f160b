"""Ground-truth CPU effect engine (NumPy, single frame).

Faithful re-implementation of the reference effect chain
(crt_filter.py:702-861 export engine — the canonical one — with the
preview-engine glitch variant of :664-686 selectable). This module is
the referee: the port's outputs are tested against it to <= 1 LSB per
channel after the uint8 round-trip, and it is also the single source of
truth for mask/LUT/warp-table constants uploaded to the device.

Stage order (SURVEY.md §3.3):
  1 u8->f32/255  2 aberration  3 pixelate  4 color  5 text(before)
  6 bloom  7 triad  8 scanlines  9 vignette  10 flicker  11 noise
  12 warp  13 text(after)  14 glitch  [15 persistence+u8: persistence_blend, ops.to_uint8]
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..params import EffectParams
from . import ops

REC709_R, REC709_G, REC709_B = 0.2126, 0.7152, 0.0722  # crt_filter.py:254
TRIAD_LUT_SIZE = 1024  # crt_filter.py:246


# --------------------------------------------------------------------------
# Mask / table builders (host constants the engine uploads)
# --------------------------------------------------------------------------

def scanline_mask_1d(h: int, strength: float, period_px: float, phase_px: float) -> np.ndarray:
    """1-D horizontal scanline mask (crt_filter.py:213-217).

    line[y] = 1 - strength * 0.5 * (1 + sin(2*pi/period * (y + phase)))
    """
    y = np.arange(h, dtype=np.float32)
    s = 0.5 * (1.0 + np.sin((2.0 * np.pi / max(1e-6, period_px)) * (y + phase_px)))
    return (1.0 - strength * s).astype(np.float32)


def scanline_slant(h: int, w: int, angle_deg: float) -> np.ndarray:
    """Static part of the 2-D scanline mask: y + tan(angle) * x
    (crt_filter.py:319-321). Precomputed once; phase is added per frame."""
    yy, xx = np.mgrid[0:h, 0:w]
    return (yy + np.tan(np.deg2rad(float(angle_deg))) * xx).astype(np.float32)


def scanline_mask_2d(
    h: int,
    w: int,
    strength: float,
    period_px: float,
    phase_px: float,
    angle_deg: float,
    thickness: float,
    slant: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Angled/shaped 2-D scanline mask (crt_filter.py:308-328)."""
    if strength <= 0.0:
        return np.ones((h, w), dtype=np.float32)
    if slant is None:
        slant = scanline_slant(h, w, angle_deg)
    omega = np.float32(2.0 * np.pi / max(1e-6, float(period_px)))
    s = 0.5 * (1.0 + np.sin(omega * (slant + np.float32(phase_px))))
    sharp = float(np.clip(float(thickness), 0.1, 4.0))
    shaped = np.power(s, np.float32(1.0 / sharp), dtype=np.float32)
    return (1.0 - np.float32(strength) * shaped).astype(np.float32)


def triad_mask(h: int, w: int, strength: float, softness_px: float = 0.0) -> np.ndarray:
    """RGB aperture-grille phosphor mask (crt_filter.py:220-235).

    Channel c is bright on columns where x % 3 == c; optional
    horizontal-only Gaussian soften with k = max(3, round(s*3)*2+1).
    """
    x = np.arange(w)
    base = 1.0 - float(strength)
    cols = np.stack([(x % 3 == c).astype(np.float32) for c in range(3)], axis=-1)
    row = (base + float(strength) * cols).astype(np.float32)  # (W, 3)
    mask = np.broadcast_to(row[None, :, :], (h, w, 3)).copy()
    s = float(max(0.0, softness_px))
    if s > 0.0:
        k = max(3, int(round(s * 3)) * 2 + 1)
        mask = ops.gaussian_blur_replicate(mask, ksize_x=k, ksize_y=1, sigma_x=s, sigma_y=0.0)
    return mask.astype(np.float32)


def vignette_mask(h: int, w: int, strength: float) -> np.ndarray:
    """Elliptical vignette: v = 1 - strength * clip(r^2, 0, 1) (crt_filter.py:266-276)."""
    yy, xx = np.mgrid[0:h, 0:w]
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    rx, ry = max(1.0, w / 2.0), max(1.0, h / 2.0)
    nx = (xx - cx) / rx
    ny = (yy - cy) / ry
    r2 = nx * nx + ny * ny
    return (1.0 - strength * np.clip(r2, 0.0, 1.0)).astype(np.float32)


def triad_luts(gamma: float) -> tuple[np.ndarray, np.ndarray]:
    """(forward, inverse) 1025-entry power LUTs (crt_filter.py:246-260)."""
    lut_x = np.linspace(0.0, 1.0, TRIAD_LUT_SIZE + 1, dtype=np.float32)
    lut_g = np.power(lut_x, np.float32(gamma), dtype=np.float32)
    lut_inv = np.power(lut_x, np.float32(1.0 / gamma), dtype=np.float32)
    return lut_g, lut_inv


def barrel_warp_maps(h: int, w: int, strength: float) -> tuple[np.ndarray, np.ndarray]:
    """Inverse-map sample coordinates for the barrel warp (crt_filter.py:331-346).

    r' = r * (1 + 0.5*strength*r^2) in coordinates normalized by the
    half-extents; negative strength gives pincushion.
    """
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    x = (np.arange(w, dtype=np.float32) - cx) / max(1.0, cx)
    y = (np.arange(h, dtype=np.float32) - cy) / max(1.0, cy)
    xv, yv = np.meshgrid(x, y)
    factor = 1.0 + (float(strength) * 0.5) * (xv * xv + yv * yv)
    map_x = (xv * factor * cx + cx).astype(np.float32)
    map_y = (yv * factor * cy + cy).astype(np.float32)
    return map_x, map_y


def pixelate_index_maps(h: int, w: int, pixel_size: int) -> tuple[np.ndarray, np.ndarray]:
    """Composed nearest-down-then-up index maps for the mosaic stage
    (crt_filter.py:578-584). Returns (y_map [h], x_map [w]) into the source."""
    sw = max(1, w // int(pixel_size))
    sh = max(1, h // int(pixel_size))
    y_down = ops.nearest_index_map(h, sh)
    x_down = ops.nearest_index_map(w, sw)
    y_up = ops.nearest_index_map(sh, h)
    x_up = ops.nearest_index_map(sw, w)
    return y_down[y_up], x_down[x_up]


# --------------------------------------------------------------------------
# Per-frame random fields (host RNG — exact reference streams)
# --------------------------------------------------------------------------

def glitch_rows(h: int, frac: float) -> tuple[int, int]:
    """(y0, num_rows) of the glitched bottom band (crt_filter.py:667)."""
    y0 = max(0, min(h, h - int(h * frac)))
    return y0, h - y0


def glitch_fields_export(
    h: int, w: int, phase_px: float, amp_px: int, height_frac: float
) -> tuple[np.ndarray, np.ndarray, int]:
    """Per-(row, segment) glitch offsets, export algorithm (crt_filter.py:835-858).

    Returns (base [rows] f32, seg_offsets [rows, num_segs] f32, seg_len).
    Draw order matches the reference exactly: standard_normal((rows, segs))
    then standard_normal(rows), from default_rng(seed) with
    seed = (int(|phase|*2) + (w<<10) + (h<<1)) & 0xFFFFFFFF.
    """
    y0, rows = glitch_rows(h, height_frac)
    seg_len = max(8, min(32, w // 120 if w >= 120 else 8))
    num_segs = (w + seg_len - 1) // seg_len
    if rows <= 0:
        return np.zeros(0, np.float32), np.zeros((0, num_segs), np.float32), seg_len
    seed = (int(abs(float(phase_px)) * 2.0) + (w << 10) + (h << 1)) & 0xFFFFFFFF
    rng = np.random.default_rng(seed)
    ridx = np.arange(rows, dtype=np.float32)
    amp_rows = float(amp_px) * (1.0 - (ridx / max(1.0, float(rows))))
    seg_offsets = rng.standard_normal((rows, num_segs)).astype(np.float32) * (
        amp_rows[:, None] * 0.7
    )
    base = np.cumsum(rng.standard_normal(rows).astype(np.float32)) * 0.1
    base = np.clip(base, -amp_rows * 0.4, amp_rows * 0.4).astype(np.float32)
    return base, seg_offsets, seg_len


def glitch_offsets_preview(
    h: int, w: int, phase_px: float, amp_px: int, height_frac: float
) -> np.ndarray:
    """Per-row glitch offsets, preview algorithm (crt_filter.py:664-679).

    seed = (int(|phase|*0.05) + (w<<10) + (h<<1)) & 0xFFFFFFFF; per-row
    offset = clip(N(0,0.5), +-1) plus 3%-probability +-1 jumps, scaled by
    exponentially decaying amplitude.
    """
    y0, rows = glitch_rows(h, height_frac)
    if rows <= 0:
        return np.zeros(0, np.float32)
    seed = (int(abs(float(phase_px)) * 0.05) + (w << 10) + (h << 1)) & 0xFFFFFFFF
    rng = np.random.default_rng(seed)
    ridx = np.arange(rows, dtype=np.float32)
    amp_rows = (float(amp_px) * np.exp(-3.0 * (ridx / max(1.0, float(rows))))).astype(np.float32)
    base = np.clip(rng.normal(0.0, 0.5, rows).astype(np.float32), -1.0, 1.0)
    jump_mask = rng.random(rows).astype(np.float32) < 0.03
    jump_sign = rng.choice(np.array([-1.0, 1.0], dtype=np.float32), size=rows)
    base = base + jump_mask * jump_sign
    return np.clip(base * amp_rows, -amp_rows, amp_rows).astype(np.float32)


def flicker_factor(strength: float, hz: float, time_sec: float) -> float:
    """Scalar flicker gain (crt_filter.py:632), computed in f64 like NumPy."""
    return float(1.0 + 0.25 * float(strength) * np.sin(2.0 * np.pi * float(hz) * float(time_sec)))


# --------------------------------------------------------------------------
# Stage implementations
# --------------------------------------------------------------------------

def apply_color_adjustments(
    img: np.ndarray,
    brightness: float,
    contrast: float,
    gamma: float,
    saturation: float,
    temperature: float,
) -> np.ndarray:
    """Saturation -> temperature -> brightness/contrast -> gamma, each
    clipped and skipped at identity (crt_filter.py:279-305)."""
    if saturation != 1.0:
        luma = REC709_R * img[..., 0] + REC709_G * img[..., 1] + REC709_B * img[..., 2]
        img = np.clip(luma[..., None] + (img - luma[..., None]) * np.float32(saturation), 0.0, 1.0)
    if temperature != 0.0:
        t = float(temperature)
        r_gain = np.float32(np.clip(1.0 + 0.5 * t, 0.5, 1.5))
        b_gain = np.float32(np.clip(1.0 - 0.5 * t, 0.5, 1.5))
        img = img.copy()
        img[..., 0] = np.clip(img[..., 0] * r_gain, 0.0, 1.0)
        img[..., 2] = np.clip(img[..., 2] * b_gain, 0.0, 1.0)
    if brightness != 0.0 or contrast != 1.0:
        img = np.clip(
            (img - np.float32(0.5)) * np.float32(contrast) + np.float32(0.5) + np.float32(brightness),
            0.0,
            1.0,
        )
    if gamma != 1.0 and gamma > 0.0:
        img = np.clip(np.power(img, np.float32(1.0 / float(gamma)), dtype=np.float32), 0.0, 1.0)
    return img.astype(np.float32)


def apply_triad(
    img: np.ndarray,
    mask: np.ndarray,
    gamma: float,
    preserve_luma: bool,
    luts: Optional[tuple[np.ndarray, np.ndarray]] = None,
) -> np.ndarray:
    """Gamma-aware, optionally luma-preserving triad multiply with the
    reference's 1024-bin LUT quantization (crt_filter.py:238-263)."""
    g = float(gamma)
    if ((not preserve_luma) and abs(g - 1.0) < 1e-3) or g <= 0.0:
        return np.clip(img * mask, 0.0, 1.0)
    lut_g, lut_inv = luts if luts is not None else triad_luts(g)
    scale = np.float32(TRIAD_LUT_SIZE)
    idx = np.clip((np.clip(img, 0.0, 1.0) * scale).astype(np.int32), 0, TRIAD_LUT_SIZE)
    lin = lut_g[idx]
    out_lin = lin * mask
    if preserve_luma:
        y_before = REC709_R * lin[..., 0] + REC709_G * lin[..., 1] + REC709_B * lin[..., 2]
        y_after = REC709_R * out_lin[..., 0] + REC709_G * out_lin[..., 1] + REC709_B * out_lin[..., 2]
        ratio = np.clip(y_before / np.maximum(y_after, 1e-6), 0.5, 2.0)
        out_lin = out_lin * ratio[..., None]
    idx2 = np.clip((np.clip(out_lin, 0.0, 1.0) * scale).astype(np.int32), 0, TRIAD_LUT_SIZE)
    return np.clip(lut_inv[idx2], 0.0, 1.0)


def composite_text(img: np.ndarray, rgba: np.ndarray) -> np.ndarray:
    """Alpha-over composite of a uint8 RGBA overlay (crt_filter.py:588-597)."""
    alpha = rgba[..., 3:4].astype(np.float32) / 255.0
    rgb = rgba[..., :3].astype(np.float32) / 255.0
    return np.clip(img * (1.0 - alpha) + rgb * alpha, 0.0, 1.0)


def apply_glitch_gather(img: np.ndarray, y0: int, offsets_px: np.ndarray) -> np.ndarray:
    """Modulo-wrap horizontal gather of the bottom band by per-(row[,col])
    rounded pixel offsets (crt_filter.py:680-685, :852-858)."""
    h, w = img.shape[:2]
    if y0 >= h or offsets_px.size == 0:
        return img
    bottom = img[y0:]
    x = np.arange(w, dtype=np.int32)[None, :]
    if offsets_px.ndim == 1:
        offs = np.rint(offsets_px)[:, None].astype(np.int32)
    else:
        offs = np.rint(offsets_px).astype(np.int32)
    xi = (x + offs) % w
    out = img.copy()
    out[y0:] = np.take_along_axis(bottom, np.broadcast_to(xi[:, :, None], bottom.shape), axis=1)
    return out


# --------------------------------------------------------------------------
# Full chain
# --------------------------------------------------------------------------

def apply_effects(
    frame_u8: np.ndarray,
    p: EffectParams,
    *,
    phase_px: float = 0.0,
    time_sec: float = 0.0,
    triad: Optional[np.ndarray] = None,
    vignette: Optional[np.ndarray] = None,
    text_rgba: Optional[np.ndarray] = None,
    noise_field: Optional[np.ndarray] = None,
    engine: str = "export",
) -> np.ndarray:
    """One frame through the full stateless chain; returns float32 in [0, 1].

    ``noise_field``: standard-normal field of shape (h//grain, w//grain)
    (pre-upsample). The reference draws it from OpenCV's *global* RNG
    (cv2.randn, crt_filter.py:641) whose stream depends on thread timing,
    so no byte-exact stream exists to match; this framework's convention
    is an injected field (tests) or a counter-based per-frame key
    (production; see engine.py).
    ``engine``: "export" (canonical, crt_filter.py:702-861) or "preview"
    (crt_filter.py:531-686 glitch variant).
    """
    h, w = frame_u8.shape[:2]
    img = frame_u8.astype(np.float32) / 255.0

    if p.aberration_on:  # stage 2, crt_filter.py:740-746
        img = np.stack(
            [
                np.roll(img[..., 0], p.aberration_px, axis=1),
                img[..., 1],
                np.roll(img[..., 2], -p.aberration_px, axis=1),
            ],
            axis=-1,
        )

    if p.pixelate_on:  # stage 3, crt_filter.py:747-753
        y_map, x_map = pixelate_index_maps(h, w, p.pixel_size)
        img = img[y_map][:, x_map]

    img = apply_color_adjustments(  # stage 4
        img, p.brightness, p.contrast, p.gamma, p.saturation, p.temperature
    )

    if text_rgba is not None and not p.text.after:  # stage 5
        img = composite_text(img, text_rgba)

    if p.bloom_on:  # stage 6, crt_filter.py:769-781
        src = img
        if p.bloom_threshold > 0.0:
            thr = np.float32(min(0.99, max(0.0, p.bloom_threshold)))
            src = np.clip((img - thr) / max(1e-6, (1.0 - float(thr))), 0.0, 1.0)
        if p.fast_bloom:
            ds = ops.resize_bilinear(src, max(1, h // 2), max(1, w // 2))
            blur = ops.resize_bilinear(ds, h, w)
        else:
            k = max(1, int(round(p.bloom_sigma * 3)) * 2 + 1)
            blur = ops.gaussian_blur_replicate(src, k, k, p.bloom_sigma, p.bloom_sigma)
        img = np.clip(img + np.float32(p.bloom_strength) * blur, 0.0, 1.0)

    # stage 7 gates on mask presence like the reference (crt_filter.py:783):
    # an explicitly passed mask applies regardless of triad_strength
    if triad is None and p.triad_on:
        triad = triad_mask(h, w, p.triad_strength, p.triad_softness)
    if triad is not None:
        img = apply_triad(img, triad, p.triad_gamma, p.triad_preserve_luma)

    if p.scanlines_on:  # stage 8, crt_filter.py:787-794
        if p.scanlines_1d:
            sl = scanline_mask_1d(h, p.scanline_strength, p.scanline_period_px, phase_px)
            img = np.clip(img * sl[:, None, None], 0.0, 1.0)
        else:
            sl2 = scanline_mask_2d(
                h, w, p.scanline_strength, p.scanline_period_px, phase_px,
                p.scanline_angle, p.scanline_thickness,
            )
            img = np.clip(img * sl2[:, :, None], 0.0, 1.0)

    # stage 9 likewise gates on mask presence (crt_filter.py:796)
    if vignette is None and p.vignette_on:
        vignette = vignette_mask(h, w, p.vignette_strength)
    if vignette is not None:
        img = np.clip(img * vignette[:, :, None], 0.0, 1.0)

    if p.flicker_on:  # stage 10
        img = np.clip(img * np.float32(flicker_factor(p.flicker_strength, p.flicker_hz, time_sec)), 0.0, 1.0)

    if p.noise_on and noise_field is not None:  # stage 11, crt_filter.py:805-817
        if p.grain_size > 1:
            noise = ops.resize_bilinear(noise_field.astype(np.float32), h, w)
        else:
            noise = noise_field.astype(np.float32)
        noise = noise * np.float32(p.noise_strength / 255.0)
        img = np.clip(img + noise[:, :, None], 0.0, 1.0)

    if p.warp_on:  # stage 12
        map_x, map_y = barrel_warp_maps(h, w, p.warp_strength)
        img = ops.remap_bilinear_const0(img, map_x, map_y)

    if text_rgba is not None and p.text.after:  # stage 13
        img = composite_text(img, text_rgba)

    if p.glitch_on:  # stage 14
        y0, rows = glitch_rows(h, p.glitch_height_frac)
        if rows > 0:
            if engine == "preview":
                offs = glitch_offsets_preview(h, w, phase_px, p.glitch_amp_px, p.glitch_height_frac)
            else:
                base, seg, seg_len = glitch_fields_export(
                    h, w, phase_px, p.glitch_amp_px, p.glitch_height_frac
                )
                seg_index = (np.arange(w, dtype=np.int32) // int(seg_len)).astype(np.int32)
                offs = base[:, None] + seg[np.arange(rows)[:, None], seg_index[None, :]]
            img = apply_glitch_gather(img, y0, offs)

    return img.astype(np.float32)


def persistence_blend(prev: Optional[np.ndarray], cur: np.ndarray, persistence: float) -> np.ndarray:
    """Serial persistence IIR: clip(p*prev + (1-p)*cur, 0, 1)
    (crt_filter.py:1086-1096). The carry is the *blended* output frame.

    A previous state whose shape mismatches (preview resolution changed
    mid-stream) is bilinearly resized and blended, not dropped — the
    reference's behavior (crt_filter.py:689-693)."""
    if prev is None or persistence <= 0.0:
        return cur
    if prev.shape != cur.shape:
        import cv2

        prev = cv2.resize(prev, (cur.shape[1], cur.shape[0]),
                          interpolation=cv2.INTER_LINEAR)
    return np.clip(
        np.float32(persistence) * prev + np.float32(1.0 - persistence) * cur, 0.0, 1.0
    ).astype(np.float32)
