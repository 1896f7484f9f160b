"""Reference-compatible API shim (pythoncrt_tpu/compat.py).

Drop-in functions with the reference's names and signatures
(crt_filter.py), so code written against jaylikesbunda/PythonCRT can
switch imports and keep working:

    from pythoncrt_tpu_torch.compat import (
        apply_crt_effect, apply_static_effects, process_video,
        make_triad_mask, make_vignette, make_scanline_mask_dynamic,
        make_scanline_mask_2d, apply_color_adjustments, apply_barrel_warp,
        shift_channel, normalize_nvenc_preset, can_use_nvenc, can_use_amf,
    )

Single-frame calls run through the port's NumPy oracle (NumPy in and
out, the reference's math bit for bit); process_video runs the port's
pipeline on the card (``device``, keyword-only, selects another torch
device). The preview/export split maps to the one-engine design via the
``engine`` argument internally (SURVEY.md §7).
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Optional, Tuple

import numpy as np

from . import oracle
from .io.video import can_use_amf, can_use_nvenc, normalize_nvenc_preset  # noqa: F401
from .params import EffectParams, TextParams


def shift_channel(arr: np.ndarray, dx: int, dy: int) -> np.ndarray:
    """np.roll wrap-around shift (crt_filter.py:207-210)."""
    if dx == 0 and dy == 0:
        return arr
    return np.roll(np.roll(arr, dy, axis=0), dx, axis=1)


def make_scanline_mask_dynamic(h, strength, period_px, phase_px):
    return oracle.scanline_mask_1d(h, strength, period_px, phase_px)


def make_scanline_mask_2d(h, w, strength, period_px, phase_px, angle_deg, thickness):
    return oracle.scanline_mask_2d(h, w, strength, period_px, phase_px, angle_deg, thickness)


def make_triad_mask(h, w, strength, softness_px=0.0):
    return oracle.triad_mask(h, w, strength, softness_px)


def make_vignette(h, w, strength):
    return oracle.vignette_mask(h, w, strength)


def apply_color_adjustments(img, brightness, contrast, gamma, saturation, temperature):
    return oracle.apply_color_adjustments(img, brightness, contrast, gamma, saturation, temperature)


def apply_barrel_warp(img, strength):
    if float(strength) == 0.0:
        return img
    h, w = img.shape[:2]
    map_x, map_y = oracle.barrel_warp_maps(h, w, strength)
    return oracle.ops.remap_bilinear_const0(img, map_x, map_y)


def _params_from_kwargs(
    scanline_strength, triad_gamma, triad_preserve_luma, aberration_px,
    bloom_sigma, bloom_strength, bloom_threshold, noise_strength,
    scanline_period_px, fast_bloom, pixel_size, glitch_amp_px,
    glitch_height_frac, brightness, contrast, gamma, saturation,
    temperature, flicker_strength, flicker_hz, grain_size, scanline_angle,
    scanline_thickness, warp_strength, text_overlay_after,
) -> EffectParams:
    return EffectParams(
        scanline_strength=scanline_strength,
        triad_strength=0.0,  # mask passed explicitly in this API
        triad_gamma=triad_gamma,
        triad_preserve_luma=triad_preserve_luma,
        aberration_px=aberration_px,
        bloom_sigma=bloom_sigma,
        bloom_strength=bloom_strength,
        bloom_threshold=bloom_threshold,
        noise_strength=noise_strength,
        vignette_strength=0.0,  # mask passed explicitly
        scanline_period_px=scanline_period_px,
        fast_bloom=fast_bloom,
        pixel_size=pixel_size,
        glitch_amp_px=glitch_amp_px,
        glitch_height_frac=glitch_height_frac,
        brightness=brightness,
        contrast=contrast,
        gamma=gamma,
        saturation=saturation,
        temperature=temperature,
        flicker_strength=flicker_strength,
        flicker_hz=flicker_hz,
        grain_size=grain_size,
        scanline_angle=scanline_angle,
        scanline_thickness=scanline_thickness,
        warp_strength=warp_strength,
        text=TextParams(text="x", after=text_overlay_after),  # gate only
    )


def _noise_field(p: EffectParams, h: int, w: int, phase: float):
    if not p.noise_on:
        return None
    g = max(1, int(p.grain_size))
    rng = np.random.default_rng(int(abs(float(phase)) * 1000) & 0xFFFFFFFF)
    return rng.standard_normal(
        (max(1, h // g), max(1, w // g)), dtype=np.float32
    )


def apply_static_effects(
    frame: np.ndarray,
    scanline_strength: float,
    triad_mask: Optional[np.ndarray],
    triad_gamma: float,
    triad_preserve_luma: bool,
    aberration_px: int,
    bloom_sigma: float,
    bloom_strength: float,
    bloom_threshold: float,
    noise_strength: float,
    vignette_mask: Optional[np.ndarray],
    scanline_period_px: float,
    scanline_phase_px: float,
    fast_bloom: bool,
    pixel_size: int,
    glitch_amp_px: int,
    glitch_height_frac: float,
    time_sec: float = 0.0,
    brightness: float = 0.0,
    contrast: float = 1.0,
    gamma: float = 1.0,
    saturation: float = 1.0,
    temperature: float = 0.0,
    flicker_strength: float = 0.0,
    flicker_hz: float = 0.0,
    grain_size: int = 1,
    scanline_angle: float = 0.0,
    scanline_thickness: float = 1.0,
    warp_strength: float = 0.0,
    text_overlay_rgba: Optional[np.ndarray] = None,
    text_overlay_after: bool = True,
) -> np.ndarray:
    """Stateless export chain: uint8 frame -> float32 [0,1]
    (reference crt_filter.py:702-861)."""
    p = _params_from_kwargs(
        scanline_strength, triad_gamma, triad_preserve_luma, aberration_px,
        bloom_sigma, bloom_strength, bloom_threshold, noise_strength,
        scanline_period_px, fast_bloom, pixel_size, glitch_amp_px,
        glitch_height_frac, brightness, contrast, gamma, saturation,
        temperature, flicker_strength, flicker_hz, grain_size,
        scanline_angle, scanline_thickness, warp_strength, text_overlay_after,
    )
    h, w = frame.shape[:2]
    return oracle.apply_effects(
        frame, p, phase_px=scanline_phase_px, time_sec=time_sec,
        triad=triad_mask, vignette=vignette_mask,
        text_rgba=text_overlay_rgba,
        noise_field=_noise_field(p, h, w, scanline_phase_px),
        engine="export",
    )


def apply_crt_effect(
    frame: np.ndarray,
    scanline_strength: float,
    triad_mask: Optional[np.ndarray],
    triad_gamma: float,
    triad_preserve_luma: bool,
    aberration_px: int,
    bloom_sigma: float,
    bloom_strength: float,
    bloom_threshold: float,
    noise_strength: float,
    vignette_mask: Optional[np.ndarray],
    persistence: float,
    state_prev: Optional[np.ndarray],
    scanline_period_px: float,
    scanline_phase_px: float,
    fast_bloom: bool,
    pixel_size: int,
    glitch_amp_px: int = 0,
    glitch_height_frac: float = 0.0,
    time_sec: float = 0.0,
    brightness: float = 0.0,
    contrast: float = 1.0,
    gamma: float = 1.0,
    saturation: float = 1.0,
    temperature: float = 0.0,
    flicker_strength: float = 0.0,
    flicker_hz: float = 0.0,
    grain_size: int = 1,
    scanline_angle: float = 0.0,
    scanline_thickness: float = 1.0,
    warp_strength: float = 0.0,
    text_overlay_rgba: Optional[np.ndarray] = None,
    text_overlay_after: bool = True,
) -> Tuple[np.ndarray, np.ndarray]:
    """Stateful preview chain: returns (uint8 frame, float32 state)
    (reference crt_filter.py:531-699)."""
    p = _params_from_kwargs(
        scanline_strength, triad_gamma, triad_preserve_luma, aberration_px,
        bloom_sigma, bloom_strength, bloom_threshold, noise_strength,
        scanline_period_px, fast_bloom, pixel_size, glitch_amp_px,
        glitch_height_frac, brightness, contrast, gamma, saturation,
        temperature, flicker_strength, flicker_hz, grain_size,
        scanline_angle, scanline_thickness, warp_strength, text_overlay_after,
    )
    h, w = frame.shape[:2]
    img = oracle.apply_effects(
        frame, p, phase_px=scanline_phase_px, time_sec=time_sec,
        triad=triad_mask, vignette=vignette_mask,
        text_rgba=text_overlay_rgba,
        noise_field=_noise_field(p, h, w, scanline_phase_px),
        engine="preview",
    )
    if state_prev is not None and persistence > 0.0:
        img = oracle.persistence_blend(
            state_prev.astype(np.float32), img, float(persistence)
        )
    return oracle.ops.to_uint8(img), img


def process_video(
    input_path,
    output_path,
    width: Optional[int],
    height: Optional[int],
    scanline_strength: float,
    triad_strength: float,
    triad_gamma: float,
    triad_preserve_luma: bool,
    triad_softness: float,
    aberration_px: int,
    bloom_sigma: float,
    bloom_strength: float,
    noise_strength: float,
    vignette_strength: float,
    persistence: float,
    fps: Optional[int],
    crf: int,
    target_bitrate_kbps: int,
    scanline_speed_px_s: float,
    scanline_period_px: float,
    fast_bloom: bool,
    pixel_size: int,
    gpu: bool,
    nvenc_preset: str,
    glitch_amp_px: int = 0,
    glitch_height_frac: float = 0.0,
    encoder_preference: str = "auto",
    decoder_preference: str = "auto",
    bloom_threshold: float = 0.0,
    brightness: float = 0.0,
    contrast: float = 1.0,
    gamma: float = 1.0,
    saturation: float = 1.0,
    temperature: float = 0.0,
    flicker_strength: float = 0.0,
    flicker_hz: float = 0.0,
    grain_size: int = 1,
    scanline_angle: float = 0.0,
    scanline_thickness: float = 1.0,
    warp_strength: float = 0.0,
    text: str = "",
    text_font: str = "",
    text_size: int = 36,
    text_color: str = "#FFFFFF",
    text_pos: Tuple[int, int] = (32, 32),
    text_after: bool = True,
    progress_cb: Optional[Callable[[float], None]] = None,
    *,
    device: str = "cuda",
) -> bool:
    """Reference process_video signature (crt_filter.py:864-912), running
    the port's pipeline on ``device``; returns used_gpu."""
    from .pipeline import process_video as _pv

    params = EffectParams(
        scanline_strength=scanline_strength,
        triad_strength=triad_strength,
        triad_gamma=triad_gamma,
        triad_preserve_luma=triad_preserve_luma,
        triad_softness=triad_softness,
        aberration_px=aberration_px,
        bloom_sigma=bloom_sigma,
        bloom_strength=bloom_strength,
        bloom_threshold=bloom_threshold,
        noise_strength=noise_strength,
        vignette_strength=vignette_strength,
        persistence=persistence,
        scanline_speed_px_s=scanline_speed_px_s,
        scanline_period_px=scanline_period_px,
        fast_bloom=fast_bloom,
        pixel_size=pixel_size,
        glitch_amp_px=glitch_amp_px,
        glitch_height_frac=glitch_height_frac,
        brightness=brightness,
        contrast=contrast,
        gamma=gamma,
        saturation=saturation,
        temperature=temperature,
        flicker_strength=flicker_strength,
        flicker_hz=flicker_hz,
        grain_size=grain_size,
        scanline_angle=scanline_angle,
        scanline_thickness=scanline_thickness,
        warp_strength=warp_strength,
        text=TextParams(
            text=text, font=text_font, size=text_size, color=text_color,
            x=text_pos[0], y=text_pos[1], after=text_after,
        ),
    ).clamped()
    return _pv(
        Path(input_path), Path(output_path), params,
        width=width, height=height, fps=fps, crf=crf,
        target_bitrate_kbps=target_bitrate_kbps, gpu=gpu,
        nvenc_preset=nvenc_preset, encoder_preference=encoder_preference,
        decoder_preference=decoder_preference, progress_cb=progress_cb,
        device=device,
    )
