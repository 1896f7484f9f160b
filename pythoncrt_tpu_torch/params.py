"""Effect parameter core: typed config, legal domains, preset JSON.

The parameter surface mirrors the reference CLI and preset system
(reference: crt_filter.py:1153-1207 flag defaults, :1225-1266 clamp
ranges, :2043-2080 preset JSON keys, :2209-2222 text preset keys), field
for field with pythoncrt_tpu/params.py (tests/test_torch_copies.py holds
the two equal).

``EffectParams`` is a frozen (hashable) dataclass: an engine is built for
one parameter set, identity-valued stages are skipped when it is built,
and a new preset means a new engine.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Tuple


def _clamp(v: float, lo: float, hi: float) -> float:
    return min(hi, max(lo, v))


@dataclass(frozen=True)
class TextParams:
    """Text overlay configuration (reference crt_filter.py:905-910, :2214-2222)."""

    text: str = ""
    font: str = ""
    size: int = 36
    color: str = "#FFFFFF"
    x: int = 32
    y: int = 32
    after: bool = True  # composite after effects (stage 13) vs before (stage 5)

    @property
    def enabled(self) -> bool:
        return bool(self.text)

    def to_json_dict(self) -> dict:
        return {
            "text": self.text,
            "font": self.font,
            "size": int(self.size),
            "color": self.color,
            "x": int(self.x),
            "y": int(self.y),
            "after": bool(self.after),
        }

    @classmethod
    def from_json_dict(cls, d: dict) -> "TextParams":
        return cls(
            text=str(d.get("text", "")),
            font=str(d.get("font", "")),
            size=int(d.get("size", 36)),
            color=str(d.get("color", "#FFFFFF")),
            x=int(d.get("x", 32)),
            y=int(d.get("y", 32)),
            after=bool(d.get("after", True)),
        )


@dataclass(frozen=True)
class EffectParams:
    """All effect-chain parameters.

    Defaults match the reference CLI (crt_filter.py:1155-1206). Use
    :meth:`clamped` to apply the legal ranges of the reference driver
    (crt_filter.py:1225-1266).
    """

    scanline_strength: float = 0.6
    triad_strength: float = 0.35
    triad_gamma: float = 2.2
    triad_preserve_luma: bool = False
    triad_softness: float = 0.5
    aberration_px: int = 1
    bloom_sigma: float = 1.2
    bloom_strength: float = 0.25
    bloom_threshold: float = 0.0
    noise_strength: float = 1.5
    vignette_strength: float = 0.25
    persistence: float = 0.2
    scanline_speed_px_s: float = 30.0
    scanline_period_px: float = 2.0
    fast_bloom: bool = True
    pixel_size: int = 2
    glitch_amp_px: int = 0
    glitch_height_frac: float = 0.0
    brightness: float = 0.0
    contrast: float = 1.0
    gamma: float = 1.0
    saturation: float = 1.0
    temperature: float = 0.0
    flicker_strength: float = 0.0
    flicker_hz: float = 0.0
    grain_size: int = 1
    scanline_angle: float = 0.0
    scanline_thickness: float = 1.0
    warp_strength: float = 0.0
    text: TextParams = TextParams()

    # ---- derived stage gates (the reference's conditions) ----

    @property
    def aberration_on(self) -> bool:
        return self.aberration_px != 0  # crt_filter.py:571

    @property
    def pixelate_on(self) -> bool:
        return self.pixel_size > 1  # crt_filter.py:578

    @property
    def bloom_on(self) -> bool:
        # crt_filter.py:599
        return self.bloom_strength > 0.0 and (self.bloom_sigma > 0.0 or self.fast_bloom)

    @property
    def triad_on(self) -> bool:
        return self.triad_strength > 0.0  # mask built only then, crt_filter.py:919

    @property
    def scanlines_on(self) -> bool:
        return self.scanline_strength > 0.0  # crt_filter.py:617

    @property
    def scanlines_1d(self) -> bool:
        # 1-D fast path condition, crt_filter.py:619
        return self.scanline_angle == 0.0 and self.scanline_thickness == 1.0

    @property
    def vignette_on(self) -> bool:
        return self.vignette_strength > 0.0  # crt_filter.py:920

    @property
    def flicker_on(self) -> bool:
        return self.flicker_strength > 0.0 and self.flicker_hz > 0.0  # crt_filter.py:630

    @property
    def noise_on(self) -> bool:
        return self.noise_strength > 0.0  # crt_filter.py:635

    @property
    def warp_on(self) -> bool:
        return self.warp_strength != 0.0  # crt_filter.py:649

    @property
    def glitch_on(self) -> bool:
        return self.glitch_amp_px > 0 and self.glitch_height_frac > 0.0  # crt_filter.py:664

    @property
    def persistence_on(self) -> bool:
        return self.persistence > 0.0  # crt_filter.py:687,1086

    # ---- validation ----

    def clamped(self) -> "EffectParams":
        """Clamp every field to the reference's legal domain (crt_filter.py:1225-1266)."""
        return dataclasses.replace(
            self,
            scanline_strength=_clamp(float(self.scanline_strength), 0.0, 1.0),
            triad_strength=_clamp(float(self.triad_strength), 0.0, 1.0),
            triad_gamma=max(0.1, float(self.triad_gamma)),
            triad_softness=max(0.0, float(self.triad_softness)),
            aberration_px=int(_clamp(int(self.aberration_px), -8, 8)),
            bloom_sigma=max(0.0, float(self.bloom_sigma)),
            bloom_strength=max(0.0, float(self.bloom_strength)),
            bloom_threshold=_clamp(float(self.bloom_threshold), 0.0, 1.0),
            noise_strength=max(0.0, float(self.noise_strength)),
            vignette_strength=_clamp(float(self.vignette_strength), 0.0, 1.0),
            persistence=_clamp(float(self.persistence), 0.0, 0.95),
            scanline_period_px=max(1.0, float(self.scanline_period_px)),
            pixel_size=max(1, int(self.pixel_size)),
            glitch_amp_px=max(0, int(self.glitch_amp_px)),
            glitch_height_frac=_clamp(float(self.glitch_height_frac), 0.0, 1.0),
            gamma=max(1e-3, float(self.gamma)),
            saturation=max(0.0, float(self.saturation)),
            temperature=_clamp(float(self.temperature), -1.0, 1.0),
            flicker_strength=_clamp(float(self.flicker_strength), 0.0, 1.0),
            flicker_hz=max(0.0, float(self.flicker_hz)),
            grain_size=max(1, int(self.grain_size)),
            scanline_thickness=max(0.1, float(self.scanline_thickness)),
            warp_strength=_clamp(float(self.warp_strength), -1.0, 1.0),
        )

    # ---- preset JSON (the reference's schema, crt_filter.py:2043-2080) ----

    def to_preset_dict(
        self,
        *,
        crf: int = 18,
        bitrate_kbps: int = 0,
        nvenc_preset: str = "p4",
        gpu: bool = False,
        encoder: str = "auto",
    ) -> dict:
        return {
            "scanline": float(self.scanline_strength),
            "triad": float(self.triad_strength),
            "triad_gamma": float(self.triad_gamma),
            "triad_softness": float(self.triad_softness),
            "triad_preserve_luma": bool(self.triad_preserve_luma),
            "pixel_size": int(self.pixel_size),
            "aberration_px": int(self.aberration_px),
            "noise": float(self.noise_strength),
            "bloom_sigma": float(self.bloom_sigma),
            "bloom_strength": float(self.bloom_strength),
            "bloom_threshold": float(self.bloom_threshold),
            "vignette": float(self.vignette_strength),
            "persistence": float(self.persistence),
            "scanline_speed": float(self.scanline_speed_px_s),
            "scanline_period": float(self.scanline_period_px),
            "glitch_amp": int(self.glitch_amp_px),
            "glitch_height": float(self.glitch_height_frac),
            "crf": int(crf),
            "bitrate_kbps": int(bitrate_kbps),
            "nvenc_preset": str(nvenc_preset),
            "fast_bloom": bool(self.fast_bloom),
            "gpu": bool(gpu),
            "encoder": str(encoder),
            "brightness": float(self.brightness),
            "contrast": float(self.contrast),
            "gamma": float(self.gamma),
            "saturation": float(self.saturation),
            "temperature": float(self.temperature),
            "flicker_strength": float(self.flicker_strength),
            "flicker_hz": float(self.flicker_hz),
            "grain_size": int(self.grain_size),
            "scanline_angle": float(self.scanline_angle),
            "scanline_thickness": float(self.scanline_thickness),
            "warp_strength": float(self.warp_strength),
        }

    @classmethod
    def from_preset_dict(cls, d: dict, base: "EffectParams" = None) -> "EffectParams":
        """Apply a preset dict key by key over ``base`` (missing keys keep
        the base values: the per-key guards of crt_filter.py:2090-2161)."""
        p = base if base is not None else cls()
        mapping = {
            "scanline": ("scanline_strength", float),
            "triad": ("triad_strength", float),
            "triad_gamma": ("triad_gamma", float),
            "triad_softness": ("triad_softness", float),
            "triad_preserve_luma": ("triad_preserve_luma", bool),
            "pixel_size": ("pixel_size", int),
            "aberration_px": ("aberration_px", int),
            "noise": ("noise_strength", float),
            "bloom_sigma": ("bloom_sigma", float),
            "bloom_strength": ("bloom_strength", float),
            "bloom_threshold": ("bloom_threshold", float),
            "vignette": ("vignette_strength", float),
            "persistence": ("persistence", float),
            "scanline_speed": ("scanline_speed_px_s", float),
            "scanline_period": ("scanline_period_px", float),
            "glitch_amp": ("glitch_amp_px", int),
            "glitch_height": ("glitch_height_frac", float),
            "fast_bloom": ("fast_bloom", bool),
            "brightness": ("brightness", float),
            "contrast": ("contrast", float),
            "gamma": ("gamma", float),
            "saturation": ("saturation", float),
            "temperature": ("temperature", float),
            "flicker_strength": ("flicker_strength", float),
            "flicker_hz": ("flicker_hz", float),
            "grain_size": ("grain_size", int),
            "scanline_angle": ("scanline_angle", float),
            "scanline_thickness": ("scanline_thickness", float),
            "warp_strength": ("warp_strength", float),
        }
        updates = {}
        for key, (field, conv) in mapping.items():
            if key in d:
                updates[field] = conv(d[key])
        return dataclasses.replace(p, **updates)


def save_preset(path: str | Path, params: EffectParams, **codec_kwargs) -> None:
    with open(path, "w", encoding="utf-8") as f:
        json.dump(params.to_preset_dict(**codec_kwargs), f, indent=2)


def load_preset(path: str | Path, base: EffectParams = None) -> Tuple[EffectParams, dict]:
    """Load a preset JSON. Returns (params, raw dict) so callers can read
    the codec keys (crf, bitrate_kbps, encoder, ...) kept outside
    EffectParams."""
    with open(path, "r", encoding="utf-8") as f:
        d = json.load(f)
    return EffectParams.from_preset_dict(d, base), d


def load_text_preset(path: str | Path) -> TextParams:
    with open(path, "r", encoding="utf-8") as f:
        return TextParams.from_json_dict(json.load(f))


def save_text_preset(path: str | Path, text: TextParams) -> None:
    with open(path, "w", encoding="utf-8") as f:
        json.dump(text.to_json_dict(), f, indent=2)
