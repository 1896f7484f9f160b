"""CPU ground-truth oracle: an exact NumPy implementation of the effect
chain. Defines the reference bytes the port is tested against, and builds
the host tables (masks, index maps, resize taps, warp maps, glitch fields)
the engine uploads.

The port's own copy of pythoncrt_tpu/oracle (tests/test_torch_copies.py
holds the two equal on seeded inputs)."""

from . import ops
from .engine import (
    apply_effects,
    apply_color_adjustments,
    apply_triad,
    apply_glitch_gather,
    barrel_warp_maps,
    composite_text,
    flicker_factor,
    glitch_fields_export,
    glitch_offsets_preview,
    glitch_rows,
    persistence_blend,
    pixelate_index_maps,
    scanline_mask_1d,
    scanline_mask_2d,
    scanline_slant,
    triad_luts,
    triad_mask,
    vignette_mask,
)

__all__ = [
    "ops",
    "apply_effects",
    "apply_color_adjustments",
    "apply_triad",
    "apply_glitch_gather",
    "barrel_warp_maps",
    "composite_text",
    "flicker_factor",
    "glitch_fields_export",
    "glitch_offsets_preview",
    "glitch_rows",
    "persistence_blend",
    "pixelate_index_maps",
    "scanline_mask_1d",
    "scanline_mask_2d",
    "scanline_slant",
    "triad_luts",
    "triad_mask",
    "vignette_mask",
]
