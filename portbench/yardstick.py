"""The yardstick: one H100's peaks, and the least time of a kernel's work.

The peaks are NVIDIA's data sheet for the H100 SXM (80 GB HBM3 at
3.35 TB/s; 67 TFLOP/s f32 outside the tensor cores), at the full 700 W.
A kernel's least time is the larger of the bytes it must move over the
memory rate and its f32 operations over the f32 rate: each input byte
read once and each output byte written once, whatever the kernel reads
again, and the operations counted per output value from the chain's
definition (estimated from the kernels' sources for the stages the
configuration turns on, rounded up; a multiply-add counts as two). A
roofline share is that least time over the kernel's device time; it
cannot pass 100% unless the bytes or operations are counted too high.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

# f32 operations per output value
OPS_PER_VALUE = {"fused_fast": 40, "fused_gaussian": 70, "persistence": 6}


def bound_s(bytes_moved: float, f32_ops: float) -> float:
    """Least seconds for the work: bytes over the memory rate or operations
    over the f32 rate, whichever is longer (the card runs both at once)."""
    return max(bytes_moved / HBM_BYTES_PER_S, f32_ops / F32_OPS_PER_S)


def _on(p: dict) -> dict:
    """The stage gates of the configuration's effect parameters."""
    temporal = p["persistence"] > 0.0 or (p["glitch_amp_px"] > 0 and p["glitch_height_frac"] > 0)
    text = p.get("text") or {}
    return dict(temporal=temporal, warp=p["warp_strength"] != 0.0,
                text_before=bool(text.get("text")) and not text.get("after", True),
                text_after=bool(text.get("text")) and text.get("after", True),
                noise=p["noise_strength"] > 0.0,
                sl_1d=p["scanline_strength"] > 0.0 and p["scanline_angle"] == 0.0
                and p["scanline_thickness"] == 1.0,
                vignette=p["vignette_strength"] > 0.0, triad=p["triad_strength"] > 0.0,
                flicker=p["flicker_strength"] > 0.0 and p["flicker_hz"] > 0.0)


def fused_work(cfg: dict, frames: int) -> tuple[float, float]:
    """(bytes, f32 operations) of one fused-kernel launch over ``frames``
    frames: the frames in (uint8, or the f32 image when text is composited
    before the bloom), the frames out (f32 when a later stage follows,
    else uint8), and its per-batch operands: the grain field, the 1-D
    scanline rows, the vignette vectors, the triad row, the flicker gains,
    and the grain's upsample taps."""
    p, h, w = cfg["params"], int(cfg["height"]), int(cfg["width"])
    on = _on(p)
    values = frames * 3 * h * w
    f32_out = on["warp"] or on["temporal"] or on["text_after"]
    nbytes = values * (4 if on["text_before"] else 1) + values * (4 if f32_out else 1)
    g = max(1, int(p["grain_size"]))
    if on["noise"]:
        gh, gw = (max(1, h // g), max(1, w // g)) if g > 1 else (h, w)
        nbytes += frames * gh * gw * 4 + (2 * h + 2 * w) * 4 * (g > 1)
    nbytes += (frames * h * 4 * on["sl_1d"] + (h + w) * 4 * on["vignette"]
               + 3 * w * 4 * on["triad"] + frames * 4 * on["flicker"])
    ops = OPS_PER_VALUE["fused_fast" if p["fast_bloom"] else "fused_gaussian"]
    return float(nbytes), float(ops * values)


def persistence_work(cfg: dict, frames: int) -> tuple[float, float]:
    """(bytes, f32 operations) of one persistence launch: the f32 frames
    and the state in, the uint8 frames and the state out."""
    hw3 = 3 * int(cfg["height"]) * int(cfg["width"])
    return float(frames * hw3 * 4 + hw3 * 4 + frames * hw3 + hw3 * 4), \
        float(OPS_PER_VALUE["persistence"] * frames * hw3)
