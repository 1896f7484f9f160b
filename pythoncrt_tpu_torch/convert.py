"""Carry the JAX engine's constants and state over to the port.

The effect chain has no trained weights; its "weights" are the host
tables both engines build from the oracle. ``consts_from_jax`` maps the
JAX engine's constant dict (``np.asarray`` of each entry of
``CRTEngine._c``) onto the port's names, so tests can feed both engines
identical tables (``CRTEngine(..., consts=...)``). Entries the port has
no use for (TPU matmul masks, bf16 grain matrices) are dropped.
"""

from __future__ import annotations

import numpy as np
import torch


def consts_from_jax(c: dict, device="cpu") -> dict:
    """Port-named device tensors from a JAX constant dict of numpy arrays."""
    out: dict = {}
    if "pix_y" in c:
        out["pix_y"] = np.asarray(c["pix_y"], np.int32)
        x = np.asarray(c["pix_x"], np.int32)
        # the JAX dict holds the G map as pix_x, plus R/B maps when the
        # aberration is composed in; the port keeps one (3, W) map by colour
        out["pix_x"] = np.stack([np.asarray(c.get("pix_x_r", x), np.int32), x,
                                 np.asarray(c.get("pix_x_b", x), np.int32)])
    for k in ("triad", "vig_ny2", "vig_nx2", "glitch_amp", "sl_slant", "text_alpha",
              "text_rgb"):
        if k in c:
            out[k] = np.asarray(c[k], np.float32)
    if "glitch_seg_index" in c:  # export glitch only; preview has one offset per row
        out["glitch_seg_index"] = np.asarray(c["glitch_seg_index"], np.int32)
    if "warp" in c:
        y0, x0, fy, fx = (np.asarray(a) for a in c["warp"])
        out["warp"] = (y0.astype(np.int32), x0.astype(np.int32),
                       fy.astype(np.float32), fx.astype(np.float32))

    def dev_t(a):
        if isinstance(a, tuple):
            return tuple(dev_t(v) for v in a)
        return torch.from_numpy(np.array(a)).to(device)

    return {k: dev_t(v) for k, v in out.items()}


def state_from_numpy(state, layout: str = "nhwc", channel_order: str = "rgb",
                     device="cpu") -> torch.Tensor:
    """A carried f32 state from the JAX engine (numpy, in that engine's
    layout) as a port tensor. ``layout``/``channel_order`` name the
    layout of both engines: (H, W, 3) RGB for "nhwc", (3, H, W) in
    ``channel_order`` plane order for "planar"."""
    s = np.asarray(state, np.float32)
    if s.ndim != 3 or (s.shape[2] if layout == "nhwc" else s.shape[0]) != 3:
        raise ValueError(f"state shape {s.shape} does not fit layout {layout!r}")
    if channel_order not in ("rgb", "gbr") or (channel_order == "gbr" and layout == "nhwc"):
        raise ValueError(f"channel_order {channel_order!r} does not fit layout {layout!r}")
    return torch.from_numpy(np.array(s, np.float32, order="C")).to(device)  # a writable copy
