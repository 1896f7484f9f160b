"""The effect chain in plain torch: what the benchmark holds the port's frames to.

A straightforward implementation of the CRT chain of upstream PythonCRT's
export engine (crt_filter.py:702-861, 1086-1096), batched over frames and
written from the published stage definitions, in f32 with the op order and
rounding conventions the JAX package defines for them:

   1 u8 -> f32 (times f32(1/255))   2 aberration (R rolled +ab, B -ab)
   3 pixelate (nearest down, then up)   4 grade (saturation, temperature,
   brightness/contrast, pow(1/gamma) rounded once from double)
   5 text before   6 bloom (knee; the fast half-res bilinear down and up,
   or the separable gaussian with replicated borders)   7 triad (the
   aperture-grille row, softened along x; the 1024-bin tables: forward
   pow(q, gamma) and final exp2(f32(1/gamma) log2 q), each transcendental
   rounded once from double)   8 scanlines (1-D rows in NumPy f32, or the
   2-D mask)   9 vignette (separable r^2)   10 flicker   11 grain (the
   native draws' field, bilinear upsampled)   12 barrel warp (bilinear,
   zero border)   13 text after   14 export glitch (per row and segment,
   a modular shear of the bottom band)   15 persistence
   clip(p s + (1 - p) x), the stream's first frame passed through, then
   clip(rint(255 x)).

Frames are planar (N, 3, H, W) uint8 with planes R, G, B. Everything the
port derives from the configuration, the seed and the frame indices (index
maps, tables, masks, the draws, the persistence state) is worked out here
again; nothing of the program is imported. ``dtype`` bfloat16 runs the
same chain with every float tensor in bfloat16: the control that the
comparison must fail.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from . import draws

LUT = 1024
REC709 = (0.2126, 0.7152, 0.0722)


# ---- host tables (NumPy, as the upstream chain builds them) ----------------

def nearest_index_map(src: int, dst: int) -> np.ndarray:
    idx = np.floor(np.arange(dst, dtype=np.float64) * (src / float(dst))).astype(np.int64)
    return np.clip(idx, 0, src - 1)


def bilinear_taps(src: int, dst: int) -> tuple[np.ndarray, np.ndarray]:
    """(lo, frac) of a bilinear resize along one axis: the sample at
    (d + 0.5) src/dst - 0.5, edges clamped."""
    if src == 1:
        return np.zeros(dst, np.int64), np.zeros(dst, np.float32)
    fx = (np.arange(dst, dtype=np.float64) + 0.5) * (src / float(dst)) - 0.5
    lo = np.clip(np.floor(fx), 0, src - 2).astype(np.int64)
    return lo, np.clip(fx - lo, 0.0, 1.0).astype(np.float32)


def gaussian_taps(ksize: int, sigma: float) -> np.ndarray:
    if ksize <= 1:
        return np.ones(1, np.float32)
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) / 2.0
    k = np.exp(-(x * x) / (2.0 * float(sigma) * float(sigma)))
    return (k / k.sum()).astype(np.float32)


def triad_row(w: int, strength: float, softness: float) -> np.ndarray:
    """(W, 3) aperture-grille row: colour c bright where x % 3 == c, then an
    x-only gaussian soften with replicated borders."""
    x = np.arange(w)
    cols = np.stack([(x % 3 == c).astype(np.float32) for c in range(3)], axis=-1)
    row = ((1.0 - float(strength)) + float(strength) * cols).astype(np.float32)
    s = float(max(0.0, softness))
    if s > 0.0:
        k = max(3, int(round(s * 3)) * 2 + 1)
        taps = gaussian_taps(k, s)
        r = k // 2
        padded = np.pad(row, ((r, r), (0, 0)), mode="edge")
        out = np.zeros_like(row)
        for i in range(k):
            out += taps[i] * padded[i:i + w]
        row = out
    return row.astype(np.float32)


def scanline_rows(h: int, strength: float, period: float, phase: np.ndarray) -> np.ndarray:
    """(N, H) 1-D scanline multipliers in NumPy f32."""
    omega = np.float32(2.0 * np.pi / max(1e-6, period))
    y = np.arange(h, dtype=np.float32)
    s = np.float32(0.5) * (np.float32(1.0) + np.sin(omega * (y[None, :] + phase[:, None])))
    return (np.float32(1.0) - np.float32(strength) * s).astype(np.float32)


def glitch_band(h: int, frac: float) -> tuple[int, int]:
    y0 = max(0, min(h, h - int(h * frac)))
    return y0, h - y0


def powf_rn(x: torch.Tensor, e: float) -> torch.Tensor:
    """pow in double with the exponent f32(e), rounded once to x's type."""
    return torch.pow(x.double(), float(np.float32(e))).to(x.dtype)


# ---- the chain --------------------------------------------------------------

class Chain:
    """The chain of one configuration (``cfg``: a configuration file's
    height, width, fps and params, the params' ``text`` the caption's) for
    the draws of ``seed``, on ``device``; ``overlay`` the caption's (H, W, 4)
    uint8 RGBA."""

    def __init__(self, cfg: dict, seed: int, device="cpu", dtype=torch.float32,
                 overlay: Optional[np.ndarray] = None) -> None:
        p = cfg["params"]
        if cfg.get("engine", "export") != "export" or cfg.get("precision", "exact") != "exact":
            raise NotImplementedError("the reference holds the export engine at exact precision")
        self.p, self.h, self.w = p, int(cfg["height"]), int(cfg["width"])
        self.fps, self.seed = float(cfg["fps"]), int(seed)
        self.dev, self.dt = torch.device(device), dtype
        h, w = self.h, self.w
        dev, dt = self.dev, dtype

        def t(a, dtype=dt):
            return torch.as_tensor(np.asarray(a)).to(device=dev, dtype=dtype)

        px, ab = int(p["pixel_size"]), int(p["aberration_px"])
        if px > 1:
            sh, sw = max(1, h // px), max(1, w // px)
            ymap = nearest_index_map(h, sh)[nearest_index_map(sh, h)]
            xmap = nearest_index_map(w, sw)[nearest_index_map(sw, w)]
        else:
            ymap, xmap = np.arange(h), np.arange(w)
        self.ymap = t(ymap, torch.int64)
        self.xmaps = t(np.stack([(xmap - ab) % w, xmap, (xmap + ab) % w]), torch.int64)
        self.bloom = p["bloom_strength"] > 0.0 and (p["bloom_sigma"] > 0.0 or p["fast_bloom"])
        if self.bloom and p["fast_bloom"]:
            h2, w2 = max(1, h // 2), max(1, w // 2)
            self.down = [t(a, torch.int64 if i % 2 == 0 else dt) for i, a in
                         enumerate((*bilinear_taps(h, h2), *bilinear_taps(w, w2)))]
            self.up = [t(a, torch.int64 if i % 2 == 0 else dt) for i, a in
                       enumerate((*bilinear_taps(h2, h), *bilinear_taps(w2, w)))]
        elif self.bloom:
            k = max(1, int(round(p["bloom_sigma"] * 3)) * 2 + 1)
            self.gtaps = [float(v) for v in gaussian_taps(k, p["bloom_sigma"])]
        g = float(p["triad_gamma"])
        self.triad = p["triad_strength"] > 0.0
        self.triad_mul = (not p["triad_preserve_luma"] and abs(g - 1.0) < 1e-3) or g <= 0.0
        if self.triad:
            self.tri = t(triad_row(w, p["triad_strength"], p["triad_softness"]).T)[None, :, None]
            q = torch.arange(LUT + 1, dtype=torch.float32) * np.float32(1.0 / LUT)
            fwd = torch.pow(q.double(), float(np.float32(g))).float()
            fin = torch.exp2((torch.log2(q.double()).float()
                              * float(np.float32(1.0 / g))).double()).float()
            self.lut_fwd, self.lut_fin = t(fwd), t(fin)
        if p["vignette_strength"] > 0.0:
            ny = (np.arange(h, dtype=np.float64) - (h - 1) / 2.0) / max(1.0, h / 2.0)
            nx = (np.arange(w, dtype=np.float64) - (w - 1) / 2.0) / max(1.0, w / 2.0)
            r2 = t((ny * ny).astype(np.float32))[:, None] + t((nx * nx).astype(np.float32))[None]
            self.vig = np.float32(1.0) - np.float32(p["vignette_strength"]) * torch.clamp(r2, 0, 1)
        self.sl_1d = p["scanline_angle"] == 0.0 and p["scanline_thickness"] == 1.0
        if p["scanline_strength"] > 0.0 and not self.sl_1d:
            yy, xx = np.mgrid[0:h, 0:w]
            slant = (yy + np.tan(np.deg2rad(float(p["scanline_angle"]))) * xx).astype(np.float32)
            self.slant = torch.from_numpy(slant).to(dev)
        self.gs = max(1, int(p["grain_size"]))
        self.ghw = (max(1, h // self.gs), max(1, w // self.gs)) if self.gs > 1 else (h, w)
        if self.gs > 1:
            self.gtaps_up = [t(a, torch.int64 if i % 2 == 0 else dt) for i, a in
                             enumerate((*bilinear_taps(self.ghw[0], h),
                                        *bilinear_taps(self.ghw[1], w)))]
        if p["warp_strength"] != 0.0:
            cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
            x = (np.arange(w, dtype=np.float32) - cx) / max(1.0, cx)
            y = (np.arange(h, dtype=np.float32) - cy) / max(1.0, cy)
            xv, yv = np.meshgrid(x, y)
            f = 1.0 + (float(p["warp_strength"]) * 0.5) * (xv * xv + yv * yv)
            mx = (xv * f * cx + cx).astype(np.float32)
            my = (yv * f * cy + cy).astype(np.float32)
            x0, y0 = np.floor(mx).astype(np.int64), np.floor(my).astype(np.int64)
            self.warp = (t(y0, torch.int64), t(x0, torch.int64), t((my - y0).astype(np.float32)),
                         t((mx - x0).astype(np.float32)))
        self.gy0, rows = glitch_band(h, p["glitch_height_frac"])
        self.glitch = p["glitch_amp_px"] > 0 and p["glitch_height_frac"] > 0.0 and rows > 0
        if self.glitch:
            ridx = np.arange(rows, dtype=np.float32)
            amp = (float(p["glitch_amp_px"]) * (1.0 - ridx / max(1.0, float(rows))))
            self.gamp = torch.from_numpy(amp.astype(np.float32)).to(dev)
            seg_len = max(8, min(32, w // 120 if w >= 120 else 8))
            seg = np.arange(w) // seg_len
            self.nseg = int(seg.max()) + 1
            self.src_x = torch.arange(w, device=dev)
            self.seg_index = torch.from_numpy(seg).to(dev)
        text = p.get("text") or {}
        self.text_before = self.text_after = False
        if overlay is not None and text.get("text"):
            ov = np.asarray(overlay)
            self.alpha = t(ov[..., 3].astype(np.float32) / 255.0)
            self.rgb = t(np.moveaxis(ov[..., :3].astype(np.float32) / 255.0, -1, 0))
            self.text_before = not text.get("after", True)
            self.text_after = bool(text.get("after", True))
        self.persist = p["persistence"] > 0.0

    # ---- stages ----

    def _resize(self, img, taps):
        ylo, fy, xlo, fx = taps
        h, w = img.shape[-2], img.shape[-1]
        yhi, xhi = torch.clamp(ylo + 1, max=h - 1), torch.clamp(xlo + 1, max=w - 1)
        fy = fy[:, None]
        rows = img[..., ylo, :] * (1.0 - fy) + img[..., yhi, :] * fy
        return rows[..., xlo] * (1.0 - fx) + rows[..., xhi] * fx

    def _blur(self, img, axis):
        k = len(self.gtaps)
        r, n = k // 2, img.shape[axis]
        idx = torch.clamp(torch.arange(-r, n + r, device=img.device), 0, n - 1)
        padded = img.index_select(axis, idx)
        out = torch.zeros_like(img)
        for i, tap in enumerate(self.gtaps):
            out = out + np.float32(tap) * padded.narrow(axis, i, n)
        return out

    def _luma(self, x):
        return (np.float32(REC709[0]) * x[:, 0] + np.float32(REC709[1]) * x[:, 1]
                + np.float32(REC709[2]) * x[:, 2])

    def _quant(self, x):
        return torch.clamp((torch.clamp(x, 0.0, 1.0) * LUT).to(torch.int32), 0, LUT).long()

    def _composite(self, img):
        return torch.clamp(img * (1.0 - self.alpha) + self.rgb * self.alpha, 0.0, 1.0)

    def effects(self, frames: torch.Tensor, idx: np.ndarray) -> torch.Tensor:
        """Stages 1-14 of (N, 3, H, W) uint8 RGB frames at frame indices idx."""
        p, h, w = self.p, self.h, self.w
        rows = frames[:, :, self.ymap]
        x = torch.gather(rows, 3, self.xmaps[None, :, None, :].expand(
            rows.shape[0], 3, h, w)).to(self.dt) * np.float32(1.0 / 255.0)
        sat, temp = float(p["saturation"]), float(p["temperature"])
        if sat != 1.0:
            luma = self._luma(x)[:, None]
            x = torch.clamp(luma + (x - luma) * np.float32(sat), 0.0, 1.0)
        if temp != 0.0:
            gains = [float(np.clip(1.0 + 0.5 * temp, 0.5, 1.5)), 1.0,
                     float(np.clip(1.0 - 0.5 * temp, 0.5, 1.5))]
            x = torch.clamp(x * torch.tensor(np.float32(gains), device=x.device, dtype=x.dtype)
                            [None, :, None, None], 0.0, 1.0)
        if p["brightness"] != 0.0 or p["contrast"] != 1.0:
            x = torch.clamp((x - np.float32(0.5)) * np.float32(p["contrast"]) + np.float32(0.5)
                            + np.float32(p["brightness"]), 0.0, 1.0)
        if p["gamma"] != 1.0 and p["gamma"] > 0.0:
            x = torch.clamp(powf_rn(x, 1.0 / float(p["gamma"])), 0.0, 1.0)
        if self.text_before:
            x = self._composite(x)
        if self.bloom:  # stage 6
            src = x
            if p["bloom_threshold"] > 0.0:
                thr = np.float32(min(0.99, max(0.0, p["bloom_threshold"])))
                rden = np.float32(1.0 / float(np.float32(max(1e-6, 1.0 - float(thr)))))
                src = torch.clamp((x - thr) * rden, 0.0, 1.0)
            if p["fast_bloom"]:
                bl = self._resize(self._resize(src, self.down), self.up)
            else:
                bl = self._blur(self._blur(src, 3), 2)
            x = torch.clamp(x + np.float32(p["bloom_strength"]) * bl, 0.0, 1.0)
        if self.triad:  # stage 7
            if self.triad_mul:
                x = torch.clamp(x * self.tri, 0.0, 1.0)
            else:
                lin = self.lut_fwd[self._quant(x)]
                out = lin * self.tri
                if p["triad_preserve_luma"]:
                    ratio = torch.clamp(self._luma(lin) / torch.clamp(self._luma(out),
                                                                      min=np.float32(1e-6)),
                                        0.5, 2.0)
                    out = out * ratio[:, None]
                x = torch.clamp(self.lut_fin[self._quant(out)], 0.0, 1.0)
        t = np.asarray(idx, np.int64) / self.fps
        phase64 = t * p["scanline_speed_px_s"]
        phase = phase64.astype(np.float32)
        if p["scanline_strength"] > 0.0:  # stage 8
            if self.sl_1d:
                sl = scanline_rows(h, p["scanline_strength"], p["scanline_period_px"], phase)
                x = torch.clamp(x * torch.from_numpy(sl).to(x.device, x.dtype)[:, None, :, None],
                                0.0, 1.0)
            else:
                omega = np.float32(2.0 * np.pi / max(1e-6, p["scanline_period_px"]))
                ph = torch.from_numpy(phase).to(x.device)
                arg = omega * (self.slant[None] + ph[:, None, None])
                s = (0.5 * (1.0 + torch.sin(arg.double()).float())).to(x.dtype)
                sharp = float(np.clip(p["scanline_thickness"], 0.1, 4.0))
                mask = 1.0 - np.float32(p["scanline_strength"]) * powf_rn(s, 1.0 / sharp)
                x = torch.clamp(x * mask[:, None], 0.0, 1.0)
        if p["vignette_strength"] > 0.0:  # stage 9
            x = torch.clamp(x * self.vig, 0.0, 1.0)
        if p["flicker_strength"] > 0.0 and p["flicker_hz"] > 0.0:  # stage 10
            fl = (1.0 + 0.25 * p["flicker_strength"]
                  * np.sin(2.0 * np.pi * p["flicker_hz"] * t)).astype(np.float32)
            x = torch.clamp(x * torch.from_numpy(fl).to(x.device, x.dtype)[:, None, None, None],
                            0.0, 1.0)
        if p["noise_strength"] > 0.0:  # stage 11
            f = torch.from_numpy(np.asarray(idx, np.int64)).to(x.device)
            g = draws.grain(self.seed, f, *self.ghw).to(x.dtype)
            if self.gs > 1:
                g = self._resize(g, self.gtaps_up)
            x = torch.clamp(x + (g * np.float32(float(p["noise_strength"]) / 255.0))[:, None],
                            0.0, 1.0)
        if p["warp_strength"] != 0.0:  # stage 12
            x = self._warp(x)
        if self.text_after:  # stage 13
            x = self._composite(x)
        if self.glitch:  # stage 14
            f = torch.from_numpy(np.asarray(idx, np.int64)).to(x.device)
            off = draws.glitch_export(self.seed, f, self.nseg, self.gamp)
            src = torch.remainder(self.src_x + off.long()[:, :, self.seg_index], w)
            band = x[:, :, self.gy0:]
            x = x.clone()
            x[:, :, self.gy0:] = torch.gather(band, 3, src[:, None].expand(band.shape))
        return x

    def _warp(self, x):
        y0, x0, fy, fx = self.warp
        h, w = self.h, self.w

        def tap(yi, xi):
            ok = ((yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)).to(x.dtype)
            v = x[:, :, torch.clamp(yi, 0, h - 1), torch.clamp(xi, 0, w - 1)]
            return v * ok

        w00, w01 = (1.0 - fy) * (1.0 - fx), (1.0 - fy) * fx
        w10, w11 = fy * (1.0 - fx), fy * fx
        return (w00 * tap(y0, x0) + w01 * tap(y0, x0 + 1) + w10 * tap(y0 + 1, x0)
                + w11 * tap(y0 + 1, x0 + 1))

    @staticmethod
    def to_uint8(x: torch.Tensor) -> torch.Tensor:
        return torch.clamp(torch.round(x.float() * 255.0), 0.0, 255.0).to(torch.uint8)

    def render(self, frames: torch.Tensor, idx: np.ndarray, state: Optional[torch.Tensor],
               block: int = 16) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
        """(N, 3, H, W) uint8 RGB frames at frame indices idx, with the
        persistence state before them (None: they start the stream) ->
        (uint8 frames, state after them), ``block`` frames at a time."""
        pp, om = np.float32(self.p["persistence"]), np.float32(1.0 - self.p["persistence"])
        outs = []
        idx = np.asarray(idx, np.int64)
        for b0 in range(0, frames.shape[0], block):
            x = self.effects(frames[b0:b0 + block].to(self.dev), idx[b0:b0 + block])
            if self.persist:
                ys = []
                for f in x:
                    state = f if state is None else torch.clamp(pp * state + om * f, 0.0, 1.0)
                    ys.append(state)
                x = torch.stack(ys)
            else:
                state = x[-1]
            outs.append(self.to_uint8(x))
        return torch.cat(outs), state


def lead_frames(persistence: float) -> int:
    """Frames before a compared frame that the reference starts from, its
    first passed through: p^lead < 2^-40, far under an f32 ulp of any value
    that rounds to a nonzero uint8 (0 when persistence is off)."""
    p = float(persistence)
    if p <= 0.0:
        return 0
    return int(math.ceil(40.0 / -math.log2(p)))
