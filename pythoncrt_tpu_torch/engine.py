"""The CRT effect engine in PyTorch.

Port of pythoncrt_tpu/engine.py for the c3 slice: one batched step

    step : (frames_u8 [B, 3, H, W], aux) -> out_u8 [B, 3, H, W]

that runs the fused kernel (stages 1-11) and, when the warp is on, the
warp kernel (stage 12) with the uint8 cast folded into the last one.
On CUDA tensors those are the hand-written kernels under csrc/; on CPU
tensors their plain PyTorch twins, so the CPU tests exercise the same
step.

Host tables (pixel maps, triad row, vignette vectors, warp tables,
resize taps) come from the shared NumPy oracle and are uploaded once.
Per-frame inputs (scanline phase, flicker gain, noise) are computed per
batch from absolute frame indices, so every draw is a pure function of
(seed, frame index): outputs do not depend on how frames are split
into batches.

Configs outside the slice raise NotImplementedError naming the
ROADMAP.md item that will bring them; nothing computes them another way.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from pythoncrt_tpu import oracle
from pythoncrt_tpu.params import EffectParams

from .kernels import fused as kfused
from .kernels import warp as kwarp
from .ops import color as ocolor
from .ops import resize as oresize


class FrameAux(NamedTuple):
    """Per-frame inputs of one batch, on the host."""

    frame_idx: np.ndarray  # (B,) int64 absolute frame indices
    phase: np.ndarray  # (B,) f32 scanline phase in px
    flicker: np.ndarray  # (B,) f32 flicker gain (1.0 when off)
    noise: Optional[np.ndarray] = None  # (B, gh, gw) f32 std-normal (rng="host")


def unsupported(params: EffectParams, *, engine: str = "export",
                precision: str = "exact", assoc_scan: bool = False,
                lut_exact: bool = True) -> Optional[str]:
    """Why this configuration is outside the port's c3 slice, or None."""
    p = params.clamped()
    if p.bloom_on and p.fast_bloom:
        return ("fast bloom (--fast-bloom, the CLI default) is not ported yet: "
                "ROADMAP.md queue 1, c4 slice (pass --no-fast-bloom)")
    if p.persistence_on:
        return ("persistence > 0 (the CLI default is 0.2) is not ported yet: "
                "ROADMAP.md queue 1, c4 slice (pass --persistence 0)")
    if p.glitch_on:
        return "the glitch stage is not ported yet: ROADMAP.md queue 1, c4 slice"
    if engine == "preview":
        return "the preview engine is not ported yet: ROADMAP.md queue 1, c4 slice"
    if assoc_scan:
        return "assoc_scan is not ported yet: ROADMAP.md queue 1, c4 slice"
    if p.text.enabled:
        return "text overlays are not ported yet: ROADMAP.md queue 1, fallback slice"
    if p.scanlines_on and not p.scanlines_1d:
        return ("angled or shaped (2-D) scanlines are not ported yet: "
                "ROADMAP.md queue 1, fallback slice")
    if precision == "fast" or not lut_exact:
        return "precision 'fast' is not ported yet: ROADMAP.md queue 1, fallback slice"
    return None


class CRTEngine:
    """Effect pipeline for one (params, H, W, fps) configuration.

    Same constructor surface as the JAX engine, with ``device`` in place
    of the TPU's ``pallas``/``interpret`` switches. ``layout`` "nhwc"
    takes and returns (B, H, W, 3) uint8; "planar" (B, 3, H, W) with
    plane i holding colour ``channel_order[i]`` ("gbr" is ffmpeg's gbrp
    order); "auto" is planar, the kernels' own layout. ``consts``
    overrides host tables by name (see ``consts`` and convert.py).
    """

    def __init__(self, params: EffectParams, height: int, width: int, fps: float, *,
                 engine: str = "export", rng: str = "native", seed: int = 0,
                 text_rgba: Optional[np.ndarray] = None, lut_exact: bool = True,
                 precision: str = "exact", assoc_scan: bool = False,
                 layout: str = "nhwc", channel_order: str = "rgb",
                 device="cuda", consts: Optional[dict] = None) -> None:
        if engine not in ("export", "preview"):
            raise ValueError(f"engine must be 'export' or 'preview', got {engine!r}")
        if rng not in ("native", "host"):
            raise ValueError(f"rng must be 'native' or 'host', got {rng!r}")
        if precision not in ("exact", "fast"):
            raise ValueError(f"precision must be 'exact' or 'fast', got {precision!r}")
        if layout not in ("nhwc", "planar", "auto"):
            raise ValueError(f"layout must be 'nhwc', 'planar' or 'auto', got {layout!r}")
        if channel_order not in ("rgb", "gbr"):
            raise ValueError(f"channel_order must be 'rgb' or 'gbr', got {channel_order!r}")
        if channel_order != "rgb" and layout == "nhwc":
            raise ValueError("channel_order requires layout 'planar'/'auto'")
        p = params.clamped()
        if text_rgba is not None and p.text.enabled:
            raise NotImplementedError(
                "text overlays are not ported yet: ROADMAP.md queue 1, fallback slice")
        why = unsupported(p, engine=engine, precision=precision,
                          assoc_scan=assoc_scan, lut_exact=lut_exact)
        if why:
            raise NotImplementedError(why)
        self.params = p
        self.h, self.w = int(height), int(width)
        self.fps = float(fps)
        self.engine = engine
        self.rng = rng
        self.seed = int(seed)
        self.precision = precision
        self.lut_exact = True
        self.assoc_scan = False
        self.device = torch.device(device)
        self.layout = "planar" if layout == "auto" else layout
        self.channel_order = channel_order
        # plane i of a planar frame holds colour _plane_colors[i] (0=R, 1=G, 2=B)
        self._plane_colors = (0, 1, 2) if channel_order == "rgb" else (1, 2, 0)
        self._build_consts(consts or {})

    # ------------------------------------------------------------------
    # Host tables (the oracle is the single source of truth)
    # ------------------------------------------------------------------

    def _build_consts(self, given: dict) -> None:
        p, h, w, dev = self.params, self.h, self.w, self.device
        own: dict = {}
        y_map, x_rgb = oresize.plane_index_maps(
            h, w, p.pixel_size if p.pixelate_on else 1,
            p.aberration_px if p.aberration_on else 0)
        own["pix_y"], own["pix_x"] = y_map, x_rgb  # x maps by colour R, G, B
        if p.triad_on:
            # y-invariant aperture-grille row (the soften blur is x-only)
            own["triad"] = oracle.triad_mask(1, w, p.triad_strength, p.triad_softness)[0]
        if p.vignette_on:
            yy, xx = np.arange(h, dtype=np.float64), np.arange(w, dtype=np.float64)
            ny = (yy - (h - 1) / 2.0) / max(1.0, h / 2.0)
            nx = (xx - (w - 1) / 2.0) / max(1.0, w / 2.0)
            own["vig_ny2"] = (ny * ny).astype(np.float32)
            own["vig_nx2"] = (nx * nx).astype(np.float32)
        if p.warp_on:
            map_x, map_y = oracle.barrel_warp_maps(h, w, p.warp_strength)
            x0, fx = oracle.ops.split_map(map_x)
            y0, fy = oracle.ops.split_map(map_y)
            own["warp"] = (y0, x0, fy, fx)
        g = max(1, int(p.grain_size))
        self._grain_hw = (max(1, h // g), max(1, w // g)) if g > 1 else (h, w)

        def dev_t(a):
            if isinstance(a, tuple):
                return tuple(dev_t(v) for v in a)
            if isinstance(a, torch.Tensor):
                return a.to(dev)
            return torch.from_numpy(np.array(a)).to(dev)

        self.consts = {k: dev_t(given.get(k, v)) for k, v in own.items()}
        c = self.consts
        pc = self._plane_colors
        t = float(p.temperature)
        temp_r, temp_b = ocolor.temperature_gains(t) if t != 0.0 else (1.0, 1.0)
        self.spec = kfused.build_fused_spec(
            h, w, sigma=float(p.bloom_sigma), strength=float(p.bloom_strength),
            threshold=float(p.bloom_threshold), bloom=p.bloom_on,
            px=int(p.pixel_size) if p.pixelate_on else 1,
            ab=int(p.aberration_px) if p.aberration_on else 0,
            saturation=float(p.saturation), temp_r=temp_r, temp_b=temp_b,
            brightness=float(p.brightness), contrast=float(p.contrast),
            inv_gamma=(1.0 / float(p.gamma)) if (p.gamma != 1.0 and p.gamma > 0.0) else 1.0,
            triad=p.triad_on, triad_gamma=float(p.triad_gamma),
            triad_luma=bool(p.triad_preserve_luma),
            scanlines=p.scanlines_on, vignette=p.vignette_on,
            vig_strength=float(p.vignette_strength),
            flicker=p.flicker_on, noise=p.noise_on,
            noise_scale=float(p.noise_strength) / 255.0,
            emit="f32" if p.warp_on else "u8", corder=pc)
        own_fc = kfused.fused_consts(self.spec, dev)
        self.fused_tables = own_fc._replace(
            y_map=c["pix_y"].to(torch.int32).contiguous(),
            x_maps=c["pix_x"][list(pc)].to(torch.int32).contiguous())
        self._tri = (c["triad"].t()[list(pc)].contiguous().float()
                     if p.triad_on else None)  # (3, W) in plane order
        if p.warp_on:
            y0, x0, fy, fx = c["warp"]
            self.warp_tables = kwarp.WarpTables(y0.to(torch.int32).contiguous(),
                                          x0.to(torch.int32).contiguous(),
                                          fy.float().contiguous(), fx.float().contiguous())
        if p.noise_on and g > 1:
            gh, gw = self._grain_hw
            self._grain_taps = oresize.bilinear_consts(gh, gw, h, w, dev)

    # ------------------------------------------------------------------
    # Per-frame inputs
    # ------------------------------------------------------------------

    def make_aux(self, frame_indices) -> FrameAux:
        """Per-frame inputs for absolute frame indices. Host f64 scalar
        math as the reference (phase: crt_filter.py:1043, flicker: :632,
        time: :1064)."""
        p = self.params
        idx = np.asarray(frame_indices, dtype=np.int64).reshape(-1)
        t = idx / float(self.fps)
        phase = (t * p.scanline_speed_px_s).astype(np.float32)
        if p.flicker_on:
            flicker = (1.0 + 0.25 * p.flicker_strength
                       * np.sin(2.0 * np.pi * p.flicker_hz * t)).astype(np.float32)
        else:
            flicker = np.ones(idx.shape[0], np.float32)
        noise = None
        if self.rng == "host" and p.noise_on:
            gh, gw = self._grain_hw
            # independent per-frame streams keyed by frame index
            noise = np.stack([
                np.random.default_rng((self.seed, int(i))).standard_normal(
                    (gh, gw), dtype=np.float32) for i in idx])
        return FrameAux(idx, phase, flicker, noise)

    def _frame_generator(self, frame_idx: int) -> torch.Generator:
        """The native-rng generator of one frame, seeded as a pure
        function of (seed, frame index)."""
        ss = np.random.SeedSequence([self.seed % (1 << 64), int(frame_idx) % (1 << 64), 11])
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(ss.generate_state(1, np.uint64)[0]) >> 1)
        return gen

    def _grain_field(self, aux: FrameAux) -> torch.Tensor:
        """(B, H, W) unscaled stage-11 field: drawn per frame (native) or
        the host fields, then the oracle's bilinear upsample."""
        gh, gw = self._grain_hw
        if aux.noise is None:
            field = torch.stack([
                torch.randn((gh, gw), generator=self._frame_generator(i),
                            device=self.device, dtype=torch.float32)
                for i in aux.frame_idx])
        else:
            field = torch.from_numpy(np.ascontiguousarray(aux.noise, np.float32)).to(self.device)
        if self.params.grain_size > 1:
            field = oresize.resize_bilinear(field, *self._grain_taps)
        return field.contiguous()

    def _scanline_rows(self, phase: np.ndarray) -> np.ndarray:
        """(B, H) stage-8 1-D multiplier, f32 in the JAX engine's op order
        (_scanline_mul_1d)."""
        p = self.params
        omega = np.float32(2.0 * np.pi / max(1e-6, p.scanline_period_px))
        y = np.arange(self.h, dtype=np.float32)
        s = np.float32(0.5) * (np.float32(1.0)
                               + np.sin(omega * (y[None, :] + phase[:, None])))
        return (np.float32(1.0) - np.float32(p.scanline_strength) * s).astype(np.float32)

    # ------------------------------------------------------------------
    # The step
    # ------------------------------------------------------------------

    def _step(self, x: torch.Tensor, aux: FrameAux) -> torch.Tensor:
        """(B, 3, H, W) uint8 planar frames on the device -> uint8 planar."""
        out = kfused.fused_pipeline(x, self.spec, self.fused_tables, **self.fused_operands(aux))
        if self.params.warp_on:
            out = kwarp.warp_planar(out, self.warp_tables, emit_u8=True)
        return out

    def fused_operands(self, aux: FrameAux) -> dict:
        """The per-batch operands the step hands the fused kernel."""
        s, c = self.spec, self.consts
        kw = {}
        if s.noise:
            kw["grain"] = self._grain_field(aux)
        if s.scanlines:
            kw["sl"] = torch.from_numpy(self._scanline_rows(aux.phase)).to(self.device)
        if s.vignette:
            kw["vy2"], kw["vx2"] = c["vig_ny2"], c["vig_nx2"]
        if s.triad:
            kw["tri"] = self._tri
        if s.flicker:
            kw["flicker"] = torch.from_numpy(aux.flicker).to(self.device)
        return kw

    def _finish(self, out: torch.Tensor):
        """Restore the I/O layout of the uint8 planar result. The carried
        state is the quantized last frame in [0, 1] (persistence is
        outside the slice, so nothing reads it back yet)."""
        if self.layout == "nhwc":
            out = out.permute(0, 2, 3, 1).contiguous()
        return out, out[-1].float() * np.float32(1.0 / 255.0)

    # ------------------------------------------------------------------
    # Host API
    # ------------------------------------------------------------------

    def _frame_shape(self) -> tuple:
        return (3, self.h, self.w) if self.layout == "planar" else (self.h, self.w, 3)

    def init_state(self) -> torch.Tensor:
        return torch.zeros(self._frame_shape(), dtype=torch.float32, device=self.device)

    def process(self, frames_u8, frame_indices=None, state=None):
        """Run a batch: (B, H, W, 3) uint8 (numpy or tensor), or
        (B, 3, H, W) for layout "planar". Returns (out_u8 tensor on the
        engine's device, state)."""
        x = torch.as_tensor(frames_u8).to(self.device, non_blocking=True)
        if x.dtype != torch.uint8 or tuple(x.shape[1:]) != self._frame_shape():
            raise ValueError(f"frames {x.dtype} {tuple(x.shape[1:])} != uint8 "
                             f"{self._frame_shape()} for layout={self.layout!r}")
        if state is not None and tuple(state.shape) != self._frame_shape():
            raise ValueError(f"state shape {tuple(state.shape)} != {self._frame_shape()}")
        b = x.shape[0]
        if frame_indices is None:
            frame_indices = np.arange(b)
        aux = self.make_aux(frame_indices)
        if self.layout == "nhwc":
            x = x.permute(0, 3, 1, 2)
        return self._finish(self._step(x.contiguous(), aux))

    def process_stack(self, frames_stack, frame_indices, state=None):
        """n sequential process() calls over (n, B, ...) frames with (n, B)
        frame indices. Returns ((n, B, ...) uint8, final state)."""
        idx = np.asarray(frame_indices).reshape(len(frames_stack), -1)
        outs = []
        for frames, ii in zip(frames_stack, idx):
            out, state = self.process(frames, ii, state)
            outs.append(out)
        return torch.stack(outs), state
