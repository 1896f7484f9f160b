"""The CRT effect engine in PyTorch.

Port of pythoncrt_tpu/engine.py: one batched step

    step : (frames_u8 [B, 3, H, W], aux, state [3, H, W]) -> (out_u8, state)

that runs, in the reference's stage order, the fused kernel (stages
1-11), the warp kernel (stage 12, when on), the text overlay (stage 13,
when composited after the effects), the glitch kernel (stage 14, when
on, in place on the band) and the persistence kernel (stage 15, when
on), with the uint8 cast folded into the last kernel when nothing
follows it. On CUDA tensors those are the hand-written kernels under
csrc/; on CPU tensors their plain PyTorch twins, so the CPU tests
exercise the same step.

Text composited before the bloom (stage 5) runs in the fused kernel's
prologue, over the box the overlay's alpha covers (``spec.text_box``,
found once when the engine is built; the overlay's alpha and colour
cropped to it are the kernel's ``talpha`` and ``trgb`` operands).
``text_route`` records where the text is composited: "fused" (in the
fused kernel), "torch" (the staged step's ``_pre_bloom``), "after"
(stage 13, kernels/text.py) or "none". Text after the effects is
composited in place over the same box (``text_grid`` "box"), or, after
the warp, whose f32 emit is not clamped, over the whole frame with the
clip outside the box (``text_grid`` "whole").

Two kinds of configuration take another route to stage 11:

- 2-D scanlines (angled or shaped): the staged step, stages 1-5 as torch
  ops, the stand-alone bloom kernel (kernels/bloom3.py), then stages
  7-11 as torch ops with the per-pixel mask (the JAX engine sends these
  to its XLA path for the same reason: the mask needs sin and pow per
  pixel);
- the JAX engine's bloom opt-ins, read from the environment when the
  engine is built, with its precedence (pythoncrt_tpu/engine.py:286-356):
  ``PCRT_PALLAS_BLOOM=1`` with the gaussian bloom selects the stripe
  bloom (kernels/bloom.py); else ``PCRT_BLOOM2_FAST=1`` with the fast
  bloom, or ``PCRT_BLOOM2_GAUSS=1`` with the gaussian, selects bloom2 of
  that variant (kernels/bloom2.py). A selected kernel sends the
  configuration to the staged step as its stage 6, with 1-D scanlines
  and text before the bloom too (the JAX engine's fused path steps aside
  for them, engine.py:402-403; the staged step composites it in
  ``_pre_bloom``). ``bloom_route`` records the choice:
  "fused", "bloom3", "bloom2", "stripe" or "none" (bloom off). The JAX
  shape gates of those routes (H%8, W%128) have no counterpart: the
  port's kernels take any H and W. The JAX variables that select an XLA
  form in place of a kernel (PCRT_NO_BLOOM3, PCRT_NO_BLOOM2,
  PCRT_NO_FUSED, PCRT_FUSED_EPI) are not read (ROADMAP.md).

The step is two halves, as the JAX engine's ``_batch_effects`` and
``_finish``: ``_effects`` (stages 1-14, per frame) and ``_finish`` (stage
15 and the uint8 cast), so the sharded engine (parallel/mesh.py) can
finish its shards' effects apart. MultiClipEngine runs the whole step
over a flat batch of several clips with their clip-major states, which
``_finish`` takes to the persistence kernel's multi-clip mode.

Host tables (pixel maps, triad row, vignette vectors, warp tables,
resize taps, glitch amplitudes and segment index) come from the port's
NumPy oracle and are uploaded once. Per-frame inputs (scanline phase,
flicker gain, noise, glitch offsets) are computed per batch from
absolute frame indices, so every draw is a pure function of (seed, frame
index): outputs do not depend on how frames are split into batches. The
native draws (rng="native") run on the device, one launch per batch and
stream, keyed by the frame indices uploaded with the other inputs
(kernels/rng.py: Philox4x32-10, the grain on stream 11 and the glitch on
stream 14, so turning the glitch on leaves the grain as it was; the JAX
engine's fold_in(key, 11) and fold_in(key, 14)). The grain field reaches
the fused kernel raw, (gh, gw) per frame, and is upsampled there.
``make_aux_at`` and ``process_at`` take times in seconds in place of the
indices, with the host-rng noise given by the caller (the GUI preview).
``upload`` puts the inputs the step reads on the device, one
non-blocking copy from pinned memory each; ``process_stack`` runs n
batches with one make_aux and one upload, the n steps enqueued back to
back with no host wait, chunk i written into ``out[i]`` (the JAX
engine's one dispatch of n chunks, pythoncrt_tpu/engine.py:1381-1406).

``precision`` "fast" is the JAX engine's ``lut_exact=False``: the
triad's two pow sites on the clipped values instead of the 1024-bin
tables (the fused kernel's triad_mode 3, and the staged step's torch
epilogue). The JAX package's other "fast" trade, single-pass bf16
matmuls in its warp and blooms, has no counterpart: the port's warp and
blooms are f32 gathers and sums with no matmul.
"""

from __future__ import annotations

import copy
import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from . import oracle, perf
from .kernels import bloom as kbloom
from .kernels import bloom2 as kbloom2
from .kernels import bloom3 as kbloom3
from .kernels import bloom_walk as kwalk
from .kernels import fused as kfused
from .kernels import glitch as kglitch
from .kernels import persist as kpersist
from .kernels import rng as krng
from .kernels import text as ktext
from .kernels import warp as kwarp
from .ops import color as ocolor
from .ops import resize as oresize
from .params import EffectParams


class FrameAux(NamedTuple):
    """Per-frame inputs of one batch, on the host."""

    frame_idx: np.ndarray  # (B,) int64 absolute frame indices
    phase: np.ndarray  # (B,) f32 scanline phase in px
    flicker: np.ndarray  # (B,) f32 flicker gain (1.0 when off)
    noise: Optional[np.ndarray] = None  # (B, gh, gw) f32 std-normal (rng="host")
    glitch_base: Optional[np.ndarray] = None  # (B, rows) f32 (rng="host")
    glitch_seg: Optional[np.ndarray] = None  # (B, rows, segs) f32 (rng="host", export)


class DeviceAux(NamedTuple):
    """The per-frame inputs of a FrameAux that the step reads, on the
    engine's device (``CRTEngine.upload``): each host array copied once,
    from pinned memory without a wait, so the chunks of a stack read
    slices of them. Slicing every field along axis 0 slices the frames.
    The host frame indices stay in the FrameAux; none is read back."""

    frame_idx: Optional[torch.Tensor] = None  # (N,) int64: the native draws' keys
    sl: Optional[torch.Tensor] = None  # (N, H) 1-D scanline rows, or (N,) 2-D mask phase
    flicker: Optional[torch.Tensor] = None  # (N,) f32 [flicker]
    noise: Optional[torch.Tensor] = None  # (N, gh, gw) f32 (rng="host")
    glitch_base: Optional[torch.Tensor] = None  # (N, rows) f32 (rng="host")
    glitch_seg: Optional[torch.Tensor] = None  # (N, rows, segs) f32 (rng="host", export)


def aux_slice(aux, sl: slice):
    """The frames ``sl`` of a FrameAux or DeviceAux."""
    return type(aux)(*(None if f is None else f[sl] for f in aux))


def stack_out(out, shape, device) -> torch.Tensor:
    """The uint8 destination of a stack: ``out`` when the caller gave one
    (contiguous, of ``shape``, on ``device``), else a new tensor."""
    device = torch.device(device)
    if out is None:
        return torch.empty(tuple(shape), dtype=torch.uint8, device=device)
    if out.dtype != torch.uint8 or tuple(out.shape) != tuple(shape) \
            or not out.is_contiguous() or out.device.type != device.type \
            or (device.index is not None and out.device.index != device.index):
        raise ValueError(f"out must be a contiguous uint8 {tuple(shape)} tensor on {device}, "
                         f"got {out.dtype} {tuple(out.shape)} on {out.device}")
    return out


def bloom_optin(params: EffectParams) -> Optional[str]:
    """The stage-6 kernel the JAX engine's opt-in variables select for
    these params, with its precedence: "stripe", "bloom2" or None."""
    if not params.bloom_on:
        return None
    env = os.environ
    if not params.fast_bloom and env.get("PCRT_PALLAS_BLOOM") == "1":
        return "stripe"
    if env.get("PCRT_BLOOM2_FAST" if params.fast_bloom else "PCRT_BLOOM2_GAUSS") == "1":
        return "bloom2"
    return None


class CRTEngine:
    """Effect pipeline for one (params, H, W, fps) configuration.

    Same constructor surface as the JAX engine, with ``device`` in place
    of the TPU's ``pallas``/``interpret`` switches. ``layout`` "nhwc"
    takes and returns (B, H, W, 3) uint8 and an (H, W, 3) state;
    "planar" (B, 3, H, W) and (3, H, W), plane i holding colour
    ``channel_order[i]`` ("gbr" is ffmpeg's gbrp order); "auto" is
    planar, the kernels' own layout. ``engine`` "preview" selects the
    preview glitch (one offset per row), "export" the canonical one.
    ``assoc_scan`` runs the persistence recurrence as an O(log B)
    associative scan in plain PyTorch instead of the sequential kernel.
    ``consts`` overrides host tables by name (see ``consts`` and
    convert.py). ``text_rgba`` is the (H, W, 4) uint8 overlay of
    ``params.text`` (text.overlay_for); without it the text is off, as
    in the JAX engine.
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
        self.params = p
        self.h, self.w = int(height), int(width)
        self.fps = float(fps)
        self.engine = engine
        self.rng = rng
        self.seed = int(seed)
        self.precision = precision
        self.lut_exact = bool(lut_exact) and precision == "exact"
        self.assoc_scan = bool(assoc_scan)
        self.device = torch.device(device)
        self.layout = "planar" if layout == "auto" else layout
        self.channel_order = channel_order
        # plane i of a planar frame holds colour _plane_colors[i] (0=R, 1=G, 2=B)
        self._plane_colors = (0, 1, 2) if channel_order == "rgb" else (1, 2, 0)
        self._text_rgba = text_rgba
        # the bloom opt-in variables are read here, once, as the JAX engine
        # reads them at build
        self._build_consts(consts or {}, text_rgba, bloom_optin(p))

    def replica(self, device) -> "CRTEngine":
        """This engine on another device: the same configuration, the same
        stage-6 route (the opt-in this engine resolved at its build; the
        environment is not read again) and the same host tables
        (``consts``, copied there), so a shard on that device computes what
        this engine computes (parallel/mesh.py)."""
        rep = copy.copy(self)
        rep.device = torch.device(device)
        rep._build_consts(self.consts, self._text_rgba, self._bloom_optin)
        return rep

    # ------------------------------------------------------------------
    # Host tables (the oracle is the single source of truth)
    # ------------------------------------------------------------------

    def _build_consts(self, given: dict, text_rgba: Optional[np.ndarray],
                      optin: Optional[str]) -> None:
        """The tables on ``self.device``; ``optin`` is the stage-6 kernel a
        bloom opt-in selected (``bloom_optin``), or None."""
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
        self._glitch_y0, self._glitch_rows = oracle.glitch_rows(h, p.glitch_height_frac)
        self._glitch = p.glitch_on and self._glitch_rows > 0
        if self._glitch:
            # amplitude per band row and the static segment of each column
            # (the JAX engine's glitch consts, engine.py:721-736)
            rows = self._glitch_rows
            ridx = np.arange(rows, dtype=np.float32)
            if self.engine == "preview":
                amp = float(p.glitch_amp_px) * np.exp(-3.0 * (ridx / max(1.0, float(rows))))
                own["glitch_seg_index"] = np.zeros(w, np.int32)
            else:
                amp = float(p.glitch_amp_px) * (1.0 - ridx / max(1.0, float(rows)))
                seg_len = max(8, min(32, w // 120 if w >= 120 else 8))
                own["glitch_seg_index"] = (np.arange(w, dtype=np.int32) // seg_len).astype(np.int32)
            own["glitch_amp"] = amp.astype(np.float32)
        if p.scanlines_on and not p.scanlines_1d:
            # static part of the 2-D mask; the phase is added per frame
            own["sl_slant"] = oracle.scanline_slant(h, w, p.scanline_angle)
        has_text = text_rgba is not None and p.text.enabled
        if has_text:
            ov = np.asarray(text_rgba)
            if ov.shape[:2] != (h, w):
                raise ValueError(f"text overlay shape {ov.shape[:2]} != frame {(h, w)}")
            # the JAX engine's constants (engine.py:742-743), RGB last
            own["text_alpha"] = ov[..., 3:4].astype(np.float32) / 255.0
            own["text_rgb"] = ov[..., :3].astype(np.float32) / 255.0
        g = max(1, int(p.grain_size))
        self._grain_hw = (max(1, h // g), max(1, w // g)) if g > 1 else (h, w)
        # the native draws' inputs: the keys are uploaded per batch
        self._draws = self.rng == "native" and (p.noise_on or self._glitch)

        def dev_t(a):
            if isinstance(a, tuple):
                return tuple(dev_t(v) for v in a)
            if isinstance(a, torch.Tensor):
                return a.to(dev)
            return torch.from_numpy(np.array(a)).to(dev)

        self.consts = {k: dev_t(given.get(k, v)) for k, v in own.items()}
        c = self.consts
        if self._glitch:
            seg = c["glitch_seg_index"].to(torch.int32).contiguous()
            if tuple(seg.shape) != (w,) or int(seg.min().item()) < 0:
                raise ValueError("glitch_seg_index must hold (W,) segment indices >= 0")
            self._glitch_nseg = int(seg.max().item()) + 1
            c["glitch_seg_index"] = seg
        pc = self._plane_colors
        self._text_before = has_text and not p.text.after  # stage 5
        self._text_after = has_text and p.text.after  # stage 13
        if has_text:  # (H, W) alpha and (3, H, W) colour in plane order
            self._text = (c["text_alpha"][..., 0].float().contiguous(),
                          c["text_rgb"].permute(2, 0, 1)[list(pc)].float().contiguous())
        # 2-D scanlines need the per-pixel mask, and a bloom opt-in names
        # its own stage-6 kernel: both take the staged step
        self._bloom_optin = optin
        self._staged = (p.scanlines_on and not p.scanlines_1d) or optin is not None
        self.bloom_route = ("none" if not p.bloom_on
                            else optin or ("bloom3" if self._staged else "fused"))
        self.text_route = ("after" if self._text_after else "none" if not self._text_before
                           else "torch" if self._staged else "fused")
        # the rows and columns where the alpha is not 0, and the overlay
        # cropped to them: outside them the composite is the identity on
        # values in [0, 1] (no box where the overlay is clear)
        self._text_crops = (ktext.find_box(*self._text)
                            if self.text_route in ("fused", "after") else ktext.TextBox())
        text_box = self._text_crops.box if self.text_route == "fused" else ()
        self._text_box_ops = (dict(talpha=self._text_crops.alpha, trgb=self._text_crops.rgb)
                              if text_box else {})
        # stage 13 over the box alone where its input is in [0, 1] (the
        # fused kernel's f32 emit, the staged epilogue); over the whole frame,
        # clipped outside the box, after the warp's unclamped f32 emit
        self.text_grid = (("whole" if p.warp_on else "box") if self.text_route == "after"
                          else None)
        if p.scanlines_on and not p.scanlines_1d:
            self._sl_omega = np.float32(2.0 * np.pi / max(1e-6, p.scanline_period_px))
            self._sl_inv_sharp = np.float32(
                1.0 / float(np.clip(p.scanline_thickness, 0.1, 4.0)))
        # the uint8 cast folds into the last kernel of the step when
        # nothing follows it
        temporal = self._glitch or p.persistence_on
        t = float(p.temperature)
        temp_r, temp_b = ocolor.temperature_gains(t) if t != 0.0 else (1.0, 1.0)
        self.spec = kfused.build_fused_spec(
            h, w, sigma=float(p.bloom_sigma), strength=float(p.bloom_strength),
            threshold=float(p.bloom_threshold), fast=bool(p.fast_bloom), bloom=p.bloom_on,
            text_box=text_box, px=int(p.pixel_size) if p.pixelate_on else 1,
            ab=int(p.aberration_px) if p.aberration_on else 0,
            saturation=float(p.saturation), temp_r=temp_r, temp_b=temp_b,
            brightness=float(p.brightness), contrast=float(p.contrast),
            inv_gamma=(1.0 / float(p.gamma)) if (p.gamma != 1.0 and p.gamma > 0.0) else 1.0,
            triad=p.triad_on, triad_gamma=float(p.triad_gamma),
            triad_luma=bool(p.triad_preserve_luma), lut_exact=self.lut_exact,
            scanlines=p.scanlines_on, vignette=p.vignette_on,
            vig_strength=float(p.vignette_strength),
            flicker=p.flicker_on, noise=p.noise_on,
            noise_scale=float(p.noise_strength) / 255.0, grain_size=g,
            emit="f32" if (p.warp_on or temporal or self._text_after) else "u8", corder=pc)
        self._warp_u8 = p.warp_on and not temporal and not self._text_after
        self.bloom3_spec = None  # the staged step's stand-alone bloom
        if p.bloom_on:
            self.bloom3_spec = (
                kbloom3.build_bloom3_fast_spec(h, w, float(p.bloom_strength),
                                               float(p.bloom_threshold))
                if p.fast_bloom else
                kbloom3.build_bloom3_spec(h, w, float(p.bloom_sigma), float(p.bloom_strength),
                                          float(p.bloom_threshold)))
        self.bloom3_tables = None  # the fast variant's row-walk tables, made once
        if self.bloom_route == "bloom3" and self.bloom3_spec.fast:
            self.bloom3_tables = kwalk.fast_tables(h, w, self.bloom3_spec.threshold, dev)
        self.bloom_spec = self.bloom2_tables = None  # an opt-in's stage 6
        if self.bloom_route == "stripe":
            self.bloom_spec = kbloom.build_bloom_spec(h, w, float(p.bloom_sigma),
                                                      float(p.bloom_strength),
                                                      float(p.bloom_threshold))
        elif self.bloom_route == "bloom2":
            self.bloom_spec = kbloom2.build_bloom2_spec(
                h, w, variant="fast" if p.fast_bloom else "gaussian",
                sigma=float(p.bloom_sigma), strength=float(p.bloom_strength),
                threshold=float(p.bloom_threshold))
            self.bloom2_tables = kbloom2.bloom2_tables(self.bloom_spec, dev)
        self.fused_tables = kfused.fused_consts(self.spec, dev, y_map=c["pix_y"],
                                                x_maps=c["pix_x"][list(pc)])
        self._tri = (c["triad"].t()[list(pc)].contiguous().float()
                     if p.triad_on else None)  # (3, W) in plane order
        if p.warp_on:
            y0, x0, fy, fx = c["warp"]
            self.warp_tables = kwarp.WarpTables(y0.to(torch.int32).contiguous(),
                                                x0.to(torch.int32).contiguous(),
                                                fy.float().contiguous(),
                                                fx.float().contiguous())
        if self._glitch:
            self._glitch_amp = c["glitch_amp"].float().contiguous()

    # ------------------------------------------------------------------
    # Per-frame inputs
    # ------------------------------------------------------------------

    def make_aux(self, frame_indices) -> FrameAux:
        """Per-frame inputs for absolute frame indices, at the times
        ``idx / fps`` (time: crt_filter.py:1064); the host-rng noise is
        one stream per (seed, frame index)."""
        idx = np.asarray(frame_indices, dtype=np.int64).reshape(-1)
        with perf.span("crt.aux"):
            noise = None
            if self.rng == "host" and self.params.noise_on:
                gh, gw = self._grain_hw
                noise = np.stack([
                    np.random.default_rng((self.seed, int(i))).standard_normal(
                        (gh, gw), dtype=np.float32) for i in idx])
            return self._aux_at(idx / float(self.fps), idx, noise)

    def make_aux_at(self, times_sec, noise_fields=None) -> FrameAux:
        """Per-frame inputs for arbitrary times in seconds: the GUI
        preview runs on wall-clock time, not on frame indices (reference
        on_tick, crt_filter.py:1810-1852). The host-rng noise is injected
        (the preview's time-seeded grain, gui_qt.render_preview_frame);
        ``frame_idx`` is the nearest frame, which only the native streams
        read."""
        t = np.asarray(times_sec, dtype=np.float64).reshape(-1)
        noise = None
        if self.rng == "host" and self.params.noise_on:
            if noise_fields is None:
                raise ValueError("host-rng preview aux needs injected noise_fields")
            noise = np.asarray(noise_fields, np.float32)
        with perf.span("crt.aux"):
            return self._aux_at(t, np.rint(t * self.fps).astype(np.int64), noise)

    def _aux_at(self, t: np.ndarray, idx: np.ndarray, noise) -> FrameAux:
        """The inputs that follow from the f64 times t: the host f64 scalar
        math of the reference (phase: crt_filter.py:1043, flicker: :632)
        and, with host rng, the glitch fields."""
        p = self.params
        # the host glitch seeds take int(|phase| * k) of the f64 phase
        # (crt_filter.py:841, :670): a f32 phase near an integer boundary
        # would draw another frame's whole field
        phase64 = t * p.scanline_speed_px_s
        phase = phase64.astype(np.float32)
        if p.flicker_on:
            flicker = (1.0 + 0.25 * p.flicker_strength
                       * np.sin(2.0 * np.pi * p.flicker_hz * t)).astype(np.float32)
        else:
            flicker = np.ones(t.shape[0], np.float32)
        g_base = g_seg = None
        if self.rng == "host" and self._glitch and self.engine == "preview":
            g_base = np.stack([oracle.glitch_offsets_preview(
                self.h, self.w, float(ph), p.glitch_amp_px, p.glitch_height_frac)
                for ph in phase64])
        elif self.rng == "host" and self._glitch:
            fields = [oracle.glitch_fields_export(
                self.h, self.w, float(ph), p.glitch_amp_px, p.glitch_height_frac)
                for ph in phase64]
            g_base = np.stack([f[0] for f in fields])
            g_seg = np.stack([f[1] for f in fields])
        return FrameAux(idx, phase, flicker, noise, g_base, g_seg)

    def upload(self, aux) -> DeviceAux:
        """The inputs of ``aux`` that the step reads, on the device: the
        native draws' frame indices, the 1-D scanline rows (host f32 math,
        _scanline_rows) or the 2-D mask's phase, the flicker gains and the
        host-rng fields, one non-blocking copy each. A DeviceAux is
        returned as it is."""
        if isinstance(aux, DeviceAux):
            return aux
        with perf.span("crt.upload"):
            p = self.params
            sl = None
            if p.scanlines_on:
                sl = (self._scanline_rows(aux.phase) if p.scanlines_1d
                      else np.asarray(aux.phase, np.float32))
            host = (np.asarray(aux.frame_idx, np.int64) if self._draws else None, sl,
                    aux.flicker if p.flicker_on else None, aux.noise, aux.glitch_base,
                    aux.glitch_seg)
            return DeviceAux(*(self._put(a) for a in host))

    def _put(self, a) -> Optional[torch.Tensor]:
        """A host array on the device: through pinned memory and one
        non-blocking copy on the current stream (the host block is not
        reused before the copy ran), so no host wait."""
        if a is None:
            return None
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def _grain_field(self, aux) -> torch.Tensor:
        """(B, gh, gw) unscaled stage-11 field before its upsample (the
        fused kernel, or the staged step's epilogue, upsamples it): one
        launch of the draw kernel (native) or the host fields."""
        aux = self.upload(aux)
        if aux.noise is not None:
            return aux.noise
        with perf.span("crt.draws"):
            return krng.grain_normals(self.seed, aux.frame_idx, *self._grain_hw)

    def glitch_offsets(self, aux) -> torch.Tensor:
        """(B, rows, NSEG) int32 per-segment offsets of stage 14: one launch
        of the draw kernel (native), or the host fields, base + segment in
        f32, then rint (the JAX engine's _glitch_seg_offsets and
        _band_maps)."""
        aux = self.upload(aux)
        if aux.glitch_base is None:
            with perf.span("crt.draws"):
                if self.engine == "preview":
                    return krng.glitch_preview_offsets(self.seed, aux.frame_idx,
                                                       self._glitch_amp)
                return krng.glitch_export_offsets(self.seed, aux.frame_idx, self._glitch_nseg,
                                                  self._glitch_amp)
        with perf.span("crt.torch_ops"):
            offs = (aux.glitch_base[:, :, None] if self.engine == "preview"
                    else aux.glitch_base[:, :, None] + aux.glitch_seg)
            return kglitch.round_offsets(offs).contiguous()

    def _scanline_rows(self, phase: np.ndarray) -> np.ndarray:
        """(B, H) stage-8 1-D multiplier, f32 in the JAX engine's op order
        (_scanline_mul_1d)."""
        p = self.params
        omega = np.float32(2.0 * np.pi / max(1e-6, p.scanline_period_px))
        y = np.arange(self.h, dtype=np.float32)
        s = np.float32(0.5) * (np.float32(1.0)
                               + np.sin(omega * (y[None, :] + phase[:, None])))
        return (np.float32(1.0) - np.float32(p.scanline_strength) * s).astype(np.float32)

    def _scanline_mask_2d(self, phase) -> torch.Tensor:
        """(B, H, W) stage-8 2-D multiplier on the device, f32 in the
        oracle's op order (scanline_mask_2d), from the (B,) phase (host or
        device). Its sin and pow are each rounded once from double, so the
        mask is the same on every device; NumPy's f32 forms are not, and
        may differ by an ulp."""
        p = self.params
        ph = (phase if isinstance(phase, torch.Tensor)
              else self._put(np.asarray(phase, np.float32)))
        arg = self._sl_omega * (self.consts["sl_slant"][None] + ph[:, None, None])
        s = 0.5 * (1.0 + torch.sin(arg.double()).float())
        shaped = ocolor.powf_rn(s, self._sl_inv_sharp)
        return 1.0 - np.float32(p.scanline_strength) * shaped

    # ------------------------------------------------------------------
    # The step
    # ------------------------------------------------------------------

    def _effects(self, x: torch.Tensor, aux, dst=None) -> torch.Tensor:
        """Stages 1-14 on (B, 3, H, W) uint8 planar frames on the device
        (``aux`` a FrameAux or its upload): f32 in [0, 1], or uint8 when
        the cast folded into the last kernel (nothing temporal follows),
        that kernel writing into ``dst`` ((B, 3, H, W) uint8) when given."""
        p = self.params
        aux = self.upload(aux)
        if self._staged:
            out = self._staged_stages(x, aux)
        else:
            # the operands first: the grain draw is a wrapper span of its own
            kw = self.fused_operands(aux)
            with perf.span("crt.fused"):
                out = kfused.fused_pipeline(x, self.spec, self.fused_tables,
                                            out=dst if self.spec.emit == "u8" else None, **kw)
        if p.warp_on:  # stage 12
            with perf.span("crt.warp"):
                out = kwarp.warp_planar(out, self.warp_tables, emit_u8=self._warp_u8,
                                        out=dst if self._warp_u8 else None)
        if self._text_after:  # stage 13
            with perf.span("crt.text"):
                out = ktext.composite_after(out, self._text_crops, self.text_grid == "whole")
        if self._glitch:  # stage 14
            offs = self.glitch_offsets(aux)
            with perf.span("crt.glitch"):
                kglitch.shear_planar_inplace(out, self._glitch_y0, offs,
                                             self.consts["glitch_seg_index"])
        return out

    def _finish(self, imgs: torch.Tensor, state: torch.Tensor, first: bool, dst=None):
        """Stage 15 and the uint8 cast -> (uint8 frames, new f32 state).
        ``state`` is one stream's (3, H, W), or (C, 3, H, W) for C clips
        whose B / C frames each lie one after another in the batch
        (clip-major, MultiClipEngine): then the persistence kernel runs
        once in its multi-clip mode, or each clip finishes on its own
        frames. The persistence kernel writes its frames into ``dst``
        when given."""
        p = self.params
        clips = state is not None and state.ndim == 4
        if p.persistence_on and not self.assoc_scan:  # stage 15
            with perf.span("crt.persist"):
                return kpersist.persistence_scan(imgs, None if clips else state, first,
                                                 p.persistence, emit_u8=True,
                                                 clip_states=state if clips else None, out=dst)
        with perf.span("crt.torch_ops"):
            if not clips:
                return self._finish_one(imgs, state, first)
            b = imgs.shape[0] // state.shape[0]
            outs, ends = zip(*(self._finish_one(imgs[k * b:(k + 1) * b], state[k], first)
                               for k in range(state.shape[0])))
            return torch.cat(outs), torch.stack(ends)

    def _finish_one(self, imgs: torch.Tensor, state: torch.Tensor, first: bool):
        """_finish's torch ops over one stream's frames: the associative
        scan, or with persistence off the cast alone."""
        if self.params.persistence_on:
            return self._assoc_persistence(imgs, state, first)
        if imgs.dtype == torch.uint8:
            # the carried state is the quantized last frame in [0, 1];
            # nothing reads it back while persistence is off
            return imgs, imgs[-1].float() * np.float32(1.0 / 255.0)
        return ocolor.to_uint8(imgs), imgs[-1]

    def _step(self, x: torch.Tensor, aux, state: torch.Tensor, first: bool, dst=None):
        """(B, 3, H, W) uint8 planar frames and a (3, H, W) f32 state, or
        a clip-major (C, 3, H, W) one (_finish), on the device -> (uint8
        planar frames, new state); the last kernel that emits the frames
        writes them into ``dst`` when given."""
        return self._finish(self._effects(x, aux, dst), state, first, dst)

    def _assoc_persistence(self, imgs: torch.Tensor, state: torch.Tensor, first: bool):
        """Stage 15 as an O(log B) associative scan (the JAX engine's
        _assoc_persistence): s_t = A_t * s_0 + b_t with the pairs (A, b)
        composed as (A2 * A1, A2 * b1 + b2) by a Hillis-Steele prefix over
        frames 1..B-1; frame 0 is blended (or passed through) as in the
        sequential scan. The clip is a no-op on a convex combination of
        [0, 1] values and is applied once at the end. Plain PyTorch: the
        JAX form is a lax.associative_scan, not a kernel."""
        pp = np.float32(self.params.persistence)
        om = np.float32(1.0 - self.params.persistence)
        x0 = imgs[0]
        out0 = x0 if first else torch.clamp(pp * state + om * x0, 0.0, 1.0)
        n = imgs.shape[0] - 1
        outs = out0[None]
        if n > 0:
            a = torch.full((n,) + (1,) * (imgs.ndim - 1), float(pp),
                           dtype=imgs.dtype, device=imgs.device)
            b = om * imgs[1:]
            d = 1
            while d < n:
                a, b = (torch.cat([a[:d], a[:-d] * a[d:]]),
                        torch.cat([b[:d], a[d:] * b[:-d] + b[d:]]))
                d *= 2
            outs = torch.cat([outs, torch.clamp(a * out0[None] + b, 0.0, 1.0)])
        return ocolor.to_uint8(outs), outs[-1].contiguous()

    def _pre_bloom(self, x: torch.Tensor) -> torch.Tensor:
        """Stages 1-5 as torch ops on (B, 3, H, W) uint8: the fused twin's
        prologue (so the staged and fused paths agree bit for bit up to
        the bloom input), then the text composited before the bloom."""
        with perf.span("crt.torch_ops"):
            img = kfused.prologue_ref(x, self.spec, self.fused_tables)
            if self._text_before:
                img = ocolor.composite_text(img, *self._text)
            return img

    def _staged_stages(self, x: torch.Tensor, aux: FrameAux) -> torch.Tensor:
        """Stages 1-11 for the configurations the fused kernel does not
        take: torch ops up to the bloom, the stand-alone bloom kernel of
        the route (an opt-in's, else bloom3), then the fused twin's
        epilogue (stages 7-11, the 1-D rows or the 2-D mask) as torch ops."""
        img = self._pre_bloom(x)
        if self.bloom3_spec is not None:  # stage 6, the bloom on
            with perf.span("crt.bloom"):
                if self.bloom_route == "stripe":
                    img = kbloom.bloom_planar(img, self.bloom_spec)
                elif self.bloom_route == "bloom2":
                    img = kbloom2.bloom2_planar(img, self.bloom_spec, self.bloom2_tables)
                elif self.bloom3_spec.fast:
                    img = kbloom3.bloom3_fast_planar(img, self.bloom3_spec, self.bloom3_tables)
                else:
                    img = kbloom3.bloom3_planar(img, self.bloom3_spec)
        kw = self.fused_operands(aux)
        with perf.span("crt.torch_ops"):
            return kfused.epilogue_ref(img, self.spec, self.fused_tables, **kw)

    def fused_operands(self, aux) -> dict:
        """The per-batch operands of stages 7-11 (and the text box's of
        stage 5), as the fused kernel (or the staged step's epilogue) takes
        them, from a FrameAux or its upload."""
        s, c = self.spec, self.consts
        aux = self.upload(aux)
        kw = dict(self._text_box_ops)
        if s.noise:
            kw["grain"] = self._grain_field(aux)
        if s.scanlines and self.params.scanlines_1d:
            kw["sl"] = aux.sl
        elif s.scanlines:
            with perf.span("crt.torch_ops"):
                kw["sl"] = self._scanline_mask_2d(aux.sl)
        if s.vignette:
            kw["vy2"], kw["vx2"] = c["vig_ny2"], c["vig_nx2"]
        if s.triad:
            kw["tri"] = self._tri
        if s.flicker:
            kw["flicker"] = aux.flicker
        return kw

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
        engine's device, state). Pass state=None for the first batch of a
        stream (its first frame passes through unblended); thereafter the
        returned state carries the persistence tail across batches."""
        with perf.span("crt.call"):
            x = self._frames(frames_u8)
            if frame_indices is None:
                frame_indices = np.arange(x.shape[0])
            return self._process(x, self.make_aux(frame_indices), state)

    def process_at(self, frames_u8, times_sec, noise_fields=None, state=None):
        """process() addressed by time instead of frame index (the GUI
        preview's access; see make_aux_at): the same checks and step."""
        with perf.span("crt.call"):
            x = self._frames(frames_u8)
            return self._process(x, self.make_aux_at(times_sec, noise_fields), state)

    def process_stack(self, frames_stack, frame_indices, state=None, out=None):
        """n process() calls over (n, B, ...) frames with (n, B) frame
        indices, enqueued back to back: one make_aux of the n * B frames,
        one copy of the stack and of each per-frame input to the device,
        then the n steps with no host wait between them (the JAX engine's
        process_stack, one dispatch of n chunks). Chunk i's frames are
        written into ``out[i]`` (a (n, B, ...) uint8 tensor on the device;
        None: a new one). Returns (out, final state), bit for bit n
        process() calls: the native draws are keyed by frame index."""
        with perf.span("crt.call"):
            x = torch.as_tensor(frames_stack)
            exp = self._frame_shape()
            if x.dtype != torch.uint8 or x.ndim != 2 + len(exp) or tuple(x.shape[2:]) != exp:
                raise ValueError(f"frames {x.dtype} {tuple(x.shape)} != uint8 (n, B) + {exp} "
                                 f"for layout={self.layout!r}")
            idx = np.asarray(frame_indices, dtype=np.int64)
            if idx.size != x.shape[0] * x.shape[1]:
                raise ValueError(f"frame_indices {idx.shape} do not pair with frames "
                                 f"{tuple(x.shape[:2])}")
            out = stack_out(out, x.shape, self.device)
            x = x.to(self.device, non_blocking=True)
            return out, self._chunks(x, self.make_aux(idx.reshape(-1)), state, out)

    def _frames(self, frames_u8) -> torch.Tensor:
        x = torch.as_tensor(frames_u8).to(self.device, non_blocking=True)
        if x.dtype != torch.uint8 or tuple(x.shape[1:]) != self._frame_shape():
            raise ValueError(f"frames {x.dtype} {tuple(x.shape[1:])} != uint8 "
                             f"{self._frame_shape()} for layout={self.layout!r}")
        return x

    def _process(self, x: torch.Tensor, aux: FrameAux, state):
        out = torch.empty(x.shape, dtype=torch.uint8, device=self.device)
        return out, self._chunks(x[None], aux, state, out[None])

    def _chunks(self, x: torch.Tensor, aux, state, out: torch.Tensor):
        """The steps of (n, B, ...) frames on the device, in the engine's
        layout, with the aux of their n * B frames (host, uploaded here
        once, or its upload): chunk i written into out[i]; the state stays
        planar on the device between chunks. Returns the final state in
        the layout."""
        first = state is None
        if first:
            state = self.init_state()
        elif tuple(state.shape) != self._frame_shape():
            # the JAX engine refuses a mid-stream shape change the same way
            # (the oracle's persistence_blend resizes; PARITY.md)
            raise ValueError(f"state shape {tuple(state.shape)} != {self._frame_shape()}")
        state = torch.as_tensor(state, dtype=torch.float32).to(self.device)
        nhwc = self.layout == "nhwc"
        if nhwc:
            x, state = x.permute(0, 1, 4, 2, 3), state.permute(2, 0, 1)
        state = state.contiguous()
        dev_aux = self.upload(aux)
        b = x.shape[1]
        for i in range(x.shape[0]):
            with perf.span("crt.step"):
                dst = None if nhwc else out[i]
                chunk = aux_slice(dev_aux, slice(i * b, (i + 1) * b))
                frames, state = self._step(x[i].contiguous(), chunk, state, first and i == 0,
                                           dst)
                if nhwc:
                    out[i].copy_(frames.permute(0, 2, 3, 1))
                elif frames is not dst:
                    dst.copy_(frames)
        return (state.permute(1, 2, 0) if nhwc else state).contiguous()
