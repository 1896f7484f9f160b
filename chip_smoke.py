"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each must pass; any failure exits non-zero):

1. The card (nvidia-smi name and power limit), torch/CUDA/nvcc versions,
   and which codec backends (ffmpeg, cv2) the host has.
2. Build the CUDA kernels from pythoncrt_tpu_torch/csrc (one nvcc per
   source, all started together, sm_90a).
3. Each kernel against its plain PyTorch twin on the card, at 1080p with
   a batch of 8 and the operands the main paths give it: the fused
   kernel with the c3 spec (gaussian core) and the CLI-default spec (fast
   core), the warp, the persistence scan (stream head and carried
   state) and the glitch shear (the c4 band, export and preview offsets,
   both entries); the stand-alone bloom (gaussian on the c3-angled
   pre-bloom image, fast on the defaults-angled one) and the fused
   kernel's f32-input mode (c4-text). Max abs error, CUDA-event time per call of the kernel,
   of the twin and, where one PyTorch call computes the same function,
   of that call; the least time the card could take (bytes over the
   memory rate, or operations over the f32 rate).
4. The engine on the card (rng="host") against the NumPy oracle at 1080p:
   c3 and c3-angled on two frames; the CLI defaults, c4, defaults-angled
   and c4-text on four frames in two batches with the persistence state
   carried; the text paths with a seeded synthetic overlay. <= 1 uint8
   LSB, fewer than 1e-3 of values off. The 2-D scanline mask against the
   oracle's (its NumPy f32 sin and pow are not correctly rounded).
5. The main paths at 1080p with batch 8: the CLI defaults (no effect
   flags), c4, defaults-angled (scanline angle 12, thickness 2) and
   c4-text (text before the bloom) on 32 frames, c3 and c3-angled
   (angle 5, thickness 1.5, text after the warp) on 16, each through
   ``pythoncrt_tpu_torch.cli.main`` on a synthetic clip when a codec
   backend exists, else through ``render_stream`` with in-memory frames.
   Every kernel of a path must launch during that path's run (the counts
   are set to 0 just before it). The text is rasterized by PIL when the
   host has it, else a seeded synthetic overlay takes its place (the
   line says which). Then the engine step alone per path.
6. The card's line, one JSON line with the kernel table, then the result
   line.

It imports nothing of JAX or of the JAX package. Without a CUDA device it
exits 2 and prints no result.
"""

from __future__ import annotations

import functools
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

H, W, B, FPS = 1080, 1920, 8, 24.0
N_MAIN, N_C3 = 32, 16
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
F32_OPS_PER_S = 67e12      # H100 SXM f32 outside the tensor cores
C3 = dict(scanline_strength=0.6, triad_strength=0.35, triad_softness=0.5, aberration_px=1,
          bloom_sigma=1.2, bloom_strength=0.25, fast_bloom=False, noise_strength=1.5,
          vignette_strength=0.25, persistence=0.0, pixel_size=2, grain_size=2,
          warp_strength=0.15, flicker_strength=0.2, flicker_hz=2.0, brightness=0.02,
          contrast=1.05, gamma=1.1, saturation=0.9, temperature=0.1)
C4 = dict(scanline_strength=0.6, triad_strength=0.35, aberration_px=1, bloom_strength=0.25,
          fast_bloom=True, noise_strength=1.5, vignette_strength=0.25, persistence=0.6,
          pixel_size=1, glitch_amp_px=6, glitch_height_frac=0.3, scanline_speed_px_s=120.0)
C3_FLAGS = [
    "--scanline-strength", "0.6", "--triad-strength", "0.35", "--triad-softness", "0.5",
    "--aberration-px", "1", "--bloom-sigma", "1.2", "--bloom-strength", "0.25",
    "--no-fast-bloom", "--noise-strength", "1.5", "--vignette-strength", "0.25",
    "--persistence", "0", "--pixel-size", "2", "--grain-size", "2",
    "--warp-strength", "0.15", "--flicker-strength", "0.2", "--flicker-hz", "2",
    "--brightness", "0.02", "--contrast", "1.05", "--gamma", "1.1",
    "--saturation", "0.9", "--temperature", "0.1",
]
C4_FLAGS = [
    "--scanline-strength", "0.6", "--triad-strength", "0.35", "--aberration-px", "1",
    "--bloom-strength", "0.25", "--fast-bloom", "--noise-strength", "1.5",
    "--vignette-strength", "0.25", "--persistence", "0.6", "--pixel-size", "1",
    "--glitch-amp", "6", "--glitch-height", "0.3", "--scanline-speed", "120",
]
# the staged step (2-D scanlines) and the text overlays
C3_ANGLED = dict(C3, scanline_angle=5.0, scanline_thickness=1.5)
C3_ANGLED_TEXT = dict(text="CH 3", size=48, after=True)
C3_ANGLED_FLAGS = [*C3_FLAGS, "--scanline-angle", "5", "--scanline-thickness", "1.5",
                   "--text", "CH 3", "--text-size", "48", "--text-after"]
DEF_ANGLED = dict(scanline_angle=12.0, scanline_thickness=2.0)
DEF_ANGLED_FLAGS = ["--scanline-angle", "12", "--scanline-thickness", "2"]
C4_TEXT = dict(text="PLAY", size=48, after=False)
C4_TEXT_FLAGS = [*C4_FLAGS, "--text", "PLAY", "--text-size", "48"]
FUSED_TOL = 2e-6  # f32, same op order on both sides (-fmad=false)
LSB_TOL = 1
# f32 operations per output value, estimated from the kernels' sources for
# the stages these specs turn on (rounded up; the FP64 grade pow of c3 is
# not counted). At these counts every kernel is bound by bytes.
OPS_PER_VALUE = {"fused_pipeline": 40, "fused_pipeline_gaussian": 70, "warp_planar": 12,
                 "persistence_scan": 6, "glitch_shear": 0, "fused_pipeline_f32in": 40,
                 "bloom3_planar": 45, "bloom3_fast_planar": 16}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def synth(n: int, h: int, w: int, seed: int) -> np.ndarray:
    """(n, h, w, 3) uint8 RGB frames: moving gradients plus texture."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    out = np.empty((n, h, w, 3), np.uint8)
    for i in range(n):
        f = (xx + 2 * yy + 9 * i) % 256
        out[i, ..., 0] = f
        out[i, ..., 1] = 255 - f
        out[i, ..., 2] = (f * 3 + i) % 256
        out[i, ::7] = rng.integers(0, 256, (out[i, ::7].shape), dtype=np.uint8)
    return out


def synth_overlay(h: int, w: int, seed: int) -> np.ndarray:
    """(h, w, 4) uint8 RGBA: a seeded text-like box, clear elsewhere."""
    rng = np.random.default_rng(seed)
    ov = np.zeros((h, w, 4), np.uint8)
    y0, x0 = h // 10, w // 10
    ov[y0:y0 + h // 8, x0:x0 + w // 3] = rng.integers(
        0, 256, (h // 8, w // 3, 4), dtype=np.uint8)
    return ov


def time_ms(fn, iters: int = 10) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def nbytes(*ts) -> int:
    return sum(int(t.numel() * t.element_size()) for t in ts if t is not None)


def bound(name: str, bytes_moved: int, values_out: int) -> tuple[float, str]:
    """Least time for the work: bytes (each input read once, each output
    written once) over the memory rate, or f32 operations over the f32
    rate, whichever is larger."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = OPS_PER_VALUE[name] * values_out / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def planar_gbr(frames: np.ndarray):
    import torch

    return torch.from_numpy(np.ascontiguousarray(
        np.transpose(frames, (0, 3, 1, 2))[:, [1, 2, 0]])).cuda()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    # ---- 1. the card and the host ----
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi: no output"
    from pythoncrt_tpu_torch.io import video as vio
    from pythoncrt_tpu_torch.kernels import _build

    nvcc = subprocess.run([_build.find_nvcc(), "--version"], capture_output=True,
                          text=True, timeout=60).stdout.strip().splitlines()[-1]
    try:
        import cv2
        cv2_ver = cv2.__version__
    except ImportError:
        cv2_ver = None
    ffmpeg = vio.find_ffmpeg()
    from pythoncrt_tpu_torch import TextParams
    from pythoncrt_tpu_torch import text as ptext

    try:  # the text paths render through the CLI when PIL can rasterize
        ptext.rasterize_text(64, 16, TextParams(text="x"))
        import PIL

        path = getattr(ptext._resolve_font("", 48), "path", None)
        pil = f"PIL {PIL.__version__} ({path if isinstance(path, str) else 'its built-in font'})"
    except ImportError:
        pil = None
    print(f"[1] card: {card}")
    print(f"[1] python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"torch CUDA {torch.version.cuda}, nvcc: {nvcc}")
    print(f"[1] ffmpeg: {ffmpeg or 'absent'}, cv2: {cv2_ver or 'absent'}, text rasterizer: "
          f"{pil or 'absent (no PIL)'}", flush=True)

    # ---- 2. build ----
    t0 = time.perf_counter()
    _build.library()
    print(f"[2] kernels built in {time.perf_counter() - t0:.2f}s "
          f"(nvcc, {len(_build.SOURCES)} sources in parallel + link: "
          f"{_build.build_seconds:.2f}s)")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"[2] ptxas: {line.strip()}")
    sys.stdout.flush()

    from pythoncrt_tpu_torch import CRTEngine, EffectParams, oracle
    from pythoncrt_tpu_torch.kernels import bloom3 as kbloom3
    from pythoncrt_tpu_torch.kernels import fused as kfused
    from pythoncrt_tpu_torch.kernels import glitch as kglitch
    from pythoncrt_tpu_torch.kernels import persist as kpersist
    from pythoncrt_tpu_torch.kernels import warp as kwarp

    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    configs = {"defaults": EffectParams(), "c4": EffectParams(**C4), "c3": EffectParams(**C3),
               "c3-angled": EffectParams(**C3_ANGLED, text=TextParams(**C3_ANGLED_TEXT)),
               "defaults-angled": EffectParams(**DEF_ANGLED),
               "c4-text": EffectParams(**C4, text=TextParams(**C4_TEXT))}
    ov_synth = synth_overlay(H, W, seed=4)  # the parity phases need no font
    table = {}

    def row(kname, src, repl, err, lsb, ms, plain_ms, lib_ms, bytes_moved, values_out,
            tol=FUSED_TOL, note=""):
        bms, by = bound(kname, bytes_moved, values_out)
        lib = f"{lib_ms:.4f} ms/call" if lib_ms is not None else "none (no one PyTorch call)"
        print(f"[3] {kname}{note}: max |kernel - twin| {err:.3g}, max {int(lsb)} LSB; "
              f"kernel {ms:.4f} ms/call ({ms / B:.4f} ms/frame), plain twin "
              f"{plain_ms:.4f} ms/call, library {lib}; bound {bms:.4f} ms/call "
              f"({by}: {bytes_moved / 1e6:.1f} MB) at B={B} {H}x{W} on {card}", flush=True)
        if err > tol or lsb > LSB_TOL:
            fail(f"{kname}{note} disagrees with its twin: {err:.3g} abs, {lsb} LSB")
        table[kname] = dict(name=kname, route="cuda", source=src, replaces=repl, launches=0,
                            max_abs_err=float(err), ms=ms, plain_ms=plain_ms,
                            bound_ms=bms, bound_by=by, library_ms=lib_ms)

    # ---- 3. kernels vs plain twins at the main paths' shapes ----
    frames = synth(B, H, W, seed=1)
    x = planar_gbr(frames)
    fused_out = {}
    for cfg, kname in (("c3", "fused_pipeline_gaussian"), ("defaults", "fused_pipeline")):
        eng = CRTEngine(configs[cfg], H, W, FPS, rng="host", layout="planar",
                        channel_order="gbr", device=dev)
        kw = eng.fused_operands(eng.make_aux(np.arange(B)))
        got = kfused.fused_pipeline(x, eng.spec, eng.fused_tables, **kw)
        want = kfused.fused_pipeline_ref(x, eng.spec, eng.fused_tables, **kw)
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            fail(f"{kname}: non-finite output")
        err = (got - want).abs().max().item()
        lsb = (torch.round(got * 255) - torch.round(want * 255)).abs().max().item()
        ms = time_ms(lambda: kfused.fused_pipeline(x, eng.spec, eng.fused_tables, **kw))
        plain = time_ms(lambda: kfused.fused_pipeline_ref(x, eng.spec, eng.fused_tables, **kw),
                        iters=3)
        row(kname, "pythoncrt_tpu_torch/csrc/fused.cu", "pythoncrt_tpu/kernels/fused.py:680",
            err, lsb, ms, plain, None, nbytes(x, got, *kw.values()), got.numel(),
            note=f" ({cfg} spec, {'fast' if eng.spec.fast else 'gaussian'} core)")
        fused_out[cfg] = (eng, got)
        del want

    eng3, fz = fused_out["c3"]
    wp = kwarp.warp_planar(fz, eng3.warp_tables, emit_u8=True)
    wp_ref = kwarp.warp_planar_ref(fz, eng3.warp_tables, emit_u8=True)
    wpf = kwarp.warp_planar(fz, eng3.warp_tables)
    wpf_ref = kwarp.warp_planar_ref(fz, eng3.warp_tables)
    map_x, map_y = oracle.barrel_warp_maps(H, W, C3["warp_strength"])
    grid = torch.from_numpy(np.stack([map_x * (2.0 / (W - 1)) - 1.0,
                                      map_y * (2.0 / (H - 1)) - 1.0], -1)).float().cuda()
    grid = grid[None].expand(B, H, W, 2).contiguous()
    gs = torch.nn.functional.grid_sample(fz, grid, mode="bilinear", padding_mode="zeros",
                                         align_corners=True)
    torch.cuda.synchronize()
    print(f"[3] warp_planar: grid_sample (the library call) vs the oracle's taps: max "
          f"{(gs - wpf_ref).abs().max().item():.3g} abs (f32 coordinates renormalized)")
    row("warp_planar", "pythoncrt_tpu_torch/csrc/warp.cu", "pythoncrt_tpu/kernels/warp.py:545",
        (wpf - wpf_ref).abs().max().item(), (wp.int() - wp_ref.int()).abs().max().item(),
        time_ms(lambda: kwarp.warp_planar(fz, eng3.warp_tables, emit_u8=True)),
        time_ms(lambda: kwarp.warp_planar_ref(fz, eng3.warp_tables, emit_u8=True), iters=3),
        time_ms(lambda: torch.nn.functional.grid_sample(
            fz, grid, mode="bilinear", padding_mode="zeros", align_corners=True)),
        nbytes(fz, wp, *eng3.warp_tables), wp.numel())
    del wp, wp_ref, wpf, wpf_ref, gs, grid

    _, fd = fused_out["defaults"]
    p_def = configs["defaults"].persistence
    state = torch.rand((3, H, W), generator=torch.Generator(device=dev).manual_seed(3),
                       device=dev)
    worst_err, worst_lsb = 0.0, 0
    for first in (True, False):
        got, gst = kpersist.persistence_scan(fd, state, first, p_def, emit_u8=True)
        want, wst = kpersist.persistence_scan_ref(fd, state, first, p_def, emit_u8=True)
        torch.cuda.synchronize()
        worst_lsb = max(worst_lsb, (got.int() - want.int()).abs().max().item())
        worst_err = max(worst_err, (gst - wst).abs().max().item())
        if not (torch.equal(got, want) and torch.equal(gst, wst)):
            fail(f"persistence_scan (first={first}) is not bitwise its twin")
    row("persistence_scan", "pythoncrt_tpu_torch/csrc/persist.cu",
        "pythoncrt_tpu/kernels/persist.py:113", worst_err, worst_lsb,
        time_ms(lambda: kpersist.persistence_scan(fd, state, False, p_def, emit_u8=True)),
        time_ms(lambda: kpersist.persistence_scan_ref(fd, state, False, p_def, emit_u8=True),
                iters=3),
        None, nbytes(fd, state, got, gst), fd.numel(), tol=0.0,
        note=" (CLI defaults, stream head and carried state)")
    del got, want, gst, wst

    worst, glitch_times = 0.0, None
    for mode in ("export", "preview"):
        ge = CRTEngine(configs["c4"], H, W, FPS, rng="host", engine=mode, device=dev)
        off = ge.glitch_offsets(ge.make_aux(np.arange(B)))
        seg = ge.consts["glitch_seg_index"]
        y0, rows = ge._glitch_y0, ge._glitch_rows
        if (y0, rows) != (756, 324):
            fail(f"c4 band is rows {y0}+{rows}, expected 756+324")
        img = fused_out["defaults"][1]
        band = img[:, :, y0:].contiguous()
        want = kglitch.shear_planar_ref(band, off, seg)
        got_band = kglitch.shear_planar(band, off, seg)
        got_full = kglitch.shear_planar_inplace(img.clone(), y0, off, seg)
        torch.cuda.synchronize()
        if not (torch.equal(got_band, want) and torch.equal(got_full[:, :, y0:], want)
                and torch.equal(got_full[:, :, :y0], img[:, :, :y0])):
            fail(f"glitch shear ({mode}) is not bitwise its twin")
        worst = max(worst, (got_band - want).abs().max().item())
        if mode == "export":
            idx = torch.remainder(torch.arange(W, device=dev)
                                  + off.long()[:, :, seg.long()], W)[:, None].expand(
                                      B, 3, rows, W).contiguous()
            work = img.clone()
            band_ms = time_ms(lambda: kglitch.shear_planar(band, off, seg))
            print(f"[3] glitch_shear out-of-place band entry (shear_planar, the TPU's "
                  f"glitch.py:165; on no main path): kernel {band_ms:.4f} ms/call "
                  f"({band_ms / B:.4f} ms/frame) on {card}", flush=True)
            glitch_times = (
                time_ms(lambda: kglitch.shear_planar_inplace(work, y0, off, seg)),
                time_ms(lambda: kglitch.shear_planar_ref(band, off, seg), iters=3),
                time_ms(lambda: torch.gather(band, 3, idx)),
                nbytes(band, got_band, off, seg), band.numel())
            del idx, work
        del got_band, got_full, want, band
    row("glitch_shear", "pythoncrt_tpu_torch/csrc/glitch.cu",
        "pythoncrt_tpu/kernels/glitch.py:194", worst, 0, *glitch_times, tol=0.0,
        note=" (c4 band 756+324, export and preview, both entries)")
    del fused_out, fz, fd, state

    # the stand-alone bloom and the fused f32-input mode, each on the
    # pre-bloom image (stages 1-5, synthetic overlay) of its path
    for cfg, kname in (("c3-angled", "bloom3_planar"), ("defaults-angled", "bloom3_fast_planar"),
                       ("c4-text", "fused_pipeline_f32in")):
        eng = CRTEngine(configs[cfg], H, W, FPS, rng="host", layout="planar",
                        channel_order="gbr", device=dev, text_rgba=ov_synth)
        feed = eng._pre_bloom(x)
        if kname == "fused_pipeline_f32in":
            if eng._staged or eng.spec.pre:
                fail(f"{cfg} does not take the fused kernel's f32-input mode")
            kw = eng.fused_operands(eng.make_aux(np.arange(B)))
            run = functools.partial(kfused.fused_pipeline, feed, eng.spec, eng.fused_tables, **kw)
            twin = functools.partial(kfused.fused_pipeline_ref, feed, eng.spec, eng.fused_tables,
                                     **kw)
            src, repl, extra = ("pythoncrt_tpu_torch/csrc/fused.cu",
                                "pythoncrt_tpu/kernels/fused.py:680", list(kw.values()))
            note = " (c4-text spec: text before the bloom, fast core)"
        else:
            if not eng._staged or eng.bloom3_spec is None:
                fail(f"{cfg} does not take the staged step")
            spec = eng.bloom3_spec
            src = "pythoncrt_tpu_torch/csrc/bloom3.cu"
            if spec.fast:
                tabs = (eng.fused_tables.fast_taps, eng.fused_tables.fast_extent)
                run = functools.partial(kbloom3.bloom3_fast_planar, feed, spec, tabs)
                twin = functools.partial(kbloom3.bloom3_fast_planar_ref, feed, spec, tabs)
                repl, extra = "pythoncrt_tpu/kernels/bloom3.py:495", list(tabs[0])
                note = " (defaults-angled: half-res down and up)"
            else:
                run = functools.partial(kbloom3.bloom3_planar, feed, spec)
                twin = functools.partial(kbloom3.bloom3_planar_ref, feed, spec)
                repl, extra = "pythoncrt_tpu/kernels/bloom3.py:274", []
                note = f" (c3-angled: sigma 1.2, {len(spec.taps)} taps)"
        got, want = run(), twin()
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            fail(f"{kname}: non-finite output")
        row(kname, src, repl, (got - want).abs().max().item(),
            (torch.round(got * 255) - torch.round(want * 255)).abs().max().item(),
            time_ms(run), time_ms(twin, iters=3), None, nbytes(feed, got, *extra), got.numel(),
            note=note)
        del feed, got, want, run, twin
    del x

    # ---- 4. end to end against the oracle ----
    for cfg, n, nb in (("c3", 2, 1), ("defaults", 4, 2), ("c4", 4, 2), ("c3-angled", 2, 1),
                       ("defaults-angled", 4, 2), ("c4-text", 4, 2)):
        p = configs[cfg]
        clip = synth(n, H, W, seed=2)
        ov = ov_synth if p.text.enabled else None
        eng = CRTEngine(p, H, W, FPS, rng="host", device=dev, text_rgba=ov)
        outs, st = [], None
        for k in range(nb):
            idx = np.arange(k * n // nb, (k + 1) * n // nb)
            o, st = eng.process(clip[idx], idx, st)
            outs.append(o.cpu().numpy())
        got = np.concatenate(outs)
        aux = eng.make_aux(np.arange(n))
        prev, want = None, []
        for j in range(n):
            img = oracle.apply_effects(clip[j], eng.params, phase_px=float(aux.phase[j]),
                                       time_sec=j / FPS, noise_field=aux.noise[j], text_rgba=ov)
            prev = oracle.persistence_blend(prev, img,
                                            p.persistence if p.persistence_on else 0.0)
            want.append(oracle.ops.to_uint8(prev))
        d = np.abs(got.astype(np.int32) - np.stack(want).astype(np.int32))
        frac = (d > 0).mean()
        print(f"[4] engine vs oracle, {cfg}, {n} frames {H}x{W} in {nb} batch(es), state "
              f"carried: max {d.max()} LSB, {frac:.3e} of values off", flush=True)
        if d.max() > LSB_TOL or frac >= 1e-3 or got.shape != (n, H, W, 3):
            fail(f"engine disagrees with the oracle on {cfg}")
        if eng._staged:
            mask = eng._scanline_mask_2d(aux.phase).cpu().numpy()
            ref = np.stack([oracle.scanline_mask_2d(
                H, W, p.scanline_strength, p.scanline_period_px, float(ph), p.scanline_angle,
                p.scanline_thickness) for ph in aux.phase])
            dm = np.abs(mask - ref)
            print(f"[4] 2-D scanline mask vs the oracle's (NumPy f32 sin and pow), {cfg}: "
                  f"max {dm.max():.3g} abs, {(dm > 0).mean():.3e} of values differ", flush=True)
            if dm.max() > 1e-5:
                fail(f"2-D scanline mask of {cfg} is off the oracle's by {dm.max():.3g}")

    # ---- 5. the main paths ----
    counters = {"fused_pipeline": kfused, "warp_planar": kwarp,
                "persistence_scan": kpersist, "glitch_shear": kglitch, "bloom3": kbloom3}
    paths = (  # name, flags, params, frames, kernels that must launch
        ("defaults", [], configs["defaults"], N_MAIN, ("fused_pipeline", "persistence_scan")),
        ("c4", C4_FLAGS, configs["c4"], N_MAIN,
         ("fused_pipeline", "glitch_shear", "persistence_scan")),
        ("c3", C3_FLAGS, configs["c3"], N_C3, ("fused_pipeline", "warp_planar")),
        ("c3-angled", C3_ANGLED_FLAGS, configs["c3-angled"], N_C3, ("bloom3", "warp_planar")),
        ("defaults-angled", DEF_ANGLED_FLAGS, configs["defaults-angled"], N_MAIN,
         ("bloom3", "persistence_scan")),
        ("c4-text", C4_TEXT_FLAGS, configs["c4-text"], N_MAIN,
         ("fused_pipeline", "glitch_shear", "persistence_scan")),
    )

    def overlay(p):
        """The overlay a render of p composites: PIL's, or the synthetic one."""
        if not p.text.enabled:
            return None
        return ptext.overlay_for(W, H, p.text) if pil else ov_synth
    clip = synth(N_MAIN, H, W, seed=3)
    launches = {k: {} for k in counters}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        if cv2_ver:  # io.video.probe_clip reads clips through cv2
            for n in sorted({N_MAIN, N_C3}):
                wr, _ = vio.open_writer(os.path.join(tmp, f"in{n}.mp4"), W, H, FPS)
                for f in clip[:n]:
                    wr.write_frame(f)
                wr.close()
        for pname, flags, p, n, needs in paths:
            for mod in counters.values():
                mod.launches = 0
            text = ""
            if p.text.enabled:
                text = (f"; text rasterized by {pil}" if pil else
                        "; text: a seeded synthetic overlay (no PIL on this host)")
            if cv2_ver and (pil or not p.text.enabled):
                from pythoncrt_tpu_torch import cli

                outp = os.path.join(tmp, f"out_{pname}.mp4")
                t0 = time.perf_counter()
                rc = cli.main(["--input", os.path.join(tmp, f"in{n}.mp4"), "--output", outp,
                               *flags, "--batch-size", str(B), "--device", "cuda"])
                wall = time.perf_counter() - t0
                if rc != 0:
                    fail(f"cli.main ({pname}) exited {rc}")
                n_out = vio.probe_clip(outp).frame_count
                how = f"cli.main ({'ffmpeg' if ffmpeg else 'cv2'} codecs)"
            else:
                from pythoncrt_tpu_torch.pipeline import render_stream

                class Reader:
                    out_h, out_w, i = H, W, 0

                    def read_into(self, buf):
                        if self.i >= n:
                            return False
                        buf[...] = clip[self.i]
                        self.i += 1
                        return True

                    def close(self):
                        pass

                class Writer:
                    def __init__(self):
                        self.frames = []

                    def write_frame(self, f):
                        self.frames.append(f.copy())

                    def close(self):
                        pass

                wtr = Writer()
                t0 = time.perf_counter()
                n_out = render_stream(Reader(), wtr, CRTEngine(p, H, W, FPS, device=dev,
                                                               text_rgba=overlay(p)),
                                      batch_size=B)
                wall = time.perf_counter() - t0
                out_arr = np.stack(wtr.frames)
                if not (out_arr.shape == (n, H, W, 3) and out_arr.std() > 0):
                    fail(f"render_stream ({pname}) output has the wrong shape or is constant")
                how = "render_stream (in-memory frames: no codec backend or no PIL)"
            got = {k: mod.launches for k, mod in counters.items()}
            for k, v in got.items():
                launches[k][pname] = v
            print(f"[5] main path {pname}: {how}{text}; {n_out} frames out of {n}; launches "
                  f"{got}; {n / wall:.2f} fps wall (codecs included) on {card}", flush=True)
            if n_out != n:
                fail(f"main path {pname} wrote {n_out} frames, expected {n}")
            missing = [k for k in needs if got[k] < 1]
            if missing:
                fail(f"main path {pname}: kernels never launched: {missing}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # device-side throughput of the same steps (no codecs): batches of 8
    xs = planar_gbr(clip)
    for pname, _, p, n, _ in paths:
        eng_dev = CRTEngine(p, H, W, FPS, layout="planar", channel_order="gbr", device=dev,
                            text_rgba=overlay(p))
        st = None
        _, st = eng_dev.process(xs[:B], np.arange(B), st)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for k in range(0, N_MAIN, B):
            _, st = eng_dev.process(xs[k:k + B], np.arange(k, k + B), st)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        print(f"[5] engine step alone, {pname} (frames already on the card): "
              f"{N_MAIN / dt:.2f} fps on {card}", flush=True)

    # ---- 6. results ----
    # the fused kernel's modes share one counter, as do the two bloom3
    # variants: each runs on the paths named here
    runs_on = {"fused_pipeline_gaussian": ("c3",), "fused_pipeline": ("defaults", "c4"),
               "fused_pipeline_f32in": ("c4-text",), "bloom3_planar": ("c3-angled",),
               "bloom3_fast_planar": ("defaults-angled",)}
    for kname, entry in table.items():
        base = next((k for k in ("fused_pipeline", "bloom3") if kname.startswith(k)), kname)
        by_path = {pn: v for pn, v in launches[base].items()
                   if pn in runs_on.get(kname, launches[base])}
        entry["launches"], entry["launches_by_path"] = sum(by_path.values()), by_path
    print(f"card: {card}")
    print(card)
    print(json.dumps({"kernels": list(table.values())}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
