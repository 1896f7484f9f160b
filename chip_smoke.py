"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each must pass; any failure exits non-zero):

1. The card (nvidia-smi name and power limit), torch/CUDA/nvcc versions,
   and which codec backends (ffmpeg, cv2) the host has.
2. Build the CUDA kernels from pythoncrt_tpu_torch/csrc (nvcc, sm_90a).
3. Each kernel against its plain PyTorch twin on the card, at 1080p with
   a batch of 8 and the c3 constants: max abs error, max uint8 LSB, and
   CUDA-event time per call of the kernel and of the twin.
4. The engine on the card (rng="host") against the NumPy oracle on two
   1080p frames: <= 1 uint8 LSB.
5. The c3 main path at 1080p, 32 frames, batch 8: through
   ``pythoncrt_tpu_torch.cli.main`` on a synthetic clip when a codec
   backend exists, else through ``render_stream`` with in-memory frames.
   Both kernels' launch counters must rise during that run.
6. One JSON line with the kernel table, then the result line.

It imports nothing of JAX. Without a CUDA device it exits 2 and prints
no result.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

H, W, B, FPS, N_MAIN = 1080, 1920, 8, 24.0, 32
C3_FLAGS = [
    "--scanline-strength", "0.6", "--triad-strength", "0.35", "--triad-softness", "0.5",
    "--aberration-px", "1", "--bloom-sigma", "1.2", "--bloom-strength", "0.25",
    "--no-fast-bloom", "--noise-strength", "1.5", "--vignette-strength", "0.25",
    "--persistence", "0", "--pixel-size", "2", "--grain-size", "2",
    "--warp-strength", "0.15", "--flicker-strength", "0.2", "--flicker-hz", "2",
    "--brightness", "0.02", "--contrast", "1.05", "--gamma", "1.1",
    "--saturation", "0.9", "--temperature", "0.1",
]
FUSED_TOL = 2e-6  # f32, same op order on both sides (-fmad=false)
LSB_TOL = 1


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def c3_params():
    from pythoncrt_tpu_torch import EffectParams

    return EffectParams(
        scanline_strength=0.6, triad_strength=0.35, triad_softness=0.5,
        aberration_px=1, bloom_sigma=1.2, bloom_strength=0.25, fast_bloom=False,
        noise_strength=1.5, vignette_strength=0.25, persistence=0.0, pixel_size=2,
        grain_size=2, warp_strength=0.15, flicker_strength=0.2, flicker_hz=2.0,
        brightness=0.02, contrast=1.05, gamma=1.1, saturation=0.9, temperature=0.1)


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
    from pythoncrt_tpu_torch.kernels import _build

    nvcc = subprocess.run([_build.find_nvcc(), "--version"], capture_output=True,
                          text=True, timeout=60).stdout.strip().splitlines()[-1]
    try:
        import cv2
        cv2_ver = cv2.__version__
    except ImportError:
        cv2_ver = None
    from pythoncrt_tpu.io import video as vio

    ffmpeg = vio.find_ffmpeg()
    print(f"[1] card: {card}")
    print(f"[1] python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"torch CUDA {torch.version.cuda}, nvcc: {nvcc}")
    print(f"[1] ffmpeg: {ffmpeg or 'absent'}, cv2: {cv2_ver or 'absent'}", flush=True)

    # ---- 2. build ----
    t0 = time.perf_counter()
    _build.library()
    print(f"[2] kernels built in {time.perf_counter() - t0:.2f}s "
          f"(nvcc {_build.build_seconds:.2f}s)")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"[2] ptxas: {line.strip()}")
    sys.stdout.flush()

    from pythoncrt_tpu_torch import CRTEngine
    from pythoncrt_tpu_torch.kernels import fused as kfused
    from pythoncrt_tpu_torch.kernels import warp as kwarp

    dev = torch.device("cuda")
    p = c3_params()
    name = torch.cuda.get_device_name(0)

    # ---- 3. kernels vs plain twins at the main path's shapes ----
    eng = CRTEngine(p, H, W, FPS, rng="host", layout="planar", channel_order="gbr",
                    device=dev)
    frames = synth(B, H, W, seed=1)
    x = torch.from_numpy(np.ascontiguousarray(
        np.transpose(frames, (0, 3, 1, 2))[:, [1, 2, 0]])).to(dev)
    kw = eng.fused_operands(eng.make_aux(np.arange(B)))
    fz = kfused.fused_pipeline(x, eng.spec, eng.fused_tables, **kw)
    fz_ref = kfused.fused_pipeline_ref(x, eng.spec, eng.fused_tables, **kw)
    wp = kwarp.warp_planar(fz, eng.warp_tables, emit_u8=True)
    wp_ref = kwarp.warp_planar_ref(fz, eng.warp_tables, emit_u8=True)
    wpf = kwarp.warp_planar(fz, eng.warp_tables)
    wpf_ref = kwarp.warp_planar_ref(fz, eng.warp_tables)
    torch.cuda.synchronize()
    table = []
    for kname, src, repl, got, want, got8, want8, fn, fn_ref in (
        ("fused_pipeline", "pythoncrt_tpu_torch/csrc/fused.cu",
         "pythoncrt_tpu/kernels/fused.py:680", fz, fz_ref, None, None,
         lambda: kfused.fused_pipeline(x, eng.spec, eng.fused_tables, **kw),
         lambda: kfused.fused_pipeline_ref(x, eng.spec, eng.fused_tables, **kw)),
        ("warp_planar", "pythoncrt_tpu_torch/csrc/warp.cu",
         "pythoncrt_tpu/kernels/warp.py:545", wpf, wpf_ref, wp, wp_ref,
         lambda: kwarp.warp_planar(fz, eng.warp_tables, emit_u8=True),
         lambda: kwarp.warp_planar_ref(fz, eng.warp_tables, emit_u8=True)),
    ):
        if not torch.isfinite(got).all():
            fail(f"{kname}: non-finite output")
        err = (got - want).abs().max().item()
        lsb = 0
        if got8 is not None:
            lsb = (got8.int() - want8.int()).abs().max().item()
        else:  # the fused kernel's u8 values: the cast of its f32 output
            lsb = (torch.round(got * 255) - torch.round(want * 255)).abs().max().item()
        ms, plain_ms = time_ms(fn), time_ms(fn_ref, iters=3)
        print(f"[3] {kname}: max |kernel - twin| {err:.3g}, max {int(lsb)} LSB; "
              f"kernel {ms:.4f} ms/call ({ms / B:.4f} ms/frame), plain twin "
              f"{plain_ms:.4f} ms/call ({plain_ms / B:.4f} ms/frame) at B={B} "
              f"{H}x{W} on {card}", flush=True)
        if err > FUSED_TOL or lsb > LSB_TOL:
            fail(f"{kname} disagrees with its twin: {err:.3g} abs, {lsb} LSB")
        table.append(dict(name=kname, route="cuda", source=src, replaces=repl,
                          launches=0, max_abs_err=err, ms=ms, plain_ms=plain_ms))
    del fz, fz_ref, wp, wp_ref, wpf, wpf_ref

    # ---- 4. end to end against the oracle ----
    from pythoncrt_tpu_torch import oracle

    two = synth(2, H, W, seed=2)
    got, _ = CRTEngine(p, H, W, FPS, rng="host", device=dev).process(two)
    got = got.cpu().numpy()
    ref_eng = CRTEngine(p, H, W, FPS, rng="host", device="cpu")
    aux = ref_eng.make_aux(np.arange(2))
    want = np.stack([oracle.ops.to_uint8(oracle.apply_effects(
        two[j], p, phase_px=float(aux.phase[j]), time_sec=j / FPS,
        noise_field=aux.noise[j])) for j in range(2)])
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    print(f"[4] engine vs oracle, 2 frames {H}x{W}: max {d.max()} LSB, "
          f"{(d > 0).mean():.3e} of values off", flush=True)
    if d.max() > LSB_TOL or got.shape != (2, H, W, 3):
        fail("engine disagrees with the oracle")

    # ---- 5. the main path ----
    clip = synth(N_MAIN, H, W, seed=3)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        kfused.launches = kwarp.launches = 0
        if cv2_ver:  # vio.probe_clip reads clips through cv2
            inp, outp = os.path.join(tmp, "in.mp4"), os.path.join(tmp, "out.mp4")
            wr, _ = vio.open_writer(inp, W, H, FPS)
            for f in clip:
                wr.write_frame(f)
            wr.close()
            kfused.launches = kwarp.launches = 0
            from pythoncrt_tpu_torch import cli

            t0 = time.perf_counter()
            rc = cli.main(["--input", inp, "--output", outp, *C3_FLAGS,
                           "--batch-size", str(B), "--device", "cuda"])
            wall = time.perf_counter() - t0
            launches = (kfused.launches, kwarp.launches)
            if rc != 0:
                fail(f"cli.main exited {rc}")
            n_out = vio.probe_clip(outp).frame_count
            path = f"cli.main ({'ffmpeg' if ffmpeg else 'cv2'} codecs)"
        else:
            from pythoncrt_tpu_torch.pipeline import render_stream

            class Reader:
                out_h, out_w, i = H, W, 0

                def read_into(self, buf):
                    if self.i >= N_MAIN:
                        return False
                    buf[...] = clip[self.i]
                    self.i += 1
                    return True

                def close(self):
                    pass

            class Writer:
                frames = []

                def write_frame(self, f):
                    self.frames.append(f.copy())

                def close(self):
                    pass

            wtr = Writer()
            eng_main = CRTEngine(p, H, W, FPS, device=dev)
            t0 = time.perf_counter()
            n_out = render_stream(Reader(), wtr, eng_main, batch_size=B)
            wall = time.perf_counter() - t0
            launches = (kfused.launches, kwarp.launches)
            out_arr = np.stack(wtr.frames)
            if not (out_arr.shape == (N_MAIN, H, W, 3) and out_arr.std() > 0):
                fail("render_stream output has the wrong shape or is constant")
            path = "render_stream (in-memory frames: no codec backend on this host)"
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"[5] main path: {path}; {n_out} frames out of {N_MAIN}; "
          f"launches fused={launches[0]} warp={launches[1]}; "
          f"{N_MAIN / wall:.2f} fps wall (codecs included) on {card}", flush=True)
    if n_out != N_MAIN:
        fail(f"main path wrote {n_out} frames, expected {N_MAIN}")
    if min(launches) < 1:
        fail(f"a kernel of the path never launched: {launches}")
    table[0]["launches"], table[1]["launches"] = launches

    # device-side throughput of the same step (no codecs): batches of 8
    eng_dev = CRTEngine(p, H, W, FPS, layout="planar", channel_order="gbr", device=dev)
    xs = torch.from_numpy(np.ascontiguousarray(
        np.transpose(clip, (0, 3, 1, 2))[:, [1, 2, 0]])).to(dev)
    eng_dev.process(xs[:B], np.arange(B))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for k in range(0, N_MAIN, B):
        eng_dev.process(xs[k:k + B], np.arange(k, k + B))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    print(f"[5] engine step alone (frames already on the card): "
          f"{N_MAIN / dt:.2f} fps on {card}", flush=True)

    # ---- 6. results ----
    print(f"card: {card}")
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
