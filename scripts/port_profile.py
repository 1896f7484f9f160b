"""Where the time goes in the PyTorch/CUDA port's engine step, on one GPU.

    python3 scripts/port_profile.py [--out port_profile.json]

For each configuration (c3, the CLI defaults, c4, the angled-scanline
and text paths: c3-angled, defaults-angled, c4-text, with a seeded
synthetic text overlay, and the bloom opt-ins c3-bloom2, defaults-bloom2
and c3-stripe, their variable set while the engine is built) at 1080p
with a batch of 8, and for c5 (the c4 params at 3840x2160, 4 clips x 8
frames per step through MultiClipEngine, 2 steps per loop), native rng,
planar gbrp frames already on the card:

- engine fps: 5 repeats of 32 frames (4 batches, the state carried; c5:
  64 frames in 2 steps), median, min and max;
- each kernel of the step, and the staged step's torch-op stages (the
  pre-bloom, the post-bloom with the 2-D mask, the text composite): 5
  repeats of 20 calls timed with CUDA events on the step's own
  operands, median ms per call;
- the fused kernel's wrapper on the host: microseconds per
  fused_pipeline call, 200 calls issued back to back (the kernels queue
  behind them; c5: 40), median of 5;
- a torch.profiler trace of 4 batches: device time per kernel name and
  the sum; the device's idle share against the unprofiled loop's wall
  (device_busy, idle_share), and against the profiled loop's;
- nvidia-smi clocks and power drawn during the run.

Prints one JSON object per configuration and writes them all to --out
(a JSON list).
Imports nothing of JAX or of the JAX package; exits 2 without a CUDA
device.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

H, W, B, N = 1080, 1920, 8, 32
CONFIGS = {
    "c3": dict(scanline_strength=0.6, triad_strength=0.35, triad_softness=0.5,
               aberration_px=1, bloom_sigma=1.2, bloom_strength=0.25, fast_bloom=False,
               noise_strength=1.5, vignette_strength=0.25, persistence=0.0, pixel_size=2,
               grain_size=2, warp_strength=0.15, flicker_strength=0.2, flicker_hz=2.0,
               brightness=0.02, contrast=1.05, gamma=1.1, saturation=0.9, temperature=0.1),
    "defaults": {},
    "c4": dict(scanline_strength=0.6, triad_strength=0.35, aberration_px=1,
               bloom_strength=0.25, fast_bloom=True, noise_strength=1.5,
               vignette_strength=0.25, persistence=0.6, pixel_size=1, glitch_amp_px=6,
               glitch_height_frac=0.3, scanline_speed_px_s=120.0),
}
CONFIGS["c3-angled"] = dict(CONFIGS["c3"], scanline_angle=5.0, scanline_thickness=1.5)
CONFIGS["defaults-angled"] = dict(scanline_angle=12.0, scanline_thickness=2.0)
CONFIGS["c4-text"] = dict(CONFIGS["c4"])
CONFIGS["c3-bloom2"] = CONFIGS["c3-stripe"] = dict(CONFIGS["c3"])
CONFIGS["defaults-bloom2"] = {}
CONFIGS["c5"] = dict(CONFIGS["c4"])
TEXT = {"c3-angled": dict(text="CH 3", size=48, after=True),
        "c4-text": dict(text="PLAY", size=48, after=False)}
OPTINS = {"c3-bloom2": {"PCRT_BLOOM2_GAUSS": "1"}, "defaults-bloom2": {"PCRT_BLOOM2_FAST": "1"},
          "c3-stripe": {"PCRT_PALLAS_BLOOM": "1"}}  # the JAX engine's bloom opt-ins
H4, W4, CLIPS = 2160, 3840, 4  # c5


@contextlib.contextmanager
def optin_env(name: str):
    """The bloom opt-in variables of ``name`` set, and no other's."""
    names = {k for env in OPTINS.values() for k in env}
    saved = {k: os.environ.pop(k, None) for k in names}
    os.environ.update(OPTINS.get(name, {}))
    try:
        yield
    finally:
        for k in names:
            os.environ.pop(k, None)
            if saved[k] is not None:
                os.environ[k] = saved[k]


def synth_overlay(seed: int = 4) -> np.ndarray:
    """(H, W, 4) uint8 RGBA: a seeded text-like box, clear elsewhere."""
    rng = np.random.default_rng(seed)
    ov = np.zeros((H, W, 4), np.uint8)
    ov[H // 10:H // 10 + H // 8, W // 10:W // 10 + W // 3] = rng.integers(
        0, 256, (H // 8, W // 3, 4), dtype=np.uint8)
    return ov


def smi(fields: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()


def events_ms(fn, iters: int = 20, repeats: int = 5) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(repeats):
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(iters):
            fn()
        t1.record()
        torch.cuda.synchronize()
        runs.append(t0.elapsed_time(t1) / iters)
    return statistics.median(runs)


def host_us(fn, calls: int = 200, repeats: int = 5) -> float:
    """Host microseconds per call of fn, the calls issued back to back
    without waiting for the card, median of the repeats."""
    import torch

    fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        runs.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return statistics.median(runs)


def kernel_device_ms(fn, lib, match: str, calls: int = 20) -> tuple:
    """Device time per call of the kernels whose name holds ``match`` over
    ``calls`` calls of ``fn``, and of every kernel of ``calls`` calls of
    ``lib`` (the library yardstick) in the same torch.profiler window: the
    kernels' durations, the host work of the calls left out. Raises
    RuntimeError when three windows recorded no device time for either.
    A profiler window opened before a device_busy reading in the same
    process leaves that reading short, so take these after it."""
    import torch

    fn()
    lib()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for _ in range(3):  # a window whose kernel records did not arrive is taken again
        with torch.profiler.profile(activities=acts) as prof:
            for f in (fn, lib):
                for _ in range(calls):
                    f()
                torch.cuda.synchronize()
        ours = theirs = 0.0
        for ev in prof.key_averages():
            if ev.device_type != torch.autograd.DeviceType.CUDA:
                continue
            us = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0.0)
            if match in ev.key:
                ours += us
            else:
                theirs += us
        if ours > 0 and theirs > 0:
            return ours / 1e3 / calls, theirs / 1e3 / calls
    raise RuntimeError(f"torch.profiler recorded no device time for kernels named {match!r} "
                       f"in three windows")


def device_busy(fn) -> dict:
    """torch.profiler (CPU and CUDA activity) over one call of ``fn``,
    synchronized before and after: ``busy_ms``, the device's time in
    kernels and copies; ``wall_ms``, the profiled window, the profiler's
    host overhead and the device's drain included; ``by_kernel``, the
    device ms of the top 12 names. The idle share comes from ``busy_ms``
    and an unprofiled wall (idle_share): this window's own wall counts the
    profiler's cost per host op and the fill of an empty queue as idle.
    chip_smoke.py and scripts/port_spc.py read the idle share this way."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_kernel = {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "cuda_time_total", 0.0)
        if dev_us and ev.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[ev.key] = by_kernel.get(ev.key, 0.0) + dev_us / 1e3
    top = dict(sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12])
    return {"busy_ms": sum(by_kernel.values()), "wall_ms": wall * 1e3, "by_kernel": top}


def idle_share(busy_ms: float, wall_ms: float) -> float:
    """The device's idle share of ``wall_ms``, the unprofiled wall of the
    same work run back to back: 1 - busy / wall, floored at 0."""
    return max(0.0, 1.0 - busy_ms / wall_ms)


def timing(name, shape, frames, loop, kernels, host=None) -> dict:
    """Engine fps over 5 repeats of loop, the profiled split, the card."""
    loop()
    fps = []
    for _ in range(5):
        t0 = time.perf_counter()
        loop()
        fps.append(frames / (time.perf_counter() - t0))
    prof = device_busy(loop)
    prof_wall, device_ms, top = prof["wall_ms"], prof["busy_ms"], prof["by_kernel"]
    wall = frames / statistics.median(fps) * 1e3
    return dict(
        config=name, shape=shape, frames=frames, card=smi("name,power.limit"),
        engine_fps_median=statistics.median(fps), engine_fps_min=min(fps),
        engine_fps_max=max(fps), kernel_ms_per_call=kernels, host_us_per_call=host or {},
        profiled_loop_wall_ms=prof_wall, device_ms_in_loop=device_ms,
        device_idle_share_of_profiled_loop=idle_share(device_ms, prof_wall),
        unprofiled_loop_wall_ms=wall, device_idle_share_of_unprofiled_loop=idle_share(device_ms,
                                                                                      wall),
        device_ms_by_kernel=top,
        clocks_power=smi("clocks.sm,power.draw,power.limit,temperature.gpu"))


def profile_c5(params: dict) -> dict:
    """c5: 4 clips x 8 frames at 3840x2160 per step through MultiClipEngine."""
    import torch

    from pythoncrt_tpu_torch import CRTEngine, EffectParams, MultiClipEngine
    from pythoncrt_tpu_torch.kernels import fused as kfused
    from pythoncrt_tpu_torch.kernels import glitch as kglitch
    from pythoncrt_tpu_torch.kernels import persist as kpersist

    eng = CRTEngine(EffectParams(**params), H4, W4, 24.0, layout="planar", channel_order="gbr",
                    device="cuda")
    mc = MultiClipEngine(eng)
    gen = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randint(0, 256, (CLIPS, B, 3, H4, W4), generator=gen, device="cuda",
                      dtype=torch.uint8)
    idx = np.tile(np.arange(B), (CLIPS, 1))

    def loop():
        st = None
        for k in range(2):
            _, st = mc.process(x, idx + k * B, st)
        torch.cuda.synchronize()

    flat = x.reshape(CLIPS * B, 3, H4, W4)
    aux = eng.make_aux(idx.reshape(-1))
    kw = eng.fused_operands(aux)
    kernels = {"fused_pipeline": events_ms(
        lambda: kfused.fused_pipeline(flat, eng.spec, eng.fused_tables, **kw), iters=5)}
    host = {"fused_pipeline": host_us(
        lambda: kfused.fused_pipeline(flat, eng.spec, eng.fused_tables, **kw), calls=40)}
    f = kfused.fused_pipeline(flat, eng.spec, eng.fused_tables, **kw)
    off, seg = eng.glitch_offsets(aux), eng.consts["glitch_seg_index"]
    kernels["glitch_shear"] = events_ms(
        lambda: kglitch.shear_planar_inplace(f, eng._glitch_y0, off, seg), iters=5)
    kernels["glitch_offsets (native draws, one launch)"] = events_ms(
        lambda: eng.glitch_offsets(aux), iters=2)
    states = torch.zeros((CLIPS, 3, H4, W4), device="cuda")
    kernels["persistence_scan (multi-clip)"] = events_ms(
        lambda: kpersist.persistence_scan(f, None, False, eng.params.persistence, emit_u8=True,
                                          clip_states=states), iters=5)
    kernels["grain field (native draws, one launch; raw at grain size > 1)"] = events_ms(
        lambda: eng._grain_field(aux), iters=2)
    del f, states, kw
    return timing("c5", [CLIPS * B, 3, H4, W4], 2 * CLIPS * B, loop, kernels, host)


def profile(name: str, params: dict, xs) -> dict:
    import torch

    from pythoncrt_tpu_torch import CRTEngine, EffectParams, TextParams
    from pythoncrt_tpu_torch.kernels import bloom as kbloom
    from pythoncrt_tpu_torch.kernels import bloom2 as kbloom2
    from pythoncrt_tpu_torch.kernels import bloom3 as kbloom3
    from pythoncrt_tpu_torch.kernels import fused as kfused
    from pythoncrt_tpu_torch.kernels import glitch as kglitch
    from pythoncrt_tpu_torch.kernels import persist as kpersist
    from pythoncrt_tpu_torch.kernels import text as ktext
    from pythoncrt_tpu_torch.kernels import warp as kwarp

    p = EffectParams(**params, text=TextParams(**TEXT.get(name, {})))
    with optin_env(name):
        eng = CRTEngine(p, H, W, 24.0, layout="planar", channel_order="gbr", device="cuda",
                        text_rgba=synth_overlay() if p.text.enabled else None)

    def loop():
        st = None
        for k in range(0, N, B):
            _, st = eng.process(xs[k:k + B], np.arange(k, k + B), st)
        torch.cuda.synchronize()

    aux = eng.make_aux(np.arange(B))
    kw = eng.fused_operands(aux)
    x = xs[:B]
    kernels, host = {}, {}
    feed = x
    if eng._staged or not eng.spec.pre:
        kernels["pre-bloom (torch ops)"] = events_ms(lambda: eng._pre_bloom(x), iters=5)
        feed = eng._pre_bloom(x)
    if eng.bloom_route in ("stripe", "bloom2"):
        if eng.bloom_route == "stripe":
            kernels["bloom_stripe"] = events_ms(lambda: kbloom.bloom_planar(feed, eng.bloom_spec))
        else:
            kernels[f"bloom2_planar ({eng.bloom_spec.variant})"] = events_ms(
                lambda: kbloom2.bloom2_planar(feed, eng.bloom_spec, eng.bloom2_tables))
        kernels["post-bloom (torch ops, 1-D scanlines)"] = events_ms(
            lambda: kfused.epilogue_ref(feed, eng.spec, eng.fused_tables, **kw), iters=5)
        f = eng._staged_stages(x, aux)
    elif eng._staged:
        spec = eng.bloom3_spec
        tabs = eng.bloom3_tables
        if spec.fast:
            kernels["bloom3_fast_planar"] = events_ms(
                lambda: kbloom3.bloom3_fast_planar(feed, spec, tabs))
            bl = kbloom3.bloom3_fast_planar(feed, spec, tabs)
        else:
            kernels["bloom3_planar"] = events_ms(lambda: kbloom3.bloom3_planar(feed, spec))
            bl = kbloom3.bloom3_planar(feed, spec)
        kernels["post-bloom with the 2-D mask (torch ops)"] = events_ms(
            lambda: kfused.epilogue_ref(bl, eng.spec, eng.fused_tables, **kw), iters=5)
        kernels["2-D scanline mask alone (torch ops)"] = events_ms(
            lambda: eng._scanline_mask_2d(aux.phase), iters=5)
        f = kfused.epilogue_ref(bl, eng.spec, eng.fused_tables, **kw)
    else:
        kernels["fused_pipeline"] = events_ms(
            lambda: kfused.fused_pipeline(feed, eng.spec, eng.fused_tables, **kw))
        host["fused_pipeline"] = host_us(
            lambda: kfused.fused_pipeline(feed, eng.spec, eng.fused_tables, **kw))
        f = kfused.fused_pipeline(feed, eng.spec, eng.fused_tables, **kw)
    if eng._text_after:  # in place on f: its values stay in [0, 1]
        kernels[f"text_after ({eng.text_grid} grid)"] = events_ms(
            lambda: ktext.composite_after(f, eng._text_crops, eng.text_grid == "whole"))
    if p.warp_on:
        kernels["warp_planar"] = events_ms(
            lambda: kwarp.warp_planar(f, eng.warp_tables, emit_u8=eng._warp_u8))
    if eng._glitch:
        off = eng.glitch_offsets(aux)
        seg = eng.consts["glitch_seg_index"]
        kernels["glitch_shear"] = events_ms(
            lambda: kglitch.shear_planar_inplace(f, eng._glitch_y0, off, seg))
        kernels["glitch_offsets (native draws, one launch)"] = events_ms(
            lambda: eng.glitch_offsets(aux), iters=5)
    if p.persistence_on:
        state = torch.zeros((3, H, W), device="cuda")
        kernels["persistence_scan"] = events_ms(
            lambda: kpersist.persistence_scan(f, state, False, p.persistence, emit_u8=True))
    kernels["grain field (native draws, one launch; raw at grain size > 1)"] = events_ms(
        lambda: eng._grain_field(aux), iters=5)

    return timing(name, [B, 3, H, W], N, loop, kernels, host)


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="port_profile.json")
    ap.add_argument("--configs", default=",".join(CONFIGS))
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("port_profile: no CUDA device available", file=sys.stderr)
        return 2
    rng = np.random.default_rng(3)
    frames = rng.integers(0, 256, (N, 3, H, W), dtype=np.uint8)
    xs = torch.from_numpy(frames).cuda()
    results = []
    for name in a.configs.split(","):
        r = profile_c5(CONFIGS[name]) if name == "c5" else profile(name, CONFIGS[name], xs)
        print(json.dumps(r), flush=True)
        results.append(r)
    os.makedirs(os.path.dirname(a.out) or ".", exist_ok=True)
    with open(a.out, "w") as f:
        json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
