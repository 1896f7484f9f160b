"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Each tool on the card has one job:

- ``tests/test_torch_cuda.py`` (``python -m pytest --noconftest -m cuda``)
  holds every equality on the card, once: each kernel against its twin,
  the engine on the card against the engine on the CPU, and the sharded,
  multi-clip and stacked engines against the single engine.
- This script does what no test and no benchmark cell does: the card [1];
  the build and ptxas, no local memory [2]; the exhaustive sweeps (the
  triad's pow sites over every f32 of their domains, Box-Muller over all
  2^32 words) and the kernels table, each kernel alone against its plain
  twin and its library call with its bound [3]; the engine against the
  NumPy oracle at 1080p [4]; the renders through ``cli.main``,
  ``render_stream`` and ``process_video`` (segment and manifest resume,
  preview and GUI, sharded renders, launch counts, the CLI render's wall
  fps, pinned host bytes) [5]; the device time of the draws, the glitch
  and the text [6]; and it runs the card tests as a phase, failing when
  they fail [7].
- ``portbench/`` (``python3 -m portbench.run``) measures throughput, tail,
  idle share, per-layer readings and rooflines.

Phases (each must pass; any failure exits non-zero):

1. The card (nvidia-smi name and power limit), torch/CUDA/nvcc versions,
   and which codec backends (ffmpeg, cv2) the host has.
2. Build the CUDA kernels from pythoncrt_tpu_torch/csrc (one nvcc per
   source, all started together, sm_90a); ptxas's registers, stack frame
   and spill of each instantiation of the fused kernel (LUT-exact and
   direct-pow triad; full-size and raw grain), of the stand-alone blooms'
   row walk (csrc/bloom_walk.cu, its fast source too), of the warp
   (csrc/warp.cu) and of the native draws (csrc/rng.cu), none of which
   may use local memory; the raw-grain instantiations' plans (their raw
   stage, shared memory and blocks per SM at c3's pixel sizes 1-3 and for
   the CLI defaults at grain size 2, beside grain size 1).
3. Each kernel against its plain PyTorch twin on the card, at 1080p with
   a batch of 8 and the operands the main paths give it: the fused
   kernel with the c3 spec (gaussian core; grain size 2: the raw grain
   staged and upsampled in the kernel, also held bit for bit to the
   kernel at grain size 1 fed the twin's upsample, that two-step path and
   the grain-size-1 kernel alone on the upsampled field timed beside it),
   the CLI-default spec (fast core) and the CLI defaults at grain size 2
   (the fast core's raw grain, held and timed the same way), the warp (c3's strength and 1.0, the widest source
   footprints), the persistence scan (stream head and carried
   state) and the glitch shear (the c4 band, export and preview offsets,
   both entries); the native draws (csrc/rng.cu, one launch per batch and
   stream: the grain field at c4's and c3's sizes and at c5's 4K, the
   export glitch offsets at c4's band and c5's, the preview's at c4's),
   bit for bit their twin, with torch.randn of the same shape as the
   library yardstick (the kernels' device times in [6]); before them the Box-Muller fast path
   (csrc/box_muller.cuh) swept on the card by csrc/rng_sweep.cu (lines
   ``[3] rng sweep, ...``): the fast radius over all 2^32 words u and the
   fast cos and sin over all 2^32 words v against the FP64 expression,
   each deviation inside the bound the rounding test assumes, then 2^31
   pairs of grain words, no accepted value other than the FP64
   expression's, the fallback share printed; the stand-alone bloom (gaussian on the c3-angled
   pre-bloom image, fast on the defaults-angled one) and the fused
   kernel's f32-input mode (c4-text); the opt-in blooms on their paths'
   pre-bloom images (bloom2 gaussian on c3-bloom2, bloom2 fast on
   defaults-bloom2, bloom2's pipelined entry with limbs 3, 2 and 1, the
   stripe bloom on c3-stripe); at 3840x2160 on c5's flat batch of 4
   clips x 8 frames, the fused kernel (c4 spec, fast core; its twin
   clip by clip), the glitch shear in place and, on the effects' output,
   the persistence kernel's multi-clip mode; the text after the effects
   (csrc/text.cu) bit for bit composite_text on the grid the engine
   picks: the box grid on 16 of those frames with c5.batch's caption box
   (216, 486, 384, 1664), the whole-frame grid on c3-angled's warp emit
   at 1080p, each beside composite_text over the whole batch. Then every gaussian route at
   sigma 11 and 20 (radius 33 and 60, past the 63 taps of the launch
   arguments) at 1080p: the fused kernel (the CLI defaults with
   --no-fast-bloom), bloom3 (defaults-angled with the gaussian bloom),
   the stripe and bloom2 (c3's pre-bloom image), and the fused kernel's
   f32-input mode at sigma 11 (c4-text with --no-fast-bloom). Then the fused kernel's
   direct-pow triad (``--precision fast``, triad_mode 3) on the CLI
   defaults, c3, c4-text and sigma 11, each with the LUT-exact mode timed
   in turn on the same operands; its f32 and FP64 operations per value
   are counted by running its three pow sites (csrc/triad_pow.cuh: the
   f32 fast paths, the rounding tests, the FP64 fallbacks), compiled alone
   and instrumented at each basic block, on values over (0, 1], and the
   sites are swept over every f32 input of their domains (the log2 site
   over [0, 1], the exp2 site over [-1500, 0] and -inf, the forward site
   over [0, 1] at gamma 0.1, 1, 1.1, 2.2, 4 and 10): no value may differ
   from the FP64 expression; the fallback share per site, the largest
   distance of a fast value and the forward site's deltas from the twin's
   torch.pow in double are printed. Then the GUI preview's
   kernels at its shapes (one frame at 960x540, the preview engine with
   host rng, persistence zeroed, addressed by time): the fused kernel
   (the CLI defaults' fast core, c3's gaussian core, c4-text's f32
   input), the warp (c3), the glitch shear with the preview's offsets
   (c4) and bloom3 (c3-angled gaussian, defaults-angled fast).
   The row walk's rows (the fast bloom's too) and the warp's are bit for
   bit their twins.
   Max abs error, CUDA-event time per call of the kernel,
   of the twin and, where one PyTorch call computes the same function,
   of that call; the least time the card could take (the largest of the
   bytes over the memory rate and the f32 operations over the f32 rate,
   as portbench/yardstick.py bounds them, and the FP64 operations over
   the FP64 rate; the direct-pow rows count
   their pow sites' operations as measured; the draws' rows count a
   Philox call's and a Box-Muller pair's vector integer instructions in
   their SASS over the INT32 rate, the pair's FP64 instructions (the fast
   path's, and the fallback's at its measured share) over the FP64 rate
   and its 64-bit conversions over theirs, and say which of bytes, INT32
   and FP64 sets the bound).
4. The engine on the card (rng="host") against the NumPy oracle at 1080p:
   c3 and c3-angled on two frames; the CLI defaults, c4, defaults-angled
   and c4-text on four frames in two batches with the persistence state
   carried; the text paths with a seeded synthetic overlay; the bloom
   opt-ins c3-bloom2, c3-stripe (two frames) and defaults-bloom2 (four);
   c5 on 4 clips x 8 frames in two steps against the oracle clip by
   clip; the fused route (the CLI defaults with --no-fast-bloom) and the
   bloom3 route (defaults-angled with the gaussian bloom) at sigma 11 on
   two frames; the CLI defaults (four frames) and c3 (two) with
   ``precision="fast"``. <= 1 uint8 LSB, fewer than 1e-3 of values off
   (precision fast: the JAX package's max 16 LSB, mean 0.5 LSB). The 2-D scanline
   mask against the oracle's (its NumPy f32 sin and pow are not
   correctly rounded).
5. The main paths at 1080p with batch 8: the CLI defaults (no effect
   flags; 64 frames), c4, defaults-angled (scanline angle 12, thickness 2) and
   c4-text (text before the bloom) on 32 frames, c3 and c3-angled
   (angle 5, thickness 1.5, text after the warp) on 16, the bloom
   opt-ins c3-bloom2 (c3 + PCRT_BLOOM2_GAUSS=1) and c3-stripe (c3 +
   PCRT_PALLAS_BLOOM=1) on 16 and defaults-bloom2 (PCRT_BLOOM2_FAST=1)
   on 32, the variable set for that run only, the CLI defaults with
   ``--no-fast-bloom --bloom-sigma 11`` on 32 (the fused kernel at radius
   33), each through ``pythoncrt_tpu_torch.cli.main`` on a synthetic clip
   when a codec backend exists, else through ``render_stream`` with
   in-memory frames; and the CLI defaults with aberration 8 on 32
   frames 1080x8 (the roll mod W) through ``render_stream``; the CLI
   defaults with ``--precision fast``, ``--pipe-format yuv420p`` (the
   OpenCV tier without an ffmpeg binary) on 32 and ``--decode-workers 2
   --steps-per-call 2`` on 64 (two chunks of two super-batches, two
   workers; its encoder frames bit for bit the single reader's, the CLI
   defaults' render, which runs on 64: one super-batch at the auto 8
   steps per call). Then
   c4 with ``--segment-frames 16`` through ``process_video``: a straight
   render, a render that fails as injected once 24 frames were dispatched,
   and the same call again, which resumes at frame 16; the segments'
   encoder frames bit for bit the straight render's, the persistence and
   glitch kernels launched in both runs. ``--check-deps`` exits 0; the
   native yuv420p converter on a 1080p buffer against a NumPy BT.601
   reference, timed.
   Then c5: ``cli.main(["--batch-manifest", ...])`` with the c4 flags on
   4 synthetic 3840x2160 clips of 16, 16, 12 and 9 frames (needs cv2),
   every clip's frame count checked, then a second run that resumes all
   4 from the journal. Every kernel of a path must launch during that
   path's run (the counts are set to 0 just before it; c5 must launch
   the persistence kernel in its multi-clip mode); the native draws
   launch once per stream for each engine step (the CLI defaults, c3, c4
   and c4-text: per batch; c5: per step and clip device; the sharded
   paths below: per batch and shard). The text is
   rasterized by PIL when the host has it, else a seeded synthetic
   overlay takes its place (the line says which).
   Then the GUI slice: ``gui_qt.render_preview_frame`` (the window's
   preview call) on the card, 8 stateful ticks each of the CLI defaults,
   c3, c4, c3-angled, defaults-angled and c4-text from 1920x1080 frames
   (fitted to 960x540) and of c3 from 853x480 frames, each within 1 LSB
   of the ``PCRT_PREVIEW_ENGINE=0`` oracle path with the fraction of
   values off printed, and fewer than 1e-3 off on the ticks that blend
   no uint8 frame (every tick without persistence, the first with it),
   the preview kernels launched, ms per tick beside
   the oracle's, and the first-tick, cache-miss, cache-hit,
   persistence-slider and evicted-preset times; the window's export
   worker (``gui_qt.run_render_job``, c4) and ``compat.process_video``
   (the CLI defaults) each render 16 frames on the card; ``--gui``
   exits 3 where PySide6 is absent (the window itself is tested under a
   stub on the CPU). Then the multi-GPU slice (5b) on logical shards of
   cuda:0 (several mesh entries on one card; more cards when visible):
   ``ShardedCRTEngine`` on c4 (planar gbr) and the CLI defaults (NHWC)
   over 2, 4 and 8 shards and c3 over 4, two batches of 8 at 1080p with
   native rng, their launches counted, and with host rng against the
   oracle (1 LSB, fewer than 1e-3 off), with the carry rounds',
   corrections' and gather's ms per batch (CUDA events) beside the
   single-device step; c5's clips over 2 and 4 logical devices
   (``MultiClipEngine`` over a clip mesh), their launches counted;
   ``render_stream`` of 19 c4 frames at batch 8 through a 4-shard
   runner (the tail on the engine) within 1 LSB of the unsharded render;
   the same over the real cards when more than one is visible. Then the
   steps-per-call slice (5c): the CLI defaults, c4 and c3 through
   ``cli.main`` with ``--steps-per-call 2`` on 37 frames (two super-batches
   of 16 and a 5-frame tail), the defaults at the auto 8 on 72 (one of 64,
   then a batch), c4 through ``render_stream`` and a 4-shard runner at 2
   on 37, and c5 as a manifest at the auto 2 of four 3840x2160 clips of
   32, 32, 32 and 37 frames (two rounds of stacks, then the ragged clip
   alone), each path also at one step per call: the frames handed to the
   encoders bit for bit equal (c5 by SHA-1), the kernels' launch counts
   equal, and the engines' ``process_stack`` calls counted; the pinned
   host bytes of ``render_stream``'s pools at one step and at the auto 8
   (batch 8 and 16); the render fps, wall, of the defaults at both.
6. The draw kernels' device time (the kernels' durations in a
   torch.profiler trace, read by portbench/trace.py), each beside
   torch.randn of its shape in the same window and against its event time
   per wrapper call; the glitch shear's the same way at its four rows'
   shapes and offsets (c4's band in place and out of place, c5's, the
   preview's) on fresh frames, beside torch.gather of the same band and
   index; the text rows' the same way on fresh frames, beside
   composite_text over the whole batch.
7. The card tests: ``python -m pytest --noconftest -m cuda
   tests/test_torch_cuda.py -q`` in a process of its own, their summary
   line printed. Then the card's line, one JSON line with the kernel
   table, then the result line.

It imports nothing of JAX or of the JAX package. Without a CUDA device it
exits 2 and prints no result; without the port's package beside it (the
script alone in a directory) it exits 1 and prints no result. Its helpers
(``optin_env``, ``synth_overlay``, ``time_ms``, ``device_ms``) serve the
scripts under scripts/ too.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import hashlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

H, W, B, FPS = 1080, 1920, 8, 24.0
N_MAIN, N_C3 = 32, 16
# the CLI defaults (one super-batch at the auto 8 steps per call) and, with
# --decode-workers 2 --steps-per-call 2, two chunks of the parallel
# reader's super-batches of 16 (two per chunk under its 256 MB cap), so
# that both workers decode
N_DECODE = 64
# --steps-per-call: the CLI defaults, c4 and c3 at 2 over N_SPC frames (two
# super-batches of 16 and a ragged 5-frame tail); the defaults at auto (8)
# over N_SPC_AUTO (one super-batch of 64, then a batch); c5's manifest at
# auto (2 at 4K) on clips of at least two super-batches, the last ragged;
# c4 through a 4-shard runner at 2 over N_SPC
N_SPC, N_SPC_AUTO = 37, 72
C5_STACK_LENGTHS = (32, 32, 32, 37)
H4, W4, C5_CLIPS = 2160, 3840, 4   # c5: 4K clips in lockstep (bench.py:199-229)
C5_LENGTHS = (16, 16, 12, 9)       # the manifest render's clips, ragged tails
OPTINS = {"c3-bloom2": {"PCRT_BLOOM2_GAUSS": "1"}, "defaults-bloom2": {"PCRT_BLOOM2_FAST": "1"},
          "c3-stripe": {"PCRT_PALLAS_BLOOM": "1"}}  # the JAX engine's bloom opt-ins
# the HBM and f32 peaks are portbench/yardstick.py's (NVIDIA's data sheet)
F64_OPS_PER_S = 34e12      # H100 SXM FP64 outside the tensor cores (the same data sheet)
# H100 SXM INT32: 64 lanes per SM (Hopper architecture white paper), 132
# SMs, 1.98 GHz boost clock
INT32_OPS_PER_S = 64 * 132 * 1.98e9
# H100 SXM FP64 instructions outside the tensor cores: 64 lanes per SM (the
# same white paper; 34 TFLOP/s counts an FMA as two), and conversions to or
# from 64-bit types and MUFU's 64H functions at 16 per SM and clock (the
# CUDA C++ Programming Guide's throughput table, compute capability 9.0)
F64_INSTR_PER_S = 64 * 132 * 1.98e9
CONV64_PER_S = 16 * 132 * 1.98e9
# the native draws (csrc/rng.cu): a Philox4x32-10 call's integer
# instructions (philox_int_ops) and a Box-Muller pair's FP64, conversion and
# integer instructions (bm_sass_counts) are counted from the SASS of probes
# built with the kernels' flags; the rounding test's fallback share is
# measured by the sweep over BM_PAIR_GROUPS groups of Philox words
BM_PAIR_GROUPS = 1 << 30
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
# c5.batch's caption after the effects (portbench/traffic/manifest.json):
# a 270 x 1280 box at (216, 384) of the 3840x2160 frame
C5_TEXT = dict(text="CH 5", size=48, after=True)
C5_CAPTION = (216, 486, 384, 1664)
C4_TEXT_FLAGS = [*C4_FLAGS, "--text", "PLAY", "--text-size", "48"]
FUSED_TOL = 2e-6  # f32, same op order on both sides (-fmad=false)
# each kernel's source and the TPU kernel it replaces, for the kernels table
FUSED_CU = ("pythoncrt_tpu_torch/csrc/fused.cu", "pythoncrt_tpu/kernels/fused.py:680")
WARP_CU = ("pythoncrt_tpu_torch/csrc/warp.cu", "pythoncrt_tpu/kernels/warp.py:545")
PERSIST_CU = ("pythoncrt_tpu_torch/csrc/persist.cu", "pythoncrt_tpu/kernels/persist.py:113")
GLITCH_CU = ("pythoncrt_tpu_torch/csrc/glitch.cu", "pythoncrt_tpu/kernels/glitch.py:194")
WALK_CU = "pythoncrt_tpu_torch/csrc/bloom_walk.cu"
SIGMAS = {"s11": 11.0, "s20": 20.0}  # radius 33 and 60: past the launch arguments' 63 taps
S11_FLAGS = ["--no-fast-bloom", "--bloom-sigma", "11"]
AB_W = 8  # the aberration render's width: the aberration (8) is the whole width
LSB_TOL = 1
# --precision fast against the LUT-exact oracle: the JAX package's bounds
# (tests/test_engine_vs_oracle.py test_fast_precision_close_not_exact)
FAST_MAX_LSB, FAST_MEAN_LSB = 16, 0.5
# --segment-frames on c4: segments of 16 frames; the injected failure comes
# once 24 frames were dispatched (the first segment committed, the second
# half written)
SEG_FRAMES, SEG_CRASH = 16, 24
CAPTURE = ("defaults", "defaults-decode2")  # paths whose encoder frames are compared
PATH_KW = {"defaults-fast": dict(precision="fast"), "c3-fast": dict(precision="fast")}
# f32 operations per output value, estimated from the kernels' sources for
# the stages these specs turn on (rounded up; the FP64 grade pow of c3 is
# not counted). At these counts every kernel is bound by bytes. The
# direct-pow triad's rows (precision fast) take DIRECT_F32_LESS fewer: the
# tables' multiply, convert and two integer clamps at each of the two
# sites, less the f32 multiply of the final site; and add the f32 and FP64
# operations its three pow sites (csrc/triad_pow.cuh) were counted to run
# per value (pow_site_ops).
OPS_PER_VALUE = {"fused_pipeline": 40, "fused_pipeline_gaussian": 70, "warp_planar": 12,
                 "fused_pipeline_raw_grain": 40,
                 "warp_planar_strength1": 12,
                 "persistence_scan": 6, "glitch_shear": 0, "fused_pipeline_f32in": 40,
                 "fused_pipeline_text": 40,
                 "bloom3_planar": 45, "bloom3_fast_planar": 16, "bloom2_planar": 45,
                 "bloom2_planar_fast": 30, "bloom2_planar_pipelined": 45, "bloom_stripe": 45,
                 "persistence_scan_multiclip": 6, "glitch_shear_band": 0,
                 "fused_pipeline_c5": 40, "glitch_shear_c5": 0,
                 # the composite: a subtract, two multiplies, an add and the clip
                 "text_after_c5": 6, "text_after_c3_angled": 6,
                 # 2 x (2r + 1) multiply-adds and the composite
                 "fused_pipeline_s11": 300, "fused_pipeline_s20": 520,
                 "fused_pipeline_f32in_s11": 300,
                 "bloom3_planar_s11": 272, "bloom3_planar_s20": 490,
                 "bloom_stripe_s11": 272, "bloom_stripe_s20": 490,
                 "bloom2_planar_s11": 272, "bloom2_planar_s20": 490}
DIRECT_F32_LESS = 7
PR8_FP64_OPS = 149  # the direct-pow triad's FP64 chains per value before csrc/triad_pow.cuh
# the GUI's live preview: one frame per tick at the preview size of a
# 1920x1080 source (960x540), and of an 853x480 (FWVGA) source, which the
# fit leaves as it is (a 1280x720 source fits to 960x540 exactly); the
# preview engine's fps (gui_qt); 8 stateful ticks of a 24 fps source
PREVIEW_HW, PREVIEW_ODD, PREVIEW_FPS, N_TICKS = (540, 960), (480, 853), 30.0, 8
# its configurations (scripts/port_preview_profile.py reads them too):
# name -> (EffectParams kwargs, TextParams kwargs or None)
PREVIEW_CONFIGS = {"defaults": ({}, None), "c3": (C3, None), "c4": (C4, None),
                   "c3-angled": (C3_ANGLED, C3_ANGLED_TEXT),
                   "defaults-angled": (DEF_ANGLED, None), "c4-text": (C4, C4_TEXT)}
OPS_PER_VALUE.update({f"{k}_preview": OPS_PER_VALUE[k] for k in (
    "fused_pipeline", "fused_pipeline_gaussian", "fused_pipeline_text", "warp_planar",
    "bloom3_planar", "bloom3_fast_planar")}, glitch_shear_preview=0)


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


@contextlib.contextmanager
def optin_env(cfg: str):
    """The bloom opt-in variables of ``cfg`` set (and no other's) while
    its engines are built or its render runs."""
    names = {k for env in OPTINS.values() for k in env}
    saved = {k: os.environ.pop(k, None) for k in names}
    os.environ.update(OPTINS.get(cfg, {}))
    try:
        yield
    finally:
        for k in names:
            os.environ.pop(k, None)
            if saved[k] is not None:
                os.environ[k] = saved[k]


def synth_overlay(h: int, w: int, seed: int) -> np.ndarray:
    """(h, w, 4) uint8 RGBA: a seeded text-like box, clear elsewhere."""
    rng = np.random.default_rng(seed)
    ov = np.zeros((h, w, 4), np.uint8)
    y0, x0 = h // 10, w // 10
    ov[y0:y0 + h // 8, x0:x0 + w // 3] = rng.integers(
        0, 256, (h // 8, w // 3, 4), dtype=np.uint8)
    return ov


def time_ms(fn, iters: int = 10, repeats: int = 1) -> float:
    """CUDA-event ms per call of ``fn``, warmed up: ``iters`` calls back to
    back between two events, the median of ``repeats`` such runs."""
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
    return float(np.median(runs))


def device_ms(*runs, calls: int = 20) -> list:
    """Device ms per call of each ``(fn, kernel)`` of ``runs``, all in one
    torch.profiler window (portbench/trace.py ``profile``), ``calls`` calls
    of each: the durations of the kernels whose name holds ``kernel`` as a
    word (``Trace.kernels``), the host work left out; ``kernel`` None: the
    window's device operations that no other run's name matches. A window
    without one of them is taken again; raises RuntimeError after three."""
    import torch

    from portbench import trace as ptrace

    for fn, _ in runs:
        fn()
    torch.cuda.synchronize()

    def stretch():
        for fn, _ in runs:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        return calls * len(runs), 0

    named = [k for _, k in runs if k]
    for _ in range(3):
        tr = ptrace.profile(stretch)
        ms = []
        for _, k in runs:
            ops = tr.kernels(k) if k else [d for d in tr.device if not any(
                re.search(rf"\b{re.escape(n)}\b", d[0]) for n in named)]
            ms.append(sum(d[3] for d in ops) / 1e3 / calls)
        if all(ms):
            return ms
    raise RuntimeError(f"torch.profiler recorded no device time for one of {named or 'the calls'} "
                       f"in three windows")


def nbytes(*ts) -> int:
    return sum(int(t.numel() * t.element_size()) for t in ts if t is not None)


def as_tuple(x) -> tuple:
    """A kernel's output (a tensor, or a tuple of them) as a tuple."""
    return tuple(x) if isinstance(x, (tuple, list)) else (x,)


def bound(name: str, bytes_moved: int, values_out: int, f64_per_value: float = 0,
          f32_sites: float = 0) -> tuple:
    """Least time for the work: the yardstick's (portbench/yardstick.py
    bound_s: bytes, each input read once and each output written once,
    over the memory rate, or the f32 operations over the f32 rate), or the
    FP64 operations (the direct-pow triad's fallback) over the FP64 rate,
    whichever is largest: the card runs the three side by side.
    ``f32_sites``: the direct-pow triad's pow sites' f32 operations per
    value, counted."""
    from portbench.yardstick import HBM_BYTES_PER_S, bound_s

    direct = name.endswith("_direct")
    f32_ops = (OPS_PER_VALUE[name.removesuffix("_direct")]
               - (DIRECT_F32_LESS if direct else 0) + f32_sites)
    t = max(bound_s(bytes_moved, f32_ops * values_out), f64_per_value * values_out / F64_OPS_PER_S)
    return t * 1e3, "bytes" if bytes_moved / HBM_BYTES_PER_S >= t else "operations"


# the direct-pow triad's three pow sites as csrc/fused.cu calls them
# (csrc/triad_pow.cuh: the f32 fast paths, the rounding tests and the FP64
# fallbacks), compiled alone with the kernels' flags to count their
# operations per value
DIRECT_TRIAD_CU = r"""
#include "triad_pow.cuh"
__device__ unsigned long long f64_count, f32_count;
extern "C" __global__ void triad_sites(const float* x, float* y, float g, float e, int n) {
    const int i = 3 * (blockIdx.x * blockDim.x + threadIdx.x);  // a pixel's three planes
    if (i + 2 >= n) return;
    const float v[3] = {x[i], x[i + 1], x[i + 2]};
    float lin[3], out[3];
    triad::pow_fwd3(triad::kTab, v, g, lin);
    triad::pow_final3(triad::kTab, lin, e, out);
    for (int p = 0; p < 3; ++p) y[i + p] = out[p];
}
"""
OPS_PTX = {"f64": re.compile(r"^\s*(@!?%p\d+\s+)?(fma|add|sub|mul)(\.r[nzmp])?\.f64\b"),
           "f32": re.compile(r"^\s*(@!?%p\d+\s+)?(fma|add|sub|mul)(\.r[nzmp])?(\.ftz)?(\.sat)?"
                             r"\.f32\b")}
OPS_SASS = {"f64": re.compile(r"\b(DFMA|DADD|DMUL)\b"), "f32": re.compile(r"\b(FFMA|FADD|FMUL)\b")}


def direct_triad_build(nvcc: str, flags: tuple, d: str) -> tuple:
    """The sites' SASS, and their PTX with counts of FP64 and f32 operations
    (FMA as two) added to ``f64_count`` and ``f32_count`` where each basic
    block of each function (the kernel and the out-of-line fallbacks)
    starts and before each predicated operation, built into a cubin."""
    src, ptx = os.path.join(d, "t.cu"), os.path.join(d, "t.ptx")
    with open(src, "w") as f:
        f.write(DIRECT_TRIAD_CU)
    inc = ("-I", str(_build_csrc()))
    subprocess.run([nvcc, *flags, *inc, "-cubin", "-o", os.path.join(d, "t.cubin"), src],
                   check=True, capture_output=True, timeout=300)
    sass = subprocess.run([os.path.join(os.path.dirname(nvcc), "cuobjdump"), "-sass",
                           os.path.join(d, "t.cubin")],
                          check=True, capture_output=True, text=True, timeout=120).stdout
    subprocess.run([nvcc, *flags, *inc, "-ptx", "-o", ptx, src], check=True, capture_output=True,
                   timeout=300)
    lines = open(ptx).read().splitlines()

    def add(kind: str, n: int, pred: str = "") -> str:
        return (f"{{ .reg .u64 %opsn; mov.u64 %opsn, {n}; "
                f"{pred}red.global.add.u64 [{kind}_count], %opsn; }}")

    def weight(m) -> int:
        return 2 if m.group(2) == "fma" else 1

    out, static, i = [], dict(f64=0, f32=0), 0
    while i < len(lines):  # copy up to each function body's "{", then rewrite the body
        out.append(lines[i])
        if lines[i] != "{":
            i += 1
            continue
        end = next(k for k in range(i + 1, len(lines)) if lines[k] == "}")
        body = lines[i + 1:end]
        label = [bool(re.match(r"^\$\w+:", ln.strip())) for ln in body]
        first = next(k for k, ln in enumerate(body)
                     if ln.strip() and not ln.strip().startswith((".", "//")))
        out += body[:first]
        # a block starts at the first instruction, at a label and after a branch
        starts = sorted({first} | {k for k in range(first, len(body)) if label[k]}
                        | {k + 1 for k in range(first, len(body) - 1)
                           if re.search(r"\b(bra(\.uni)?|ret|exit)\b", body[k])
                           and not label[k + 1]})
        for j, st in enumerate(starts):
            block = body[st:starts[j + 1] if j + 1 < len(starts) else len(body)]
            head = [block.pop(0)] if label[st] else []
            out += head
            for kind, rx in OPS_PTX.items():
                ops = [m for m in map(rx.match, block) if m]
                static[kind] += sum(weight(m) for m in ops)
                n = sum(weight(m) for m in ops if not m.group(1))
                if n:
                    out.append(add(kind, n))
            for ln in block:
                for kind, rx in OPS_PTX.items():
                    m = rx.match(ln)
                    if m and m.group(1):
                        out.append(add(kind, weight(m), m.group(1)))
                out.append(ln)
        out.append("}")
        i = end + 1
    with open(ptx, "w") as f:
        f.write("\n".join(out) + "\n")
    cubin = os.path.join(d, "counted.cubin")
    subprocess.run([nvcc, *flags, "-cubin", "-o", cubin, ptx], check=True, capture_output=True,
                   timeout=300)
    sass_ops = {k: sum(2 if op.endswith("FMA") else 1 for op in rx.findall(sass))
                for k, rx in OPS_SASS.items()}
    return sass_ops, static, open(cubin, "rb").read()


PHILOX_PROBE_CU = r"""
#include "rng.cu"
// a Philox4x32-10 call as the draw kernels make it (the counter from the
// thread, the stream and the frame; the key from the launch arguments),
// and the same kernel storing the counter words without it
extern "C" __global__ void philox_probe(const __grid_constant__ RngArgs a, uint4* out) {
    const uint32_t g = blockIdx.x * blockDim.x + threadIdx.x;
    const Words w = draw(a, g, (uint64_t)__ldg(a.frames + blockIdx.y));
    out[blockIdx.y * gridDim.x * blockDim.x + g] = make_uint4(w.x, w.y, w.z, w.w);
}
extern "C" __global__ void counter_probe(const __grid_constant__ RngArgs a, uint4* out) {
    const uint32_t g = blockIdx.x * blockDim.x + threadIdx.x;
    const uint64_t f = (uint64_t)__ldg(a.frames + blockIdx.y);
    out[blockIdx.y * gridDim.x * blockDim.x + g] = make_uint4(g, a.stream, (uint32_t)f,
                                                              (uint32_t)(f >> 32));
}
"""
# per-thread (vector) integer instructions in cuobjdump's SASS; the uniform
# datapath's (UIADD3, ULOP3, ...) serve a whole warp and are left out
INT_SASS = re.compile(r"^\s*/\*[0-9a-fA-F]+\*/\s+(?:@!?U?P\w+\s+)?"
                      r"(IMAD|IADD3|LOP3|SHF|LEA|ISETP|IMNMX|SEL|PRMT|IABS|IMUL|BMSK|SGXT)\b")


def philox_int_ops(nvcc: str, flags: tuple) -> tuple:
    """Vector integer instructions of one Philox4x32-10 call as built with
    the kernels' flags: the SASS of a kernel that makes one call
    (csrc/rng.cu's ``draw``) less that of the same kernel storing the
    counter words, each instruction counted once (a three-input LOP3 XOR
    as one, an IMAD.WIDE as one). Returns (count, the call's instructions
    by mnemonic)."""
    with tempfile.TemporaryDirectory() as d:
        src, cubin = os.path.join(d, "p.cu"), os.path.join(d, "p.cubin")
        with open(src, "w") as f:
            f.write(PHILOX_PROBE_CU)
        subprocess.run([nvcc, *flags, "-I", str(_build_csrc()), "-cubin", "-o", cubin, src],
                       check=True, capture_output=True, timeout=300)
        sass = subprocess.run([os.path.join(os.path.dirname(nvcc), "cuobjdump"), "-sass", cubin],
                              check=True, capture_output=True, text=True, timeout=120).stdout
    ops, fn = {"philox_probe": {}, "counter_probe": {}}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            fn = m.group(1) if m.group(1) in ops else None
            continue
        m = INT_SASS.match(line)
        if fn and m:
            op = line.split("*/", 1)[1].split()
            op = op[1] if op[0].startswith("@") else op[0]
            ops[fn][op] = ops[fn].get(op, 0) + 1
    if not ops["philox_probe"] or not ops["counter_probe"]:
        fail(f"the Philox probe's SASS has no integer instructions: {ops}")
    diff = {k: ops["philox_probe"].get(k, 0) - ops["counter_probe"].get(k, 0)
            for k in ops["philox_probe"].keys() | ops["counter_probe"].keys()}
    n = sum(diff.values())
    if n <= 0:
        fail(f"the Philox call counted {n} integer instructions: {ops}")
    return n, {k: v for k, v in sorted(diff.items()) if v}


BM_PROBE_CU = r"""
#include "box_muller.cuh"
// one Box-Muller pair from a pair of words: the fast path alone (the
// rounding test's verdict stored), the FP64 expression (the stream's
// definition and the fallback), and the same kernel storing the words
#define PROBE(name, body) \
    extern "C" __global__ void name(const uint2* in, float2* out, int* ok) { \
        __shared__ bm::Tabs t; \
        bm::load_tabs(t); \
        __syncthreads(); \
        const int i = blockIdx.x * blockDim.x + threadIdx.x; \
        const uint2 w = in[i]; \
        float z0, z1; \
        body \
        out[i] = make_float2(z0, z1); \
    }
PROBE(bm_fast_probe, ok[i] = bm::fast_pair(t.ang, t.lg, w.x, w.y, z0, z1);)
PROBE(bm_fp64_probe, const float2 e = bm::box_muller_fp64(w.x, w.y); z0 = e.x; z1 = e.y;
      ok[i] = (w.x ^ w.y) & 1;)
PROBE(bm_base_probe, z0 = __uint_as_float(w.x); z1 = __uint_as_float(w.y); ok[i] = (w.x ^ w.y) & 1;)
"""
# FP64 arithmetic, conversions to or from 64-bit floats, and MUFU's 64H
# functions in cuobjdump's SASS
F64_SASS = {"fp64": re.compile(r"^(DFMA|DADD|DMUL|DSETP|DMNMX|DSET)\b"),
            "conv64": re.compile(r"^(F2F|I2F|F2I)\.\S*F64"),
            "mufu64": re.compile(r"^MUFU\.\w+64H")}


def bm_sass_counts(nvcc: str, flags: tuple) -> dict:
    """Per probe of BM_PROBE_CU built with the kernels' flags: FP64
    arithmetic, 64-bit conversions, MUFU 64H and vector integer
    instructions in the kernel's body ("body": before the first address it
    calls, where the subroutines sit: libdevice's reduction of large
    arguments and its slow paths, which the draws never take) and in all
    its code ("all"). The integer counts are the probe's less the
    word-storing probe's."""
    with tempfile.TemporaryDirectory() as d:
        src, cubin = os.path.join(d, "b.cu"), os.path.join(d, "b.cubin")
        with open(src, "w") as f:
            f.write(BM_PROBE_CU)
        subprocess.run([nvcc, *flags, "-I", str(_build_csrc()), "-cubin", "-o", cubin, src],
                       check=True, capture_output=True, timeout=300)
        sass = subprocess.run([os.path.join(os.path.dirname(nvcc), "cuobjdump"), "-sass", cubin],
                              check=True, capture_output=True, text=True, timeout=120).stdout
    probes = ("bm_fast_probe", "bm_fp64_probe", "bm_base_probe")
    code, fn = {p: [] for p in probes}, None  # per probe: (address, instruction), "$" labels
    for line in sass.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            fn = m.group(1) if m.group(1) in code else None
            continue
        lab = re.match(r"^\s*(\$[\w.$]*):\s*$", line)  # a subroutine's label, where printed
        m = re.match(r"^\s*/\*([0-9a-fA-F]+)\*/\s+(.*?)\s*;", line)
        if fn and lab:
            code[fn].append((None, None))
        elif fn and m:
            op = m.group(2).split()
            code[fn].append((int(m.group(1), 16), " ".join(op[1:] if op[0].startswith("@") else op)))
    if not all(code.values()):
        fail(f"the Box-Muller probes' SASS lacks a function: "
             f"{sorted(k for k, v in code.items() if not v)}")
    out = {}
    for p, ins in code.items():
        calls = [int(t, 16) for _, o in ins if o for t in re.findall(r"^CALL\S*\s+(0x[0-9a-fA-F]+)", o)]
        first_sub = next((i for i, (at, _) in enumerate(ins)
                          if at is None or (calls and at >= min(calls))), len(ins))
        out[p] = {}
        for which, part in (("body", ins[:first_sub]), ("all", ins)):
            ops = [o for _, o in part if o]
            c = {k: sum(bool(rx.match(o)) for o in ops) for k, rx in F64_SASS.items()}
            c["int"] = sum(bool(INT_SASS.match("/*0*/ " + o)) for o in ops)
            out[p][which] = c
    for p in probes[:2]:
        for which in out[p]:
            out[p][which]["int"] -= out["bm_base_probe"][which]["int"]
    if out["bm_fast_probe"]["body"]["fp64"] <= 0 or out["bm_fp64_probe"]["body"]["fp64"] <= 0:
        fail(f"the Box-Muller probes counted no FP64 instructions: {out}")
    return out


def _build_csrc():
    from pythoncrt_tpu_torch.kernels import _build

    return _build.CSRC


def pow_site_ops(nvcc: str, flags: tuple, gammas, n: int = 3 << 15) -> dict:
    """FP64 and f32 operations per value that the direct-pow triad's three
    pow sites execute on the card, for each triad gamma: the mean over
    ``n`` values evenly spread over (0, 1] (the clipped values the kernel
    feeds them), three to a thread as the kernel's pixels give them,
    counted by the instrumented sites. Also the counts of
    every path in their SASS and in their PTX (the fallbacks too), which
    the run's values do not all take."""
    import ctypes

    import torch

    cu = ctypes.CDLL("libcuda.so.1")
    with tempfile.TemporaryDirectory() as d:
        sass_ops, ptx_ops, image = direct_triad_build(nvcc, flags, d)
    ctx, mod, fn = ctypes.c_void_p(), ctypes.c_void_p(), ctypes.c_void_p()
    ptrs = {k: ctypes.c_uint64() for k in OPS_PTX}
    size = ctypes.c_size_t()

    def check(rc, what):
        if rc != 0:
            fail(f"the operation count's {what} returned CUDA driver error {rc}")

    dev = ctypes.c_int()
    torch.cuda.init()
    check(cu.cuDeviceGet(ctypes.byref(dev), torch.cuda.current_device()), "device")
    check(cu.cuDevicePrimaryCtxRetain(ctypes.byref(ctx), dev), "context")
    check(cu.cuCtxPushCurrent_v2(ctx), "context push")
    try:
        check(cu.cuModuleLoadData(ctypes.byref(mod), image), "module load")
        check(cu.cuModuleGetFunction(ctypes.byref(fn), mod, b"triad_sites"), "function")
        for k, ptr in ptrs.items():
            check(cu.cuModuleGetGlobal_v2(ctypes.byref(ptr), ctypes.byref(size), mod,
                                          f"{k}_count".encode()), "counter")
        x = torch.arange(1, n + 1, device="cuda", dtype=torch.float64).div(n).float()
        y = torch.empty_like(x)
        torch.cuda.synchronize()
        per_value = {k: {} for k in OPS_PTX}
        for g in gammas:
            for ptr in ptrs.values():
                check(cu.cuMemsetD8_v2(ptr, ctypes.c_ubyte(0), ctypes.c_size_t(8)),
                      "counter reset")
            args = [ctypes.c_uint64(x.data_ptr()), ctypes.c_uint64(y.data_ptr()),
                    ctypes.c_float(g), ctypes.c_float(1.0 / g), ctypes.c_int(n)]
            params = (ctypes.c_void_p * len(args))(*[ctypes.addressof(v) for v in args])
            check(cu.cuLaunchKernel(fn, (n // 3 + 255) // 256, 1, 1, 256, 1, 1, 0, None, params,
                                    None), "launch")
            check(cu.cuCtxSynchronize(), "run")
            for k, ptr in ptrs.items():
                count = ctypes.c_uint64()
                check(cu.cuMemcpyDtoH_v2(ctypes.byref(count), ptr, ctypes.c_size_t(8)),
                      "counter read")
                per_value[k][float(g)] = count.value / n
        check(cu.cuModuleUnload(mod), "module unload")
    finally:
        cu.cuCtxPopCurrent_v2(ctypes.byref(ctypes.c_void_p()))
        cu.cuDevicePrimaryCtxRelease_v2(dev)
    return dict(per_value=per_value, sass_all_paths=sass_ops, ptx_all_paths=ptx_ops)


def triad_sweep_phase(dev, gammas) -> None:
    """Every f32 input of each pow site's domain through csrc/triad_pow.cuh
    on the card (kernels/triad.py sweep, 2^26 inputs a launch): the log2
    site over [0, 1], the exp2 site over [-1500, 0] and -inf, the forward
    site over [0, 1] at each gamma. Fails on any value that is not the FP64
    expression's, printing the first inputs. Prints the fallback share over
    the whole domain and over the pixel range (x in [2^-8, 1]; the exp2
    argument in [-8, 0]), the exact answers and the largest relative
    distance from a fast value to the FP64 expression; for the forward site
    also the values that differ from the twin's torch.pow in double (a twin
    delta, not a fault: the twin is not the kernel's FP64 expression)."""
    import torch

    from pythoncrt_tpu_torch.kernels import triad

    chunk = 1 << 26
    buf = torch.empty(chunk, dtype=torch.float32, device=dev)
    pixel = {"forward": (0x3B800000, 0x3F800001), "log2": (0x3B800000, 0x3F800001),
             "exp2": (0x80000000, 0xC1000001)}  # [2^-8, 1]; [-8, 0]
    t0 = time.perf_counter()
    for site in triad.SITES:
        for g in (gammas if site == "forward" else (1.0,)):
            start, count = triad.DOMAINS[site]
            tot = dict(n=0, mismatches=0, fallbacks=0, exact=0, max_distance=0.0)
            first, twin, twin_first = None, 0, None
            for off in range(0, count, chunk):
                n = min(chunk, count - off)
                r = triad.sweep(site, g, start=start + off, count=n, device=dev,
                                out=buf[:n] if site == "forward" else None)
                if r["first"] is not None and first is None:
                    first = start + off + r["first"]
                for k in tot:
                    tot[k] = max(tot[k], r[k]) if k == "max_distance" else tot[k] + r[k]
                if site == "forward":
                    xs = torch.arange(start + off, start + off + n, device=dev,
                                      dtype=torch.int32).view(torch.float32)
                    want = torch.pow(xs.double(), float(np.float32(g))).float()
                    diff = want.view(torch.int32) != buf[:n].view(torch.int32)
                    nd = int(diff.sum().item())
                    if nd and twin_first is None:
                        i = int(diff.nonzero()[0].item())
                        twin_first = (float(xs[i].item()), float(buf[i].item()),
                                      float(want[i].item()))
                    twin += nd
                    del xs, want, diff
            if site == "exp2":
                r = triad.sweep(site, xs=torch.tensor(triad.EXP2_EXTRA, dtype=torch.float32,
                                                      device=dev))
                for k in ("n", "mismatches", "fallbacks", "exact"):
                    tot[k] += r[k]
            lo, hi = pixel[site]
            px = triad.sweep(site, g, start=lo, count=hi - lo, device=dev)
            name = f"{site} site" + (f" at gamma {g:g}" if site == "forward" else "")
            extra = (f"; against the twin's torch.pow in double: {twin} values differ"
                     + (f" (first: x {twin_first[0]!r}, kernel {twin_first[1]!r}, twin "
                        f"{twin_first[2]!r})" if twin_first else "")
                     if site == "forward" else "")
            print(f"[3] triad sweep, {name}: {tot['n']} inputs, {tot['mismatches']} differ from "
                  f"the FP64 expression; fallback share {tot['fallbacks'] / tot['n']:.4e} of the "
                  f"domain, {px['fallbacks'] / px['n']:.4e} of the pixel range ({px['n']} "
                  f"inputs); exact answers {tot['exact']}; largest distance of a fast value "
                  f"{tot['max_distance']:.3e} (2^{np.log2(max(tot['max_distance'], 1e-300)):.2f})"
                  f"{extra}", flush=True)
            if tot["mismatches"]:
                x0 = np.array([first & 0xFFFFFFFF], np.uint32).view(np.float32)[0]
                fail(f"triad sweep, {name}: {tot['mismatches']} values differ from the FP64 "
                     f"expression, the first at input {x0!r} (bits {first:#010x})")
    del buf
    print(f"[3] triad sweep: {time.perf_counter() - t0:.1f}s", flush=True)


def rng_sweep_phase(dev) -> float:
    """The draws' Box-Muller fast path (csrc/box_muller.cuh) against the
    FP64 expression on the card (csrc/rng_sweep.cu, kernels/rng.py sweep):
    the fast radius over all 2^32 u, the fast cos and sin over all 2^32 v,
    each against the bound the rounding test assumes (fails on any word
    where the bound does not cover the deviation), then the whole pair on
    the Philox words of BM_PAIR_GROUPS grain groups (fails on any accepted
    value that is not the FP64 expression's). Prints the maxima, the
    bounds and the fallback share; returns the share."""
    from pythoncrt_tpu_torch.kernels import rng as krng

    t0 = time.perf_counter()
    res = {m: krng.sweep(m, count=BM_PAIR_GROUPS if m == "pairs" else 1 << 32, device=dev)
           for m in krng.SWEEP_MODES}
    secs = time.perf_counter() - t0
    lg = lambda x: f"{x:.3e} (2^{np.log2(max(x, 1e-300)):.2f})"  # noqa: E731
    rad, ang, pairs = res["radius"], res["angle"], res["pairs"]
    print(f"[3] rng sweep, radius: {rad['n']} words u; {rad['over']} reach the bound "
          f"{lg(krng.BM_RAD_REL)} (relative); largest deviation from sqrt(-2 log u1) "
          f"{lg(rad['max_dev'][0])}, margin {krng.BM_RAD_REL / max(rad['max_dev'][0], 1e-300):.1f}x; "
          f"{rad['fallbacks']} word left to the fallback (u = 2^32 - 1)", flush=True)
    print(f"[3] rng sweep, angle: {ang['n']} words v; {ang['over']} reach the bound "
          f"{lg(krng.BM_ANG_ABS)} (absolute); largest deviation from cos(TWO_PI u2) "
          f"{lg(ang['max_dev'][0])}, from sin {lg(ang['max_dev'][1])}, margin "
          f"{krng.BM_ANG_ABS / max(max(ang['max_dev']), 1e-300):.1f}x", flush=True)
    share = pairs["fallbacks"] / (2 * pairs["n"])
    print(f"[3] rng sweep, pairs: {2 * pairs['n']} pairs of the grain stream's words (seed 0, "
          f"frame 0, groups 0-{pairs['n'] - 1}); {pairs['fallbacks']} take the FP64 fallback "
          f"(share {share:.3e}); {pairs['over']} groups with an accepted value other than the "
          f"FP64 expression's; {secs:.2f}s", flush=True)
    for m, r in res.items():
        if r["over"]:
            fail(f"rng sweep, {m}: {r['over']} words over the bound the rounding test assumes, "
                 f"the first at word {r['first']}")
    return share


def ptxas_instances(log: str, match, what: str, count: int) -> list:
    """ptxas's lines for each kernel entry that ``match`` names (it returns
    the entry's identity as a dict, or None): registers, stack frame,
    spill and static shared memory bytes. Fails unless ``count`` entries
    were found, each with its lines."""
    out, cur = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            cur = match(line)
            if cur is not None:
                cur.update(registers=None, stack=None, spill_stores=None, spill_loads=None,
                           static_smem=0)
                out.append(cur)
        elif cur is not None:
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                          r"(\d+) bytes spill loads", line)
            if m and cur["stack"] is None:  # the entry's own, not a callee's
                cur["stack"], cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
            m = re.search(r"Used (\d+) registers", line)
            if m:
                cur["registers"] = int(m.group(1))
                m = re.search(r"(\d+) bytes smem", line)
                cur["static_smem"] = int(m.group(1)) if m else 0
    if len(out) != count or any(i["registers"] is None or i["stack"] is None for i in out):
        fail(f"ptxas reported {len(out)} {what}, expected {count}: {out}")
    return out


def fused_instances(log: str) -> list:
    """Each instantiation of csrc/fused.cu's template (core, radius, input,
    triad, grain, text)."""
    def match(line):
        if "fused_strip_kernel" not in line:
            return None
        core, radius, f32, direct, graw, text = re.search(
            r"ILi(\d)ELi(n?\d+)ELb(\d)ELb(\d)ELb(\d)ELb(\d)E", line).groups()
        return dict(core="fast" if core == "1" else "gaussian",
                    radius={"n1": "runtime", "n2": "runtime above 31 (taps in shared "
                            "memory)"}.get(radius) or int(radius),
                    input="f32" if f32 == "1" else "uint8",
                    triad="direct pow (precision fast)" if direct == "1" else "LUT-exact",
                    grain="raw, staged and upsampled here" if graw == "1" else "full-size",
                    text="composited in the prologue" if text == "1" else "none")
    return ptxas_instances(log, match, "fused instantiations", 48)


def f32_input(eng):
    """The fused kernel's f32-input mode (pre=False) for an engine's spec,
    fed ``eng._pre_bloom``'s image (stages 1-5, the text composited by
    torch ops): its spec and consts. The engine's step composites the text
    in the kernel's prologue instead."""
    from pythoncrt_tpu_torch.kernels import fused as kfused

    spec = dataclasses.replace(eng.spec, pre=False, text_box=())
    t = eng.fused_tables
    return spec, kfused.fused_consts(spec, eng.device, t.y_map, t.x_maps)


def rng_instances(log: str) -> list:
    """Each kernel of csrc/rng.cu (the grain, export and preview entries)."""
    def match(line):
        m = re.search(r"\d(grain|export|preview)_kernel", line)
        return dict(kernel=m.group(0)[1:]) if m else None
    return ptxas_instances(log, match, "draw kernels", 3)


WALK_SOURCES = {"0": "fold (bloom3)", "1": "clamp (stripe)", "2": "table (bloom2)"}


def walk_instances(log: str) -> list:
    """Each instance of csrc/bloom_walk.cu: the row walk per weight source
    and band, the scratch route's two passes, the fast source's kernel."""
    def match(line):
        if "bloom_fast_walk_kernel" in line:
            return dict(kernel="bloom_fast_walk_kernel", source="fast (bloom3)", band=None)
        m = re.search(r"(bloom_walk|bloom_hpass|bloom_vpass)_kernelILi(\d)E(?:Li(n?\d+)E)?",
                      line)
        if not m:
            return None
        kind, src, band = m.groups()
        return dict(kernel=f"{kind}_kernel", source=WALK_SOURCES[src],
                    band=None if band is None else
                    ("runtime" if band.startswith("n") else f"-{band}..{band}"))
    return ptxas_instances(log, match, "row-walk instances", 14)


def warp_instances(log: str) -> list:
    """Each instance of csrc/warp.cu (one per emit)."""
    def match(line):
        m = re.search(r"warp_kernelILb(\d)E", line)
        return dict(emit="uint8" if m.group(1) == "1" else "f32") if m else None
    return ptxas_instances(log, match, "warp instances", 2)


def fast_note(plan) -> str:
    """The fast source's walk for a plane (kernels/bloom_walk.py fast_plan)."""
    return (f"; the row walk's fast source: strips of {plan.sw} columns, runs of {plan.run} rows, "
            f"chunks of {plan.step} rows, rings {plan.depth} staged + {plan.xdepth} pre-knee + "
            f"{plan.hdepth} half-res rows, {plan.smem} bytes of shared memory per block")


def walk_note(h: int, w: int, src: int, bands: tuple) -> str:
    """The row walk's plan for a plane (kernels/bloom_walk.py walk_plan)."""
    from pythoncrt_tpu_torch.kernels import bloom_walk as kwalk

    p = kwalk.walk_plan(src, h, w, *bands)
    if p.scratch:
        return "; the scratch route (two passes through a device buffer)"
    return (f"; strips of {p.sw} columns, runs of {p.run} rows, chunks of {p.step} rows, rings "
            f"{p.depth} + {p.xdepth} rows, {p.smem} bytes of shared memory per block")


def plan_note(tables) -> str:
    """The fused kernel's walk for a spec (kernels/fused.py fused_plan)."""
    p = tables.plan
    return (f"; strips of {p.sw} columns, runs of {p.run} rows, chunks of {p.step} distinct "
            f"rows, ring {p.depth}{f' + {p.hdepth} half-res' if p.fast else ''} rows, "
            f"{p.smem} bytes of shared memory per block")


def graw_plans(n_inst: int) -> None:
    """[2]: the raw-grain instantiations' dynamic shared memory, which their
    plans size (kernels/fused.py fused_plan, on the host): the raw stage
    and the blocks per SM it leaves, for c3's gaussian core at pixel sizes
    1-3 and the CLI defaults' fast core at grain size 2, beside the same
    plan at grain size 1."""
    from pythoncrt_tpu_torch import CRTEngine, EffectParams
    from pythoncrt_tpu_torch.kernels import fused as kfused

    print(f"[2] the {n_inst} raw-grain instantiations' shared memory is their plans' (host):")
    for name, kw in (("c3", dict(C3, pixel_size=1)), ("c3", C3), ("c3", dict(C3, pixel_size=3)),
                     ("defaults --grain-size 2", dict(grain_size=2, pixel_size=1)),
                     ("defaults --grain-size 2", dict(grain_size=2))):
        p, flat = (CRTEngine(EffectParams(**{**kw, "grain_size": g}), H, W, FPS, rng="host",
                             device="cpu").fused_tables.plan for g in (kw["grain_size"], 1))
        print(f"[2] raw-grain plan, {name} at pixel size {kw.get('pixel_size', 2)}: "
              f"{p.smem} bytes of shared memory "
              f"per block ({kfused.blocks_per_sm(p.smem)} per SM), chunks of {p.step} distinct "
              f"rows, the raw stage {p.gdepth} rows of {p.gpitch} floats and {p.grows} rows' taps "
              f"per buffer, two buffers, {p.sw} column taps and the run's schedule; at grain "
              f"size 1 {flat.smem} bytes ({kfused.blocks_per_sm(flat.smem)} per SM), chunks of "
              f"{flat.step}")


@contextlib.contextmanager
def capture_writers(vio, on: bool = True, digest: bool = False):
    """The frames handed to every writer the port opens, per destination
    (a destination opened again starts over), while the context lasts;
    with ``digest`` each frame's SHA-1 in its place (4K clips)."""
    frames: dict = {}
    real = vio.open_writer

    def open_writer(dst, *a, **k):
        wtr, gpu = real(dst, *a, **k)
        rec = frames[str(dst)] = []

        class Rec:
            def write_frame(self, f):
                rec.append(hashlib.sha1(np.ascontiguousarray(f)).hexdigest() if digest
                           else f.copy())
                wtr.write_frame(f)

            def close(self):
                wtr.close()
        return Rec(), gpu
    if on:
        vio.open_writer = open_writer
    try:
        yield frames
    finally:
        vio.open_writer = real


@contextlib.contextmanager
def record_readers(vio):
    """(workers, chunks) of every parallel reader the port opens while the
    context lasts."""
    seen, real = [], vio.ChunkedParallelReader

    class Recorded(real):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            seen.append((self.workers, self.n_chunks))
    vio.ChunkedParallelReader = Recorded
    try:
        yield seen
    finally:
        vio.ChunkedParallelReader = real


def bt601(src: bytes, w: int, h: int) -> np.ndarray:
    """Planar YUV 4:2:0 -> (h, w, 3) RGB, BT.601 limited range, in int64."""
    a = np.frombuffer(src, np.uint8).astype(np.int64)
    y = a[:w * h].reshape(h, w)
    u = a[w * h:w * h * 5 // 4].reshape(h // 2, w // 2).repeat(2, 0).repeat(2, 1) - 128
    v = a[w * h * 5 // 4:].reshape(h // 2, w // 2).repeat(2, 0).repeat(2, 1) - 128
    c = 298 * (y - 16)
    return np.stack([np.clip((c + 409 * v + 128) >> 8, 0, 255),
                     np.clip((c - 100 * u - 208 * v + 128) >> 8, 0, 255),
                     np.clip((c + 516 * u + 128) >> 8, 0, 255)], -1).astype(np.uint8)


def planar_gbr(frames: np.ndarray):
    import torch

    return torch.from_numpy(np.ascontiguousarray(
        np.transpose(frames, (0, 3, 1, 2))[:, [1, 2, 0]])).cuda()


def warp_grid(h: int, w: int, strength: float, b: int, dev):
    """grid_sample's grid for the oracle's barrel-warp maps, (b, h, w, 2):
    the warp rows' library call."""
    import torch

    from pythoncrt_tpu_torch import oracle

    map_x, map_y = oracle.barrel_warp_maps(h, w, strength)
    grid = torch.from_numpy(np.stack([map_x * (2.0 / (w - 1)) - 1.0,
                                      map_y * (2.0 / (h - 1)) - 1.0], -1)).float().to(dev)
    return grid[None].expand(b, h, w, 2).contiguous()


class MemReader:
    """``render_stream``'s reader over in-memory NHWC frames: the first
    ``n`` of ``clip``, cropped to ``h`` x ``w``."""

    def __init__(self, clip: np.ndarray, n: int, h: int, w: int) -> None:
        self.clip, self.n, self.out_h, self.out_w, self.i = clip, n, h, w, 0

    def read_into(self, buf) -> bool:
        if self.i >= self.n:
            return False
        buf[...] = self.clip[self.i, :self.out_h, :self.out_w]
        self.i += 1
        return True

    def close(self) -> None:
        pass


class MemWriter:
    """``render_stream``'s writer keeping a copy of every frame."""

    def __init__(self) -> None:
        self.frames = []

    def write_frame(self, f) -> None:
        self.frames.append(f.copy())

    def close(self) -> None:
        pass


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    for k in {k for env in OPTINS.values() for k in env}:
        os.environ.pop(k, None)  # the opt-in variables reach only the runs that set them
    # ---- 1. the card and the host ----
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi: no output"
    try:
        from pythoncrt_tpu_torch.io import video as vio
        from pythoncrt_tpu_torch.kernels import _build
    except ImportError as e:  # the script alone, without the port beside it
        print(f"chip_smoke: the port's package is not importable ({e}); run this script from "
              "the root of a checkout", file=sys.stderr)
        return 1

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
    for inst in fused_instances(_build.build_log):
        print(f"[2] fused instantiation {inst['core']}, radius {inst['radius']}, "
              f"{inst['input']} input, {inst['triad']} triad: {inst['registers']} registers, "
              f"{inst['stack']} bytes "
              f"stack frame, {inst['spill_stores']} + {inst['spill_loads']} bytes spill "
              f"(stores + loads), {inst['static_smem']} bytes static shared memory (dynamic: "
              f"the plan's, in [3]); {inst['grain']} grain; text {inst['text']}")
        if inst["stack"] or inst["spill_stores"] or inst["spill_loads"]:
            fail(f"fused instantiation {inst} uses local memory")
    graw_plans(sum(i["grain"].startswith("raw") for i in fused_instances(_build.build_log)))
    for inst in rng_instances(_build.build_log):
        # the stack frame is the FP64 cos and sin's argument reduction for
        # arguments past 2^20 or so (libdevice), a path the draws' angles in
        # [0, 2 pi) never take; a spill would be the kernel's own
        print(f"[2] draw kernel {inst['kernel']} (csrc/rng.cu): {inst['registers']} registers, "
              f"{inst['stack']} bytes stack frame (libdevice's cos and sin reduction of large "
              f"arguments, not taken), {inst['spill_stores']} + {inst['spill_loads']} bytes "
              f"spill (stores + loads)")
        if inst["spill_stores"] or inst["spill_loads"]:
            fail(f"draw kernel {inst} spills to local memory")
    for inst in walk_instances(_build.build_log):
        band = f", band {inst['band']}" if inst["band"] else ""
        print(f"[2] row-walk instance {inst['kernel']}, {inst['source']}{band}: "
              f"{inst['registers']} registers, {inst['stack']} bytes stack frame, "
              f"{inst['spill_stores']} + {inst['spill_loads']} bytes spill (stores + loads); "
              f"shared memory: the plan's, in [3]")
        if inst["stack"] or inst["spill_stores"] or inst["spill_loads"]:
            fail(f"row-walk instance {inst} uses local memory")
    for inst in warp_instances(_build.build_log):
        print(f"[2] warp instance, {inst['emit']} emit: "
              f"{inst['registers']} registers, {inst['stack']} bytes stack frame, "
              f"{inst['spill_stores']} + {inst['spill_loads']} bytes spill (stores + loads)")
        if inst["stack"] or inst["spill_stores"] or inst["spill_loads"]:
            fail(f"warp instance {inst} uses local memory")
    sys.stdout.flush()

    from pythoncrt_tpu_torch import CRTEngine, EffectParams, MultiClipEngine, oracle
    from pythoncrt_tpu_torch.kernels import bloom as kbloom
    from pythoncrt_tpu_torch.kernels import bloom2 as kbloom2
    from pythoncrt_tpu_torch.kernels import bloom3 as kbloom3
    from pythoncrt_tpu_torch.kernels import bloom_walk as kwalk
    from pythoncrt_tpu_torch.kernels import fused as kfused
    from pythoncrt_tpu_torch.kernels import glitch as kglitch
    from pythoncrt_tpu_torch.kernels import persist as kpersist
    from pythoncrt_tpu_torch.kernels import rng as krng
    from pythoncrt_tpu_torch.kernels import text as ktext
    from pythoncrt_tpu_torch.kernels import triad as ktriad
    from pythoncrt_tpu_torch.kernels import warp as kwarp
    from pythoncrt_tpu_torch.ops import color as ocolor
    from pythoncrt_tpu_torch.ops import resize as oresize

    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    configs = {**{k: EffectParams(**kw, text=TextParams(**(text or {})))
                  for k, (kw, text) in PREVIEW_CONFIGS.items()},
               "c3-bloom2": EffectParams(**C3), "defaults-bloom2": EffectParams(),
               "c3-stripe": EffectParams(**C3), "c5": EffectParams(**C4),
               "c5-text": EffectParams(**C4, text=TextParams(**C5_TEXT)),
               "defaults-s11": EffectParams(fast_bloom=False, bloom_sigma=11.0),
               "c4-text-s11": EffectParams(**dict(C4, fast_bloom=False, bloom_sigma=11.0),
                                           text=TextParams(**C4_TEXT)),
               "defaults-angled-s11": EffectParams(**DEF_ANGLED, fast_bloom=False,
                                                   bloom_sigma=11.0),
               "ab8-w8": EffectParams(aberration_px=8),
               "defaults-fast": EffectParams(), "c3-fast": EffectParams(**C3),
               # the CLI defaults with --grain-size 2: the fast core's raw-grain mode
               "defaults-g2": EffectParams(grain_size=2)}
    ov_synth = synth_overlay(H, W, seed=4)  # the parity phases need no font
    table = {}

    def gaps(got, want) -> tuple:
        """(max abs difference, max uint8 steps) of a kernel's outputs from
        its twin's, tensor by tensor; an integer output counts its steps in
        both."""
        err, lsb = 0.0, 0
        for a, b in zip(as_tuple(got), as_tuple(want)):
            if a.shape != b.shape or a.dtype != b.dtype:
                fail(f"kernel output {tuple(a.shape)} {a.dtype}, twin {tuple(b.shape)} {b.dtype}")
            if a.is_floating_point():
                err = max(err, (a - b).abs().max().item())
                lsb = max(lsb, int((torch.round(a * 255) - torch.round(b * 255)).abs().max().item()))
            else:
                d = int((a.long() - b.long()).abs().max().item())
                err, lsb = max(err, float(d)), max(lsb, d)
        return err, lsb

    def row(kname, src, repl, run, twin, lib=None, *, ops=(), more=(), timed=None,
            tol=FUSED_TOL, lsb_tol=LSB_TOL, twin_iters=3, work=None, bnd=None, f64=0, f32=0,
            note="", frames=B, res=(H, W)):
        """One row of the kernels table: ``run`` (the kernel's call) against
        ``twin`` (its plain twin), and each (kernel's, twin's output) of
        ``more``, within ``tol`` abs and ``lsb_tol`` uint8 steps; the kernel,
        the twin (``timed``: the two calls to time in their place, for a
        kernel that works in place) and ``lib`` (the one PyTorch call that
        computes the same function, where there is one) timed with CUDA
        events; the least time of the work (``ops`` and the outputs, each
        read or written once, ``f64`` and ``f32`` operations per value: see
        bound; ``work``: (bytes, values) in their place; ``bnd``: the bound
        and what sets it). Prints and records the row; returns the kernel's
        output."""
        got = run()
        pairs = [(got, twin()), *more]
        torch.cuda.synchronize()
        if not all(torch.isfinite(t).all() for pair in pairs for side in pair
                   for t in as_tuple(side) if t.is_floating_point()):
            fail(f"{kname}: non-finite output")
        err, lsb = (max(v) for v in zip(*(gaps(a, b) for a, b in pairs)))
        run_t, twin_t = timed or (run, twin)
        ms, plain_ms = time_ms(run_t), time_ms(twin_t, iters=twin_iters)
        lib_ms = None if lib is None else time_ms(lib)
        bytes_moved, values = work or (nbytes(*ops, *as_tuple(got)), as_tuple(got)[0].numel())
        bms, by = bnd or bound(kname, bytes_moved, values, f64, f32)
        lib_s = f"{lib_ms:.4f} ms/call" if lib_ms is not None else "none (no one PyTorch call)"
        print(f"[3] {kname}{note}: max |kernel - twin| {err:.3g}, max {lsb} LSB; "
              f"kernel {ms:.4f} ms/call ({ms / frames:.4f} ms/frame), plain twin "
              f"{plain_ms:.4f} ms/call ({plain_ms / frames:.4f} ms/frame), library {lib_s}; "
              f"bound {bms:.4f} ms/call ({bms / frames:.4f} ms/frame; {by}: "
              f"{bytes_moved / 1e6:.1f} MB; {100 * bms / ms:.1f}% of the bound reached) at "
              f"{frames} frames {res[0]}x{res[1]} on {card}", flush=True)
        if not (err <= tol and lsb <= lsb_tol):
            fail(f"{kname}{note} disagrees with its twin: {err:.3g} abs, {lsb} LSB")
        table[kname] = dict(name=kname, route="cuda", source=src, replaces=repl, launches=0,
                            max_abs_err=float(err), ms=ms, plain_ms=plain_ms,
                            bound_ms=bms, bound_by=by, library_ms=lib_ms)
        return got

    def raw_grain_check(kname, eng, x, kw, got) -> None:
        """The raw-grain mode (grain size above 1: the kernel stages the raw
        rows and upsamples them) against the upsample as torch ops (the
        oracle's bilinear taps), then the kernel at grain size 1. Bit for
        bit, or the smoke fails. Timed: that two-step path, the kernel at
        grain size 1 alone on the upsampled field (what the raw-grain
        kernel should not be slower than: it reads 4x fewer grain bytes at
        grain size 2), and the raw-grain kernel again after both, beside
        the row's time."""
        flat_spec = dataclasses.replace(eng.spec, grain_size=1)
        flat = kfused.fused_consts(flat_spec, dev, y_map=eng.consts["pix_y"],
                                   x_maps=eng.consts["pix_x"][list(eng._plane_colors)])
        t = eng.fused_tables.grain_taps

        def upsample():
            return oresize.resize_bilinear(kw["grain"], t[0].long(), t[1], t[2].long(),
                                           t[3]).contiguous()

        def two_step():
            return kfused.fused_pipeline(x, flat_spec, flat, **{**kw, "grain": upsample()})
        want = two_step()
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            fail(f"the raw-grain mode differs from the upsample then the kernel at grain size 1: "
                 f"{(got - want).abs().max().item():.3g}")
        ms = table[kname]["ms"]
        pms = time_ms(two_step)
        field = upsample()
        fms = time_ms(lambda: kfused.fused_pipeline(x, flat_spec, flat, **{**kw, "grain": field}))
        again = time_ms(lambda: kfused.fused_pipeline(x, eng.spec, eng.fused_tables, **kw))
        gh, gw = eng.spec.grain_hw
        p = eng.fused_tables.plan
        table[kname]["raw_grain"] = dict(
            two_step_ms=pms, full_field_kernel_ms=fms, raw_grain_ms_again=again,
            raw_stage=dict(gdepth=p.gdepth, gpitch=p.gpitch, grows=p.grows), smem=p.smem,
            blocks_per_sm=kfused.blocks_per_sm(p.smem))
        print(f"[3] {kname}: raw grain {gh}x{gw} staged and upsampled in the kernel ({p.gdepth} "
              f"raw rows of {p.gpitch} floats and {p.grows} rows' taps per chunk, two buffers; "
              f"{kfused.blocks_per_sm(p.smem)} blocks per SM by shared memory), bit for bit the "
              f"torch upsample then the kernel at grain size 1 (that path {pms:.4f} ms/call, "
              f"{pms / B:.4f} ms/frame, {pms / ms:.2f}x; the kernel at grain size 1 alone on the "
              f"upsampled field {fms:.4f} ms/call, {fms / B:.4f} ms/frame, the raw-grain kernel "
              f"{ms / fms:.3f}x it, {again / B:.4f} ms/frame timed again after it; its grain "
              f"operand {B * eng.h * eng.w * 4 / 1e6:.1f} MB against "
              f"{kw['grain'].numel() * 4 / 1e6:.2f})", flush=True)

    def fused_row(kname, eng, feed, spec=None, consts=None, kw=None, **k):
        """The fused kernel's row on an engine's operands (its own spec,
        tables and batch-of-B operands unless given); the kernel's output."""
        spec = eng.spec if spec is None else spec
        consts = eng.fused_tables if consts is None else consts
        if kw is None:
            kw = eng.fused_operands(eng.make_aux(np.arange(B)))
        return row(kname, *FUSED_CU,
                   functools.partial(kfused.fused_pipeline, feed, spec, consts, **kw),
                   functools.partial(kfused.fused_pipeline_ref, feed, spec, consts, **kw),
                   ops=(feed, *kw.values(), *(consts.grain_taps or ())), **k)

    # ---- 3. kernels vs plain twins at the main paths' shapes ----
    frames = synth(B, H, W, seed=1)
    x = planar_gbr(frames)
    fused_out = {}
    for cfg, kname in (("c3", "fused_pipeline_gaussian"), ("defaults", "fused_pipeline"),
                       ("defaults-g2", "fused_pipeline_raw_grain")):
        eng = CRTEngine(configs[cfg], H, W, FPS, rng="host", layout="planar",
                        channel_order="gbr", device=dev)
        kw = eng.fused_operands(eng.make_aux(np.arange(B)))
        got = fused_row(kname, eng, x, kw=kw,
                        note=f" ({cfg} spec, {'fast' if eng.spec.fast else 'gaussian'} core"
                             f"{plan_note(eng.fused_tables)})")
        if eng.spec.grain_size > 1:
            raw_grain_check(kname, eng, x, kw, got)
        fused_out[cfg] = (eng, got)

    # the warp on c3's fused output: c3's tables (strength 0.15) and
    # strength 1.0, the clamp's end (the widest source footprints)
    eng3, fz = fused_out["c3"]
    for kname, strength, tabs in (("warp_planar", C3["warp_strength"], eng3.warp_tables),
                                  ("warp_planar_strength1", 1.0,
                                   kwarp.build_warp_tables(H, W, 1.0, dev))):
        grid = warp_grid(H, W, strength, B, dev)
        gs = torch.nn.functional.grid_sample(fz, grid, mode="bilinear", padding_mode="zeros",
                                             align_corners=True)
        print(f"[3] {kname}: grid_sample (the library call) vs the oracle's taps: max "
              f"{(gs - kwarp.warp_planar_ref(fz, tabs)).abs().max().item():.3g} abs (f32 "
              f"coordinates renormalized)")
        row(kname, *WARP_CU, functools.partial(kwarp.warp_planar, fz, tabs, emit_u8=True),
            functools.partial(kwarp.warp_planar_ref, fz, tabs, emit_u8=True),
            functools.partial(torch.nn.functional.grid_sample, fz, grid, mode="bilinear",
                              padding_mode="zeros", align_corners=True),
            ops=(fz, *tabs), more=[(kwarp.warp_planar(fz, tabs), kwarp.warp_planar_ref(fz, tabs))],
            tol=0.0, lsb_tol=0, note=f" (strength {strength}, uint8 emit; one thread per four "
                                     "outputs, the tables read once per batch)")
        del gs, grid

    _, fd = fused_out["defaults"]
    p_def = configs["defaults"].persistence
    state = torch.rand((3, H, W), generator=torch.Generator(device=dev).manual_seed(3),
                       device=dev)
    row("persistence_scan", *PERSIST_CU,
        functools.partial(kpersist.persistence_scan, fd, state, False, p_def, emit_u8=True),
        functools.partial(kpersist.persistence_scan_ref, fd, state, False, p_def, emit_u8=True),
        ops=(fd, state), tol=0.0,
        more=[(kpersist.persistence_scan(fd, state, True, p_def, emit_u8=True),
               kpersist.persistence_scan_ref(fd, state, True, p_def, emit_u8=True))],
        note=" (CLI defaults, stream head and carried state)")

    # the glitch rows' shapes and offsets, timed on the device at the end
    # ([6]) on fresh frames: (frames, frame shape, y0, offsets, seg, in place)
    glitch_device = {}

    def glitch_plan_note():
        """The plan the latest glitch launch took (kernels/glitch.py last_plan)."""
        plan = kglitch.last_plan
        return (f"plan: {'16-byte' if plan.vec else 'scalar'} copies, {plan.tx} threads a row, "
                f"grid {plan.grid}, {plan.smem} B shared memory")

    def glitch_rows(kname, img, y0, off, seg, more=(), **k):
        """The in-place glitch entry's row on a copy of ``img``: the whole
        frame against the rows above the band and the twin's band; timed
        in place on a scratch copy, beside torch.gather of the band."""
        band = img[:, :, y0:].contiguous()
        idx = torch.remainder(torch.arange(img.shape[3], device=dev)
                              + off.long()[:, :, seg.long()], img.shape[3])[:, None].expand(
                                  band.shape).contiguous()
        work = img.clone()
        return row(kname, *GLITCH_CU,
                   lambda: kglitch.shear_planar_inplace(img.clone(), y0, off, seg),
                   lambda: torch.cat([img[:, :, :y0], kglitch.shear_planar_ref(band, off, seg)], 2),
                   functools.partial(torch.gather, band, 3, idx), more=more,
                   timed=(functools.partial(kglitch.shear_planar_inplace, work, y0, off, seg),
                          functools.partial(kglitch.shear_planar_ref, band, off, seg)),
                   work=(nbytes(band, band, off, seg), band.numel()), tol=0.0, **k)

    img = fused_out["defaults"][1]
    shears = {}
    for mode in ("export", "preview"):
        ge = CRTEngine(configs["c4"], H, W, FPS, rng="host", engine=mode, device=dev)
        y0, rows = ge._glitch_y0, ge._glitch_rows
        if (y0, rows) != (756, 324):
            fail(f"c4 band is rows {y0}+{rows}, expected 756+324")
        shears[mode] = (ge.glitch_offsets(ge.make_aux(np.arange(B))),
                        ge.consts["glitch_seg_index"])
    band = img[:, :, y0:].contiguous()
    (off, seg), (poff, pseg) = shears["export"], shears["preview"]
    kglitch.shear_planar_inplace(img.clone(), y0, off, seg)  # the plan the row's launches take
    c4_note = glitch_plan_note()
    glitch_rows("glitch_shear", img, y0, off, seg,
                more=[(kglitch.shear_planar_inplace(img.clone(), y0, poff, pseg)[:, :, y0:],
                       kglitch.shear_planar_ref(band, poff, pseg))],
                note=f" (c4 band 756+324, export and preview offsets, in place; {c4_note}; the "
                     f"kernel's device time: [6])")
    row("glitch_shear_band", GLITCH_CU[0], "pythoncrt_tpu/kernels/glitch.py:165",
        functools.partial(kglitch.shear_planar, band, off, seg),
        functools.partial(kglitch.shear_planar_ref, band, off, seg),
        functools.partial(torch.gather, band, 3, torch.remainder(
            torch.arange(W, device=dev) + off.long()[:, :, seg.long()], W)[:, None].expand(
                band.shape).contiguous()),
        ops=(band, off, seg), tol=0.0,
        more=[(kglitch.shear_planar(band, poff, pseg), kglitch.shear_planar_ref(band, poff, pseg))],
        note=" (the out-of-place band entry shear_planar, export and preview offsets; on no main "
             "path; the kernel's device time: [6])")
    for kname, inplace in (("glitch_shear", True), ("glitch_shear_band", False)):
        glitch_device[kname] = (B, (B, 3, H, W), y0, off, seg, inplace)
    del fused_out, fz, fd, state, img, band

    # the native draws (csrc/rng.cu), one launch per batch and stream, at
    # the main paths' shapes: the grain field of c4 (full size), of c3 (grain
    # size 2) and of c5 (4K, 32 frames); the export offsets of c4's band and
    # c5's; the preview offsets of c4's band. Bit for bit the twin, batch by
    # batch; torch.randn of the output's shape is the library yardstick.
    # First the Box-Muller fast path swept over its domains, and the
    # instructions of a Philox call and of a Box-Muller pair counted from
    # their SASS.
    bm_share = rng_sweep_phase(dev)
    philox_ops, philox_by_op = philox_int_ops(_build.find_nvcc(), _build.NVCC_FLAGS)
    print(f"[3] a Philox4x32-10 call (csrc/rng.cu's draw) compiled with the kernels' flags: "
          f"{philox_ops} vector integer instructions in its SASS ({philox_by_op}; the uniform "
          f"datapath's left out), the draw rows' integer operations per call", flush=True)
    bm = bm_sass_counts(_build.find_nvcc(), _build.NVCC_FLAGS)
    fast, fp64 = bm["bm_fast_probe"]["body"], bm["bm_fp64_probe"]
    print(f"[3] a Box-Muller pair compiled with the kernels' flags, SASS instructions (FP64 "
          f"arithmetic, 64-bit conversions, MUFU 64H, vector integer): the fast path "
          f"(csrc/box_muller.cuh fast_pair, straight-line) "
          f"{fast['fp64']}, {fast['conv64']}, {fast['mufu64']}, {fast['int']}; the parent's "
          f"libdevice transform (box_muller_fp64, now the fallback) {fp64['body']['fp64']}, "
          f"{fp64['body']['conv64']}, {fp64['body']['mufu64']}, {fp64['body']['int']} outside "
          f"the subroutines it calls (the reduction of large arguments and the slow paths, never "
          f"taken by the draws), {fp64['all']['fp64']} FP64 arithmetic in all its code. Per pair: "
          f"{fast['fp64']} + {bm_share:.3e} x {fp64['body']['fp64']} FP64 instructions (the "
          f"fallback share measured above)", flush=True)
    fb = fp64["body"]
    bm_f64 = fast["fp64"] + bm_share * fb["fp64"]
    bm_conv = fast["conv64"] + fast["mufu64"] + bm_share * (fb["conv64"] + fb["mufu64"])
    bm_int = fast["int"] + bm_share * fb["int"]
    table_bm = dict(fast=fast, fallback=fb, fallback_all_fp64=fp64["all"]["fp64"],
                    fallback_share=bm_share)

    def draw_bound(calls: int, pairs: int, out_bytes: int) -> tuple:
        """The least time for the draws, and what sets it: the output bytes
        over the memory rate, the integer instructions (Philox's per call,
        the Box-Muller's per pair) over the INT32 rate, the Box-Muller's
        FP64 instructions over the FP64 rate, or its 64-bit conversions and
        MUFU 64H over theirs, whichever is largest (the fallback's counted
        at its measured share)."""
        from portbench.yardstick import HBM_BYTES_PER_S

        cands = ((out_bytes / HBM_BYTES_PER_S * 1e3, "bytes"),
                 ((calls * philox_ops + pairs * bm_int) / INT32_OPS_PER_S * 1e3, "INT32"),
                 (pairs * bm_f64 / F64_INSTR_PER_S * 1e3, "FP64"),
                 (pairs * bm_conv / CONV64_PER_S * 1e3, "FP64 conversions"))
        return max(cands)

    def draw_launches():
        return krng.grain_launches + krng.export_launches + krng.preview_launches

    def by_batch(twin, fr):
        """The twin batch by batch, as the engines launch the draws."""
        return torch.cat([twin(fr[k:k + B]) for k in range(0, fr.numel(), B)])

    draw_eng = {m: CRTEngine(configs["c4"], H, W, FPS, engine=m, device=dev)
                for m in ("export", "preview")}
    amp = draw_eng["export"]._glitch_amp
    nseg = draw_eng["export"]._glitch_nseg
    amp5 = CRTEngine(configs["c5"], H4, W4, FPS, device=dev)
    draws = (  # name, frames, run, twin, Philox calls, Box-Muller pairs, note
        ("rng_grain_normals", B, lambda f: krng.grain_normals(0, f, H, W),
         lambda f: krng.grain_normals_ref(0, f, H, W), H * W // 4, H * W // 2,
         f"c4's grain field, {H}x{W}"),
        ("rng_grain_normals_c3", B, lambda f: krng.grain_normals(0, f, H // 2, W // 2),
         lambda f: krng.grain_normals_ref(0, f, H // 2, W // 2), H * W // 16, H * W // 8,
         f"c3's raw grain field (grain size 2), {H // 2}x{W // 2}"),
        ("rng_grain_normals_c5", C5_CLIPS * B, lambda f: krng.grain_normals(0, f, H4, W4),
         lambda f: krng.grain_normals_ref(0, f, H4, W4), H4 * W4 // 4, H4 * W4 // 2,
         f"c5's grain field, {H4}x{W4}, {C5_CLIPS} clips x {B} frames"),
        ("rng_glitch_export_offsets", B,
         lambda f: krng.glitch_export_offsets(0, f, nseg, amp),
         lambda f: krng.glitch_export_offsets_ref(0, f, nseg, amp),
         -(-amp.numel() * nseg // 4) + -(-amp.numel() // 4), (amp.numel() * (nseg + 1) + 1) // 2,
         f"c4's export offsets, band {amp.numel()} rows x {nseg} segments"),
        ("rng_glitch_export_offsets_c5", C5_CLIPS * B,
         lambda f: krng.glitch_export_offsets(0, f, amp5._glitch_nseg, amp5._glitch_amp),
         lambda f: krng.glitch_export_offsets_ref(0, f, amp5._glitch_nseg, amp5._glitch_amp),
         -(-amp5._glitch_amp.numel() * amp5._glitch_nseg // 4)
         + -(-amp5._glitch_amp.numel() // 4),
         (amp5._glitch_amp.numel() * (amp5._glitch_nseg + 1) + 1) // 2,
         f"c5's export offsets, band {amp5._glitch_amp.numel()} rows x {amp5._glitch_nseg} "
         f"segments, {C5_CLIPS} clips x {B} frames"),
        ("rng_glitch_preview_offsets", B,
         lambda f: krng.glitch_preview_offsets(0, f, draw_eng["preview"]._glitch_amp),
         lambda f: krng.glitch_preview_offsets_ref(0, f, draw_eng["preview"]._glitch_amp),
         draw_eng["preview"]._glitch_rows, draw_eng["preview"]._glitch_rows,
         f"c4's preview offsets, band {draw_eng['preview']._glitch_rows} rows"))
    kernel_of = {"grain": "grain_kernel", "export": "export_kernel", "preview": "preview_kernel"}
    draw_device = {}  # the draw rows' runs, timed on the device at the end ([6])
    for kname, nb, run, twin, calls, pairs, note in draws:
        fr = torch.arange(nb, device=dev) + 1000
        n0 = draw_launches()
        got = run(fr)
        torch.cuda.synchronize()
        if draw_launches() != n0 + 1:
            fail(f"{kname}: {draw_launches() - n0} launches for one batch")
        bms, kind = draw_bound(calls * nb, pairs * nb, got.numel() * 4)
        row(kname, "pythoncrt_tpu_torch/csrc/rng.cu",
            "none (the JAX package draws with jax.random, XLA ops: "
            "pythoncrt_tpu/engine.py:942-1014, ops/glitch.py:41-62)",
            functools.partial(run, fr), functools.partial(by_batch, twin, fr),
            functools.partial(torch.randn, got.shape, device=dev), ops=(fr,), tol=0.0,
            lsb_tol=0, twin_iters=2, frames=nb, res=(H4, W4) if nb > B else (H, W),
            bnd=(bms, "bytes" if kind == "bytes" else "operations"),
            note=f" ({note}; 1 launch per batch, bit for bit the twin; bound by {kind}; "
                 f"torch.randn of {tuple(got.shape)} is the library yardstick, another stream; "
                 f"the kernel's device time: [6])")
        table[kname].update(launches_per_batch=1, bound_kind=kind, box_muller=table_bm)
        draw_device[kname] = (nb, tuple(got.shape), functools.partial(run, fr),
                              next(v for k, v in kernel_of.items() if k in kname))
        del got

    # the stand-alone bloom and the fused f32-input mode, each on the
    # pre-bloom image (stages 1-5, synthetic overlay) of its path; the fused
    # kernel's text mode (the overlay composited in its prologue) on the
    # uint8 frames
    for cfg, kname in (("c3-angled", "bloom3_planar"), ("defaults-angled", "bloom3_fast_planar"),
                       ("c4-text", "fused_pipeline_f32in"), ("c4-text", "fused_pipeline_text")):
        eng = CRTEngine(configs[cfg], H, W, FPS, rng="host", layout="planar",
                        channel_order="gbr", device=dev, text_rgba=ov_synth)
        if kname == "fused_pipeline_text":
            if eng._staged or not eng.spec.text_box:
                fail(f"{cfg} does not composite its text in the fused kernel")
            fused_row(kname, eng, x, note=f" (c4-text spec: the text composited in the prologue "
                                         f"over its box {eng.spec.text_box}, fast core"
                                         f"{plan_note(eng.fused_tables)})")
            continue
        feed = eng._pre_bloom(x)
        if kname == "fused_pipeline_f32in":
            if eng._staged or eng.text_route != "fused":
                fail(f"{cfg} does not take the fused kernel")
            spec, consts = f32_input(eng)
            kw = eng.fused_operands(eng.make_aux(np.arange(B)))
            fused_row(kname, eng, feed, spec, consts,
                      {k: v for k, v in kw.items() if k not in ("talpha", "trgb")},
                      note=f" (c4-text spec: text before the bloom, fast core{plan_note(consts)})")
        elif not eng._staged or eng.bloom3_spec is None:
            fail(f"{cfg} does not take the staged step")
        elif eng.bloom3_spec.fast:
            spec, tabs = eng.bloom3_spec, eng.bloom3_tables
            row(kname, WALK_CU, "pythoncrt_tpu/kernels/bloom3.py:495",
                functools.partial(kbloom3.bloom3_fast_planar, feed, spec, tabs),
                functools.partial(kbloom3.bloom3_fast_planar_ref, feed, spec, tabs),
                ops=(feed, *tabs.taps), tol=0.0,
                note=f" (defaults-angled: half-res down and up{fast_note(tabs.plan)})")
        else:
            spec = eng.bloom3_spec
            row(kname, WALK_CU, "pythoncrt_tpu/kernels/bloom3.py:274",
                functools.partial(kbloom3.bloom3_planar, feed, spec),
                functools.partial(kbloom3.bloom3_planar_ref, feed, spec), ops=(feed,), tol=0.0,
                note=f" (c3-angled: sigma 1.2, {len(spec.taps)} taps; the row walk's fold"
                     f"{walk_note(H, W, kwalk.FOLD, (-spec.r, spec.r) * 2)})")
        del feed

    # the opt-in blooms, each on the pre-bloom image of its path
    for cfg, kname in (("c3-bloom2", "bloom2_planar"), ("defaults-bloom2", "bloom2_planar_fast"),
                       ("c3-stripe", "bloom_stripe")):
        with optin_env(cfg):
            eng = CRTEngine(configs[cfg], H, W, FPS, rng="host", layout="planar",
                            channel_order="gbr", device=dev)
        if eng.bloom_route != ("stripe" if cfg == "c3-stripe" else "bloom2"):
            fail(f"{cfg} takes the {eng.bloom_route} route")
        feed, spec = eng._pre_bloom(x), eng.bloom_spec
        if cfg == "c3-stripe":
            r = spec.radius
            row(kname, WALK_CU, "pythoncrt_tpu/kernels/bloom.py:142",
                functools.partial(kbloom.bloom_planar, feed, spec),
                functools.partial(kbloom.bloom_planar_ref, feed, spec), ops=(feed,), tol=0.0,
                note=f" (c3-stripe: sigma 1.2, {len(spec.taps)} taps, the oracle's "
                     f"pad-then-sum; the row walk's clamp"
                     f"{walk_note(H, W, kwalk.CLAMP, (-r, r, -r, r))})")
            continue
        tabs = eng.bloom2_tables
        bands = (spec.hd0, spec.hd1, spec.vd0, spec.vd1)
        row(kname, WALK_CU, "pythoncrt_tpu/kernels/bloom2.py:334",
            functools.partial(kbloom2.bloom2_planar, feed, spec, tabs),
            functools.partial(kbloom2.bloom2_planar_ref, feed, spec, tabs), ops=(feed, *tabs),
            tol=0.0, note=f" ({cfg}: {spec.variant}, bands {spec.hd0}..{spec.hd1} x "
                          f"{spec.vd0}..{spec.vd1}; the row walk's table"
                          f"{walk_note(H, W, kwalk.TABLE, bands)})")
        if cfg == "c3-bloom2":  # the pipelined entry: limbs 3 timed, 2 and 1 checked too
            lt = {limbs: kbloom2.bloom2_tables(spec, dev, limbs) for limbs in (3, 2, 1)}
            row("bloom2_planar_pipelined", WALK_CU, "pythoncrt_tpu/kernels/bloom2.py:455",
                *(functools.partial(f, feed, spec, 3, lt[3]) for f in (
                    kbloom2.bloom2_planar_pipelined, kbloom2.bloom2_planar_pipelined_ref)),
                ops=(feed, *lt[3]), tol=0.0,
                more=[(kbloom2.bloom2_planar_pipelined(feed, spec, limbs, lt[limbs]),
                       kbloom2.bloom2_planar_pipelined_ref(feed, spec, limbs, lt[limbs]))
                      for limbs in (2, 1)],
                note=" (limbs 3, and limbs 2 and 1 against their twins; kernel-only: no engine "
                     "route in either package)")
            del lt
        del feed

    # every gaussian route past the launch arguments' 63 taps: the fused
    # kernel on the CLI defaults with --no-fast-bloom (taps from a device
    # table in shared memory), and the row walk's fold (bloom3, on
    # defaults-angled's pre-bloom image), clamp (the stripe) and table
    # (bloom2) on c3's
    for tag, sigma in SIGMAS.items():
        eng = CRTEngine(EffectParams(fast_bloom=False, bloom_sigma=sigma), H, W, FPS,
                        rng="host", layout="planar", channel_order="gbr", device=dev)
        if eng._staged or eng.spec.fast or eng.spec.r != round(3 * sigma):
            fail(f"sigma {sigma}: the CLI defaults do not take the fused gaussian core")
        if eng.spec.emit != "f32":
            fail(f"sigma {sigma}: the CLI defaults' fused kernel does not emit f32")
        fused_row(f"fused_pipeline_{tag}", eng, x, twin_iters=2,
                  note=f" (the CLI defaults with --no-fast-bloom --bloom-sigma {sigma:g}: radius "
                       f"{eng.spec.r}{plan_note(eng.fused_tables)})")
        ang = CRTEngine(EffectParams(**DEF_ANGLED, fast_bloom=False, bloom_sigma=sigma), H, W,
                        FPS, rng="host", layout="planar", channel_order="gbr", device=dev)
        c3e = CRTEngine(EffectParams(**C3), H, W, FPS, rng="host", layout="planar",
                        channel_order="gbr", device=dev)
        if not ang._staged or ang.bloom3_spec.r != eng.spec.r:
            fail(f"sigma {sigma}: defaults-angled does not take bloom3's gaussian")
        feed3, feedc = ang._pre_bloom(x), c3e._pre_bloom(x)
        b3 = ang.bloom3_spec
        st = kbloom.build_bloom_spec(H, W, sigma, 0.25, 0.0)
        b2 = kbloom2.build_bloom2_spec(H, W, variant="gaussian", sigma=sigma, strength=0.25)
        t2 = kbloom2.bloom2_tables(b2, dev)
        r = b3.r
        for kname, src_id, repl, feed, run, twin, extra, bands in (
                (f"bloom3_planar_{tag}", kwalk.FOLD, "pythoncrt_tpu/kernels/bloom3.py:274", feed3,
                 functools.partial(kbloom3.bloom3_planar, feed3, b3),
                 functools.partial(kbloom3.bloom3_planar_ref, feed3, b3), (), (-r, r, -r, r)),
                (f"bloom_stripe_{tag}", kwalk.CLAMP, "pythoncrt_tpu/kernels/bloom.py:142", feedc,
                 functools.partial(kbloom.bloom_planar, feedc, st),
                 functools.partial(kbloom.bloom_planar_ref, feedc, st), (), (-r, r, -r, r)),
                (f"bloom2_planar_{tag}", kwalk.TABLE, "pythoncrt_tpu/kernels/bloom2.py:334",
                 feedc, functools.partial(kbloom2.bloom2_planar, feedc, b2, t2),
                 functools.partial(kbloom2.bloom2_planar_ref, feedc, b2, t2), t2,
                 (b2.hd0, b2.hd1, b2.vd0, b2.vd1))):
            row(kname, WALK_CU, repl, run, twin, ops=(feed, *extra), tol=0.0, twin_iters=2,
                note=f" (sigma {sigma:g}, radius {r}; the row walk's "
                     f"{kwalk.SRC_NAMES[src_id]}{walk_note(H, W, src_id, bands)})")
        del feed3, feedc, t2, eng, ang, c3e

    # the f32-input instantiation past radius 31: c4-text (text before the
    # bloom) with --no-fast-bloom --bloom-sigma 11
    eng = CRTEngine(configs["c4-text-s11"], H, W, FPS, rng="host", layout="planar",
                    channel_order="gbr", device=dev, text_rgba=ov_synth)
    if eng._staged or eng.text_route != "fused" or eng.spec.fast or eng.spec.r != 33:
        fail("c4-text at sigma 11 does not take the fused kernel past radius 31")
    spec, consts = f32_input(eng)
    kw = eng.fused_operands(eng.make_aux(np.arange(B)))
    fused_row("fused_pipeline_f32in_s11", eng, eng._pre_bloom(x), spec, consts,
              {k: v for k, v in kw.items() if k not in ("talpha", "trgb")}, twin_iters=2,
              note=f" (c4-text with --no-fast-bloom --bloom-sigma 11: text before the bloom, "
                   f"radius {eng.spec.r}{plan_note(consts)})")
    del eng, spec, consts, kw

    # --precision fast: the fused kernel's direct-pow triad (triad_mode 3,
    # its own instantiations) on the CLI defaults (fast core), c3
    # (gaussian), c4-text (f32 input) and sigma 11 (taps in shared
    # memory), each beside the LUT-exact mode timed in turn on the same
    # operands
    direct = (("defaults", "fused_pipeline"), ("c3", "fused_pipeline_gaussian"),
              ("c4-text", "fused_pipeline_text"), ("defaults-s11", "fused_pipeline_s11"))
    gammas = sorted({configs[cfg].triad_gamma for cfg, _ in direct})
    ops = pow_site_ops(_build.find_nvcc(), _build.NVCC_FLAGS, gammas)
    print(f"[3] the direct-pow triad's three pow sites (csrc/triad_pow.cuh) compiled alone with "
          f"the kernels' flags, instrumented and run on 98304 values over (0, 1]: operations per "
          f"value (FMA as two) by triad gamma, f32 {ops['per_value']['f32']}, FP64 (the "
          f"fallbacks) {ops['per_value']['f64']}; every path of their code, fallbacks "
          f"included: {ops['ptx_all_paths']} in the PTX, {ops['sass_all_paths']} in the SASS",
          flush=True)
    triad_sweep_phase(dev, sorted(set(ktriad.SWEEP_GAMMAS) | set(gammas)))
    for cfg, base in direct:
        ov = ov_synth if configs[cfg].text.enabled else None
        engs = {prec: CRTEngine(configs[cfg], H, W, FPS, rng="host", precision=prec,
                                layout="planar", channel_order="gbr", device=dev, text_rgba=ov)
                for prec in ("fast", "exact")}
        eng = engs["fast"]
        if kfused.triad_mode(eng.spec) != 3 or eng._staged:
            fail(f"{cfg} with precision fast does not take the fused direct-pow triad")
        feed = x if eng.spec.pre else eng._pre_bloom(x)
        kw = eng.fused_operands(eng.make_aux(np.arange(B)))
        gamma = configs[cfg].triad_gamma
        got = fused_row(f"{base}_direct", eng, feed, kw=kw, twin_iters=2,
                        f64=ops["per_value"]["f64"][gamma], f32=ops["per_value"]["f32"][gamma],
                        note=f" ({cfg} spec with precision fast: the JAX kernel's lut_exact=False "
                             f"branch, fused.py:601-631; the bound counts the pow sites' "
                             f"operations (before their f32 fast paths: {PR8_FP64_OPS} FP64 "
                             f"operations per value, an FP64 bound of "
                             f"{PR8_FP64_OPS / F64_OPS_PER_S * x.numel() * 1e3 / B:.4f} ms/frame)"
                             f"{plan_note(eng.fused_tables)})")
        ms = table[f"{base}_direct"]["ms"]
        exact_ms = time_ms(functools.partial(kfused.fused_pipeline, feed, engs["exact"].spec,
                                             engs["exact"].fused_tables, **kw))
        print(f"[3] {base}_direct: the LUT-exact mode {exact_ms:.4f} ms/call ({exact_ms / B:.4f} "
              f"ms/frame) in turn on the same operands, the direct mode {ms / exact_ms:.2f}x",
              flush=True)
        table[f"{base}_direct"]["exact_ms"] = exact_ms
        del got, feed, kw, engs, eng

    # c5's kernels at 3840x2160 on its operands: 4 clips x 8 frames flat
    # (clip-major), the fused kernel (c4 spec, fast core) and the glitch
    # shear in place as MultiClipEngine runs them, then the persistence
    # kernel's multi-clip mode on the effects' output. The fused twin runs
    # clip by clip (8 frames) to keep its intermediates small.
    eng5 = CRTEngine(configs["c5"], H4, W4, FPS, layout="planar", channel_order="gbr",
                     device=dev)
    gen = torch.Generator(device=dev).manual_seed(8)
    x5 = torch.randint(0, 256, (C5_CLIPS * B, 3, H4, W4), generator=gen, device=dev,
                       dtype=torch.uint8)
    aux5 = eng5.make_aux(np.tile(np.arange(B), C5_CLIPS))
    kw5 = eng5.fused_operands(aux5)
    per_frame = {"grain", "sl", "flicker"}  # operands with one entry per frame

    def fused5_twin():
        return torch.cat([kfused.fused_pipeline_ref(
            x5[c * B:(c + 1) * B], eng5.spec, eng5.fused_tables,
            **{k: v[c * B:(c + 1) * B] if k in per_frame else v for k, v in kw5.items()})
            for c in range(C5_CLIPS)])

    if not eng5.spec.fast or eng5._staged:
        fail("c5 does not take the fused kernel's fast core")
    f5 = row("fused_pipeline_c5", *FUSED_CU,
             functools.partial(kfused.fused_pipeline, x5, eng5.spec, eng5.fused_tables, **kw5),
             fused5_twin, ops=(x5, *kw5.values()), twin_iters=2, frames=C5_CLIPS * B,
             res=(H4, W4), note=f" (c5: c4 spec, fast core, {C5_CLIPS} clips x {B} frames flat"
                                f"{plan_note(eng5.fused_tables)})")

    off5, seg5 = eng5.glitch_offsets(aux5), eng5.consts["glitch_seg_index"]
    y5, rows5 = eng5._glitch_y0, eng5._glitch_rows
    if (y5, rows5) != (1512, 648):
        fail(f"c5 band is rows {y5}+{rows5}, expected 1512+648")
    kglitch.shear_planar_inplace(f5.clone(), y5, off5, seg5)  # the plan the row's launches take
    c5_note = glitch_plan_note()
    g5 = glitch_rows("glitch_shear_c5", f5, y5, off5, seg5, frames=C5_CLIPS * B, res=(H4, W4),
                     note=f" (c5: band {y5}+{rows5}, in place, {C5_CLIPS} clips x {B} frames "
                          f"flat; {c5_note}; the kernel's device time: [6])")
    glitch_device["glitch_shear_c5"] = (C5_CLIPS * B, (C5_CLIPS * B, 3, H4, W4), y5, off5, seg5,
                                        True)
    del f5

    # the text after the effects (csrc/text.cu) on the grid each route's
    # engine picks: the box grid at c5.batch's call, 16 of these 4K frames
    # (the fused emit, sheared) with c5's caption; the whole-frame grid on
    # c3-angled's warp emit at 1080p. Bit for bit the twin (torch ops over
    # the box) and composite_text over the whole batch (the torch ops stage
    # 13 ran before the kernel, the library call); the bound from the bytes
    # the grid reads and writes
    text_device = {}  # row -> (frames, batch shape, crops, whole, alpha, rgb), for [6]

    def text_row(kname, eng, feed, grid, note):
        tb, (alpha, rgb) = eng._text_crops, eng._text
        if eng.text_route != "after" or eng.text_grid != grid:
            fail(f"{kname}: text route {eng.text_route}, grid {eng.text_grid}; expected after, "
                 f"{grid}")
        whole = grid == "whole"
        n0 = ktext.launches
        got = ktext.composite_after(feed.clone(), tb, whole)
        torch.cuda.synchronize()
        if ktext.launches != n0 + 1:
            fail(f"{kname}: {ktext.launches - n0} text_after_kernel launches for one call")
        plan = ktext.last_plan
        b, _, h, w = feed.shape
        y0, y1, x0, x1 = tb.box
        values = b * 3 * (h * w if whole else (y1 - y0) * (x1 - x0))
        work = feed.clone()
        row(kname, "pythoncrt_tpu_torch/csrc/text.cu", "pythoncrt_tpu/engine.py:1238 (XLA ops)",
            lambda: ktext.composite_after(feed.clone(), tb, whole),
            lambda: ktext.composite_box_ref(feed.clone(), tb, whole),
            functools.partial(ocolor.composite_text, feed, alpha, rgb),
            more=[(got, ocolor.composite_text(feed, alpha, rgb))],
            timed=(functools.partial(ktext.composite_after, work, tb, whole),
                   functools.partial(ktext.composite_box_ref, work, tb, whole)),
            work=(2 * 4 * values + nbytes(tb.alpha, tb.rgb), values), tol=0.0, frames=b,
            res=(h, w), note=f" ({note}; {grid} grid, box {tb.box}; plan: "
                             f"{'16-byte' if plan.vec else 'scalar'} batch accesses, "
                             f"{'16-byte' if plan.cvec else 'scalar'} crop loads, {plan.tx} "
                             f"threads a row; library: composite_text over the whole batch; the "
                             f"kernel's device time: [6])")
        text_device[kname] = (b, tuple(feed.shape), tb, whole, alpha, rgb)
        del got, work

    ov5 = np.zeros((H4, W4, 4), np.uint8)
    ty0, ty1, tx0, tx1 = C5_CAPTION
    cap5 = np.random.default_rng(5).integers(0, 256, (ty1 - ty0, tx1 - tx0, 4), dtype=np.uint8)
    cap5[0, 0, 3] = cap5[-1, -1, 3] = 255  # the caption's corners pin its box
    ov5[ty0:ty1, tx0:tx1] = cap5
    eng5t = CRTEngine(configs["c5-text"], H4, W4, FPS, layout="planar", channel_order="gbr",
                      device=dev, text_rgba=ov5)
    if eng5t._text_crops.box != C5_CAPTION:
        fail(f"c5's caption box is {eng5t._text_crops.box}, expected {C5_CAPTION}")
    text_row("text_after_c5", eng5t, g5[:16].clone(), "box", "c5.batch's call: 16 frames of "
             "c5's fused emit, sheared, and its caption")
    del eng5t, ov5, cap5
    eng3t = CRTEngine(configs["c3-angled"], H, W, FPS, layout="planar", channel_order="gbr",
                      device=dev, text_rgba=ov_synth)
    if not (eng3t._staged and eng3t.params.warp_on):
        fail("c3-angled does not take the staged step and the warp")
    x3 = torch.randint(0, 256, (B, 3, H, W), generator=gen, device=dev, dtype=torch.uint8)
    feed3 = kwarp.warp_planar(eng3t._staged_stages(x3, eng3t.upload(eng3t.make_aux(
        np.arange(B)))), eng3t.warp_tables, emit_u8=False)
    text_row("text_after_c3_angled", eng3t, feed3, "whole", "c3-angled: the staged step, then "
             "the warp's unclamped f32 emit, with its text after the warp")
    del eng3t, x3, feed3

    imgs5 = eng5._effects(x5, aux5)
    if not torch.equal(imgs5, g5):
        fail("c5's effects differ from the fused kernel then the glitch shear")
    del x5, g5, kw5
    states5 = torch.rand((C5_CLIPS, 3, H4, W4), generator=gen, device=dev)
    p5 = configs["c5"].persistence
    row("persistence_scan_multiclip", *PERSIST_CU[:1], "pythoncrt_tpu/kernels/persist.py:90",
        functools.partial(kpersist.persistence_scan, imgs5, None, False, p5, emit_u8=True,
                          clip_states=states5),
        functools.partial(kpersist.persistence_scan_ref, imgs5, None, False, p5, emit_u8=True,
                          clip_states=states5),
        ops=(imgs5, states5), tol=0.0, twin_iters=2, frames=C5_CLIPS * B, res=(H4, W4),
        more=[(kpersist.persistence_scan(imgs5, None, True, p5, emit_u8=True,
                                         clip_states=states5),
               kpersist.persistence_scan_ref(imgs5, None, True, p5, emit_u8=True,
                                             clip_states=states5))],
        note=f" (c5: {C5_CLIPS} clips x {B} frames, stream head and carried states)")
    del imgs5, states5, eng5
    torch.cuda.empty_cache()

    # the GUI preview's kernels at its shapes: one frame at 960x540 (the
    # fit of a 1080p source), the preview engine (host rng and the
    # time-seeded grain, the preview glitch, persistence zeroed: the
    # preview blends on the host), addressed by time
    ph_, pw_ = PREVIEW_HW
    xp = torch.from_numpy(np.ascontiguousarray(
        synth(1, ph_, pw_, seed=8).transpose(0, 3, 1, 2))).to(dev)
    ov_p, t_p = synth_overlay(ph_, pw_, seed=4), 0.4567
    on_preview = dict(frames=1, res=PREVIEW_HW)

    def preview_step(cfg):
        """A preview engine of cfg and the per-frame inputs of one tick."""
        p = dataclasses.replace(configs[cfg], persistence=0.0)
        eng = CRTEngine(p, ph_, pw_, PREVIEW_FPS, engine="preview", rng="host", device=dev,
                        text_rgba=ov_p if p.text.enabled else None)
        noise = (np.random.default_rng(int(t_p * 1000)).standard_normal(
            eng._grain_hw, dtype=np.float32)[None] if p.noise_on else None)
        return eng, eng.make_aux_at([t_p], noise)

    def preview_note(note):
        return f"{note}; the GUI preview: one frame, addressed by time"

    for cfg, kname in (("defaults", "fused_pipeline_preview"),
                       ("c3", "fused_pipeline_gaussian_preview"),
                       ("c4-text", "fused_pipeline_text_preview")):
        eng, aux = preview_step(cfg)
        feed = xp if eng.spec.pre else eng._pre_bloom(xp)
        fz = fused_row(kname, eng, feed, kw=eng.fused_operands(aux), **on_preview,
                       note=preview_note(f" ({cfg} spec, {'fast' if eng.spec.fast else 'gaussian'}"
                                         f" core{plan_note(eng.fused_tables)})"))
        if cfg == "c3":  # the warp on c3's fused output, as the preview step runs it
            tabs = eng.warp_tables
            row("warp_planar_preview", *WARP_CU,
                functools.partial(kwarp.warp_planar, fz, tabs, emit_u8=eng._warp_u8),
                functools.partial(kwarp.warp_planar_ref, fz, tabs, emit_u8=eng._warp_u8),
                functools.partial(torch.nn.functional.grid_sample, fz,
                                  warp_grid(ph_, pw_, C3["warp_strength"], 1, dev),
                                  mode="bilinear", padding_mode="zeros", align_corners=True),
                ops=(fz, *tabs), tol=0.0, lsb_tol=0, **on_preview,
                note=preview_note(f" (c3, {'uint8' if eng._warp_u8 else 'f32'} emit)"))
    eng, aux = preview_step("c4")
    fz = kfused.fused_pipeline(xp, eng.spec, eng.fused_tables, **eng.fused_operands(aux))
    off, seg = eng.glitch_offsets(aux), eng.consts["glitch_seg_index"]
    y0, rows = eng._glitch_y0, eng._glitch_rows
    band, work = fz[:, :, y0:].contiguous(), fz.clone()
    kglitch.shear_planar_inplace(fz.clone(), y0, off, seg)  # the plan the row's launches take
    pv_note = glitch_plan_note()
    row("glitch_shear_preview", *GLITCH_CU,
        lambda: kglitch.shear_planar_inplace(fz.clone(), y0, off, seg)[:, :, y0:],
        functools.partial(kglitch.shear_planar_ref, band, off, seg),
        functools.partial(torch.gather, band, 3, torch.remainder(
            torch.arange(pw_, device=dev) + off.long()[:, :, seg.long()], pw_)[:, None].expand(
                1, 3, rows, pw_).contiguous()),
        ops=(band, off, seg), tol=0.0, lsb_tol=0, **on_preview,
        timed=(functools.partial(kglitch.shear_planar_inplace, work, y0, off, seg),
               functools.partial(kglitch.shear_planar_ref, band, off, seg)),
        note=preview_note(f" (c4 band {y0}+{rows}, the preview's one offset per row, in place; "
                          f"{pv_note}; the kernel's device time: [6])"))
    glitch_device["glitch_shear_preview"] = (1, (1, 3, ph_, pw_), y0, off, seg, True)
    for cfg, kname in (("c3-angled", "bloom3_planar_preview"),
                       ("defaults-angled", "bloom3_fast_planar_preview")):
        eng, _ = preview_step(cfg)
        feed, spec = eng._pre_bloom(xp), eng.bloom3_spec
        if spec.fast:
            tabs = eng.bloom3_tables
            row(kname, WALK_CU, "pythoncrt_tpu/kernels/bloom3.py:495",
                functools.partial(kbloom3.bloom3_fast_planar, feed, spec, tabs),
                functools.partial(kbloom3.bloom3_fast_planar_ref, feed, spec, tabs),
                ops=(feed, *tabs.taps), tol=0.0, lsb_tol=0, **on_preview,
                note=preview_note(f" ({cfg}: the staged step's stand-alone bloom)"))
        else:
            row(kname, WALK_CU, "pythoncrt_tpu/kernels/bloom3.py:274",
                functools.partial(kbloom3.bloom3_planar, feed, spec),
                functools.partial(kbloom3.bloom3_planar_ref, feed, spec), ops=(feed,), tol=0.0,
                lsb_tol=0, **on_preview,
                note=preview_note(f" ({cfg}: the staged step's stand-alone bloom)"))
    del xp, fz, band, work, feed
    torch.cuda.empty_cache()

    # ---- 4. end to end against the oracle ----
    def oracle_stream(eng, clip, idx, ov=None):
        """The oracle's frames for absolute indices idx of one stream."""
        p, aux = eng.params, eng.make_aux(idx)
        prev, want = None, []
        for j in range(len(idx)):
            img = oracle.apply_effects(clip[j], p, phase_px=float(aux.phase[j]),
                                       time_sec=idx[j] / FPS, noise_field=aux.noise[j],
                                       text_rgba=ov)
            prev = oracle.persistence_blend(prev, img, p.persistence if p.persistence_on else 0.0)
            want.append(oracle.ops.to_uint8(prev))
        return np.stack(want)

    for cfg, n, nb in (("c3", 2, 1), ("defaults", 4, 2), ("c4", 4, 2), ("c3-angled", 2, 1),
                       ("defaults-angled", 4, 2), ("c4-text", 4, 2), ("c3-bloom2", 2, 1),
                       ("c3-stripe", 2, 1), ("defaults-bloom2", 4, 2), ("defaults-s11", 2, 1),
                       ("defaults-angled-s11", 2, 1), ("defaults-fast", 4, 2), ("c3-fast", 2, 1)):
        p = configs[cfg]
        clip = synth(n, H, W, seed=2)
        ov = ov_synth if p.text.enabled else None
        with optin_env(cfg):
            eng = CRTEngine(p, H, W, FPS, rng="host", device=dev, text_rgba=ov,
                            **PATH_KW.get(cfg, {}))
        outs, st = [], None
        for k in range(nb):
            idx = np.arange(k * n // nb, (k + 1) * n // nb)
            o, st = eng.process(clip[idx], idx, st)
            outs.append(o.cpu().numpy())
        got = np.concatenate(outs)
        aux = eng.make_aux(np.arange(n))
        d = np.abs(got.astype(np.int32)
                   - oracle_stream(eng, clip, np.arange(n), ov).astype(np.int32))
        frac = (d > 0).mean()
        print(f"[4] engine vs oracle, {cfg} ({eng.bloom_route} bloom), {n} frames {H}x{W} in "
              f"{nb} batch(es), state carried: max {d.max()} LSB, {frac:.3e} of values off, "
              f"mean {d.mean():.4f} LSB", flush=True)
        if got.shape != (n, H, W, 3):
            fail(f"engine output of {cfg} has shape {got.shape}")
        if eng.precision == "fast":  # the direct-pow triad: the JAX test's documented bounds
            if d.max() > FAST_MAX_LSB or d.mean() > FAST_MEAN_LSB:
                fail(f"precision fast drifted from the oracle on {cfg}")
        elif d.max() > LSB_TOL or frac >= 1e-3:
            fail(f"engine disagrees with the oracle on {cfg}")
        if p.scanlines_on and not p.scanlines_1d:
            mask = eng._scanline_mask_2d(aux.phase).cpu().numpy()
            ref = np.stack([oracle.scanline_mask_2d(
                H, W, p.scanline_strength, p.scanline_period_px, float(ph), p.scanline_angle,
                p.scanline_thickness) for ph in aux.phase])
            dm = np.abs(mask - ref)
            print(f"[4] 2-D scanline mask vs the oracle's (NumPy f32 sin and pow), {cfg}: "
                  f"max {dm.max():.3g} abs, {(dm > 0).mean():.3e} of values differ", flush=True)
            if dm.max() > 1e-5:
                fail(f"2-D scanline mask of {cfg} is off the oracle's by {dm.max():.3g}")

    # c5: 4 clips x 8 frames in two steps of 4, each clip against its own
    # oracle stream (1080p keeps the NumPy oracle's time down)
    mc = MultiClipEngine(CRTEngine(configs["c5"], H, W, FPS, rng="host", device=dev))
    clips = np.stack([synth(8, H, W, seed=20 + c) for c in range(C5_CLIPS)])
    idx = np.tile(np.arange(8), (C5_CLIPS, 1)) + 8 * np.arange(C5_CLIPS)[:, None]
    o1, st = mc.process(clips[:, :4], idx[:, :4])
    o2, st = mc.process(clips[:, 4:], idx[:, 4:], st)
    got = torch.cat([o1, o2], 1).cpu().numpy()
    worst, frac = 0, 0.0
    for c in range(C5_CLIPS):
        d = np.abs(got[c].astype(np.int32)
                   - oracle_stream(mc.engine, clips[c], idx[c]).astype(np.int32))
        worst, frac = max(worst, int(d.max())), max(frac, float((d > 0).mean()))
    print(f"[4] MultiClipEngine vs oracle, c5 params, {C5_CLIPS} clips x 8 frames {H}x{W} in "
          f"two steps, each clip against its own stream: max {worst} LSB, at most {frac:.3e} "
          f"of a clip's values off", flush=True)
    if worst > LSB_TOL or frac >= 1e-3:
        fail("MultiClipEngine disagrees with the oracle on c5")
    del clips, got, o1, o2, mc

    # ---- 5. the main paths ----
    counters = {  # launch counter -> (module, attribute)
        "fused_pipeline": (kfused, "launches"), "warp_planar": (kwarp, "launches"),
        "persistence_scan": (kpersist, "launches"), "glitch_shear": (kglitch, "launches"),
        "text_after": (ktext, "launches"),
        "bloom3": (kbloom3, "launches"), "bloom2": (kbloom2, "launches"),
        "bloom": (kbloom, "launches"), "persistence_multiclip": (kpersist, "multiclip_launches"),
        "rng_grain": (krng, "grain_launches"), "rng_export": (krng, "export_launches"),
        "rng_preview": (krng, "preview_launches")}

    def zero_counts():
        for mod, attr in counters.values():
            setattr(mod, attr, 0)

    def read_counts():
        return {k: getattr(mod, attr) for k, (mod, attr) in counters.items()}

    def check_draws(pname, got, p, units, what):
        """One native draw launch per stream (the grain; the export glitch)
        for each of ``units`` engine steps: the path's batches, times its
        shards or clip devices."""
        want = {"rng_grain": units if p.noise_on else 0,
                "rng_export": units if p.glitch_on else 0, "rng_preview": 0}
        have = {k: got[k] for k in want}
        if have != want:
            fail(f"main path {pname}: native draw launches {have}, expected {want} for "
                 f"{units} {what}")
        print(f"[5] main path {pname}: the native draws launched once per stream for each of "
              f"{units} {what} ({have})", flush=True)

    paths = (  # name, flags, params, frames, kernels that must launch
        ("defaults", [], configs["defaults"], N_DECODE,
         ("fused_pipeline", "persistence_scan", "rng_grain")),
        ("c4", C4_FLAGS, configs["c4"], N_MAIN,
         ("fused_pipeline", "glitch_shear", "persistence_scan", "rng_grain", "rng_export")),
        ("c3", C3_FLAGS, configs["c3"], N_C3, ("fused_pipeline", "warp_planar", "rng_grain")),
        ("c3-angled", C3_ANGLED_FLAGS, configs["c3-angled"], N_C3,
         ("bloom3", "warp_planar", "text_after")),
        ("defaults-angled", DEF_ANGLED_FLAGS, configs["defaults-angled"], N_MAIN,
         ("bloom3", "persistence_scan")),
        ("c4-text", C4_TEXT_FLAGS, configs["c4-text"], N_MAIN,
         ("fused_pipeline", "glitch_shear", "persistence_scan", "rng_grain", "rng_export")),
        ("c3-bloom2", C3_FLAGS, configs["c3-bloom2"], N_C3, ("bloom2", "warp_planar")),
        ("defaults-bloom2", [], configs["defaults-bloom2"], N_MAIN,
         ("bloom2", "persistence_scan")),
        ("c3-stripe", C3_FLAGS, configs["c3-stripe"], N_C3, ("bloom", "warp_planar")),
        ("defaults-s11", S11_FLAGS, configs["defaults-s11"], N_MAIN,
         ("fused_pipeline", "persistence_scan")),
        # frames as wide as the aberration, in memory (no codec takes 8 columns)
        ("ab8-w8", None, configs["ab8-w8"], N_MAIN, ("fused_pipeline", "persistence_scan")),
        # the CLI defaults with the flags of this slice: the direct-pow triad,
        # the yuv420p pipe (the OpenCV tier without an ffmpeg binary), two
        # decode workers (frames checked against the defaults' below)
        ("defaults-fast", ["--precision", "fast"], configs["defaults-fast"], N_MAIN,
         ("fused_pipeline", "persistence_scan")),
        ("defaults-yuv420p", ["--pipe-format", "yuv420p"], configs["defaults"], N_MAIN,
         ("fused_pipeline", "persistence_scan")),
        ("defaults-decode2", ["--decode-workers", "2", "--steps-per-call", "2"],
         configs["defaults"], N_DECODE, ("fused_pipeline", "persistence_scan")),
    )
    captured = {}  # path -> the frames its writer was handed (CAPTURE paths)

    def size(pname):
        return (H, AB_W) if pname == "ab8-w8" else (H, W)

    def overlay(p):
        """The overlay a render of p composites: PIL's, or the synthetic one."""
        if not p.text.enabled:
            return None
        return ptext.overlay_for(W, H, p.text) if pil else ov_synth
    clip = synth(N_DECODE, H, W, seed=3)
    launches = {k: {} for k in counters}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        if cv2_ver:  # io.video.probe_clip reads clips through cv2
            for n in sorted({N_MAIN, N_C3, N_DECODE}):
                wr, _ = vio.open_writer(os.path.join(tmp, f"in{n}.mp4"), W, H, FPS)
                for f in clip[:n]:
                    wr.write_frame(f)
                wr.close()
        for pname, flags, p, n, needs in paths:
            zero_counts()
            text = ""
            if p.text.enabled:
                text = (f"; text rasterized by {pil}" if pil else
                        "; text: a seeded synthetic overlay (no PIL on this host)")
            if flags is not None and cv2_ver and (pil or not p.text.enabled):
                from pythoncrt_tpu_torch import cli

                outp = os.path.join(tmp, f"out_{pname}.mp4")
                t0 = time.perf_counter()
                with optin_env(pname), capture_writers(vio, pname in CAPTURE) as cap, \
                        record_readers(vio) as readers:
                    rc = cli.main(["--input", os.path.join(tmp, f"in{n}.mp4"), "--output", outp,
                                   *flags, "--batch-size", str(B), "--device", "cuda"])
                wall = time.perf_counter() - t0
                if pname in CAPTURE:
                    captured[pname] = np.stack(cap[outp])
                if rc != 0:
                    fail(f"cli.main ({pname}) exited {rc}")
                if pname == "defaults-decode2":
                    print(f"[5] {pname}: parallel readers (workers, chunks) {readers}", flush=True)
                    if [w for w, c in readers if w == 2 and c >= 2] != [2]:
                        fail(f"{pname} did not decode with two workers: {readers}")
                n_out = vio.probe_clip(outp).frame_count
                how = f"cli.main ({'ffmpeg' if ffmpeg else 'cv2'} codecs)"
            else:
                from pythoncrt_tpu_torch.pipeline import render_stream

                ph, pw = size(pname)
                wtr = MemWriter()
                t0 = time.perf_counter()
                with optin_env(pname):
                    eng_r = CRTEngine(p, ph, pw, FPS, device=dev, text_rgba=overlay(p),
                                      **PATH_KW.get(pname, {}))
                n_out = render_stream(MemReader(clip, n, ph, pw), wtr, eng_r, batch_size=B)
                wall = time.perf_counter() - t0
                out_arr = np.stack(wtr.frames)
                if not (out_arr.shape == (n, ph, pw, 3) and out_arr.std() > 0):
                    fail(f"render_stream ({pname}) output has the wrong shape or is constant")
                how = (f"render_stream ({pw}x{ph} in-memory frames, aberration "
                       f"{p.aberration_px}: the roll taken mod W)" if flags is None else
                       "render_stream (in-memory frames: no codec backend or no PIL)")
            got = read_counts()
            for k, v in got.items():
                launches[k][pname] = v
            print(f"[5] main path {pname}: {how}{text}; {n_out} frames out of {n}; launches "
                  f"{got}; {n / wall:.2f} fps wall (codecs included) on {card}", flush=True)
            if n_out != n:
                fail(f"main path {pname} wrote {n_out} frames, expected {n}")
            missing = [k for k in needs if got[k] < 1]
            if missing:
                fail(f"main path {pname}: kernels never launched: {missing}")
            if "rng_grain" in needs:
                check_draws(pname, got, p, -(-n // B), "batches")
        del clip
        if not cv2_ver:
            fail("the renders of this slice's flags need a codec backend (cv2); this host has none")
        same = np.array_equal(captured["defaults"], captured["defaults-decode2"])
        print(f"[5] --decode-workers 2 --steps-per-call 2 (two workers, two chunks of two "
              f"super-batches) vs one reader at the auto steps per call (one super-batch of "
              f"{N_DECODE}), the CLI defaults on {N_DECODE} frames: the frames handed to the "
              f"encoder are {'bit for bit equal' if same else 'DIFFERENT'}", flush=True)
        if not same:
            fail("--decode-workers 2 changed the frames")
        del captured

        # c4 with --segment-frames: a straight render, then a render that
        # fails once the first segment is committed and the second half
        # written, then the same call again, which resumes; the frames the
        # segment writers were handed are the straight render's
        from pythoncrt_tpu_torch.pipeline import process_video

        src, seg_out = os.path.join(tmp, f"in{N_MAIN}.mp4"), os.path.join(tmp, "c4_seg.mp4")
        straight_out = os.path.join(tmp, "c4_straight.mp4")
        seg_kw = dict(batch_size=B, device="cuda", report=False)
        runs = {}
        with capture_writers(vio) as cap:
            process_video(src, straight_out, configs["c4"], **seg_kw)
            for attempt in ("crash", "resume"):
                zero_counts()
                t0 = time.perf_counter()
                crashed = False
                try:
                    process_video(src, seg_out, configs["c4"], segment_frames=SEG_FRAMES,
                                  _fail_after_frames=SEG_CRASH if attempt == "crash" else 0,
                                  **seg_kw)
                except RuntimeError as e:
                    if "injected failure" not in str(e):
                        raise
                    crashed = True
                runs[attempt] = (read_counts(), crashed, time.perf_counter() - t0)
            straight = np.stack(cap[straight_out])
            segs = [np.stack(cap[k]) for k in sorted(cap) if os.sep + "seg-" in k]
        for attempt, (got, crashed, wall) in runs.items():
            for k, v in got.items():
                launches[k][f"c4-segments-{attempt}"] = v
            print(f"[5] main path c4 --segment-frames {SEG_FRAMES}, {attempt} "
                  f"({'failed as injected' if crashed else 'completed'}): launches {got}; "
                  f"{wall:.2f}s on {card}", flush=True)
            missing = [k for k in ("fused_pipeline", "glitch_shear", "persistence_scan")
                       if got[k] < 1]
            if missing or crashed != (attempt == "crash"):
                fail(f"c4 --segment-frames {attempt}: crashed {crashed}, never launched {missing}")
        resumed = runs["resume"][0]["fused_pipeline"] * B
        same = (len(segs) == N_MAIN // SEG_FRAMES
                and np.array_equal(np.concatenate(segs), straight))
        print(f"[5] c4 --segment-frames {SEG_FRAMES}: the resume rendered {resumed} of {N_MAIN} "
              f"frames; the segments' frames ({[len(x) for x in segs]}) are "
              f"{'bit for bit' if same else 'NOT'} the straight render's; the output holds "
              f"{vio.probe_clip(seg_out).frame_count} frames", flush=True)
        if not same or resumed != N_MAIN - SEG_FRAMES \
                or vio.probe_clip(seg_out).frame_count != N_MAIN:
            fail("the crash-resumed --segment-frames render differs from the straight one")
        del straight, segs, cap

        from pythoncrt_tpu_torch import cli, native

        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["--check-deps"])
        print(f"[5] --check-deps: exit {rc}: {' / '.join(buf.getvalue().strip().splitlines())}",
              flush=True)
        if rc != 0:
            fail(f"--check-deps exited {rc}")
        yuv = np.random.default_rng(6).integers(0, 256, W * H * 3 // 2, dtype=np.uint8).tobytes()
        native.yuv420p_to_rgb24(yuv, W, H)  # builds the C module at first use
        t0 = time.perf_counter()
        for _ in range(10):
            rgb = native.yuv420p_to_rgb24(yuv, W, H)
        conv_ms = (time.perf_counter() - t0) / 10 * 1e3
        same = np.array_equal(rgb, bt601(yuv, W, H))
        print(f"[5] yuv420p -> rgb24 on a {W}x{H} buffer ("
              f"{'the C module' if native.get() else 'the NumPy fallback: no C compiler'}): "
              f"{'equal to' if same else 'DIFFERENT from'} the NumPy BT.601 reference, "
              f"{conv_ms:.3f} ms per frame on the host's CPU; "
              + ("ffmpeg pipes it" if ffmpeg else "no ffmpeg binary on this host: nothing pipes "
                 "yuv420p here, and --pipe-format yuv420p decoded through the OpenCV tier"),
              flush=True)
        if not same:
            fail("the yuv420p converter disagrees with the BT.601 reference")

        # c5: a manifest of 4 clips at 3840x2160 through the CLI, the c4
        # flags, batch 8; then the same command resumes all 4
        if not cv2_ver:
            fail("c5: the manifest render needs a codec backend (cv2), and this host has none")
        t0 = time.perf_counter()
        jobs = []
        for c, n in enumerate(C5_LENGTHS):
            src = os.path.join(tmp, f"c5_in{c}.mp4")
            wr, _ = vio.open_writer(src, W4, H4, FPS)
            for f in synth(n, H4, W4, seed=50 + c):
                wr.write_frame(f)
            wr.close()
            jobs.append({"input": src, "output": os.path.join(tmp, f"c5_out{c}.mp4")})
        made = time.perf_counter() - t0
        manifest = os.path.join(tmp, "c5_jobs.json")
        with open(manifest, "w") as f:
            json.dump(jobs, f)
        from pythoncrt_tpu_torch import cli
        from pythoncrt_tpu_torch.multiclip import best_mesh_size

        argv = ["--batch-manifest", manifest, *C4_FLAGS, "--batch-size", str(B),
                "--device", "cuda"]
        for attempt in ("render", "resume"):
            zero_counts()
            buf = io.StringIO()
            t0 = time.perf_counter()
            with optin_env("c5"), contextlib.redirect_stdout(buf):
                rc = cli.main(argv)
            wall = time.perf_counter() - t0
            said = buf.getvalue().strip().splitlines()
            got = read_counts()
            if attempt == "render":
                for k, v in got.items():
                    launches[k]["c5"] = v
                counts = [vio.probe_clip(j["output"]).frame_count for j in jobs]
                print(f"[5] main path c5: cli.main --batch-manifest ({C5_CLIPS} clips "
                      f"{W4}x{H4}, cv2 mp4v: {made:.2f}s to write the sources), "
                      f"{sum(C5_LENGTHS) / wall:.2f} fps wall (codecs included), "
                      f"{said[-1] if said else 'no summary'}; frames out per clip {counts} of "
                      f"{list(C5_LENGTHS)}; launches {got} on {card}", flush=True)
                if rc != 0 or counts != list(C5_LENGTHS):
                    fail(f"c5 manifest render: exit {rc}, frames {counts}: {said[-4:]}")
                missing = [k for k in ("fused_pipeline", "glitch_shear", "persistence_multiclip",
                                       "rng_grain", "rng_export") if got[k] < 1]
                if missing:
                    fail(f"main path c5: kernels never launched: {missing}")
                # the clips in lockstep: one step per batch of the longest
                # clip, each on every clip device of the CLI's mesh
                check_draws("c5", got, configs["c5"],
                            -(-max(C5_LENGTHS) // B) * best_mesh_size(C5_CLIPS),
                            "steps x clip devices")
            else:
                print(f"[5] c5 again, the same command: {said[-1] if said else 'no summary'} "
                      f"in {wall:.2f}s", flush=True)
                if rc != 0 or f"({C5_CLIPS} resumed)" not in (said[-1] if said else ""):
                    fail(f"c5 resume: exit {rc}: {said[-4:]}")

        # the GUI slice: the live preview (gui_qt.render_preview_frame, the
        # window's call, stateful over N_TICKS ticks) against the
        # PCRT_PREVIEW_ENGINE=0 oracle path, timed per tick; the window's
        # export worker (run_render_job), compat.process_video and the
        # --gui guard. The window itself needs PySide6, which this host
        # lacks: it is tested under a stub on the CPU.
        from pythoncrt_tpu_torch import compat, gui, gui_qt

        if not pil:  # the preview rasterizes its overlay: a seeded one in its place
            gui_qt.overlay_for = lambda w, h, t: synth_overlay(h, w, 4) if t.enabled else None
        previews = [(cfg, (H, W)) for cfg in PREVIEW_CONFIGS]
        previews.append(("c3", PREVIEW_ODD))
        preview_needs = {"defaults": ("fused_pipeline",), "c3": ("fused_pipeline", "warp_planar"),
                         "c4": ("fused_pipeline", "glitch_shear"),
                         "c3-angled": ("bloom3", "warp_planar"), "defaults-angled": ("bloom3",),
                         "c4-text": ("fused_pipeline", "glitch_shear")}
        src = synth(N_TICKS, H, W, seed=9)
        # the window's clock, a Python float: t += 1 / fps of a 24 fps source (a NumPy
        # float64 time would turn the oracle's f32 phase math into f64)
        ticks = [k / FPS for k in range(N_TICKS)]
        gui_qt._PREVIEW_ENGINES.clear()
        os.environ.pop("PCRT_PREVIEW_ENGINE", None)
        first_ms, miss_ms, hit_ms = None, [], []

        def tick_run(p, frames_p, oracle_path):
            """(uint8 frames, ms per tick) of N_TICKS stateful ticks."""
            if oracle_path:
                os.environ["PCRT_PREVIEW_ENGINE"] = "0"
            outs, st, ms = [], None, []
            try:
                for k in range(N_TICKS):
                    t0 = time.perf_counter()
                    out, st = gui_qt.render_preview_frame(frames_p[k], p, ticks[k], prev_img=st,
                                                          stateful=True, device="cuda")
                    ms.append((time.perf_counter() - t0) * 1e3)
                    outs.append(out)
            finally:
                os.environ.pop("PCRT_PREVIEW_ENGINE", None)
            return np.stack(outs), ms

        for cfg, (sh, sw) in previews:
            p = configs[cfg]
            pw, ph = gui_qt._preview_size(sw, sh)
            pname = f"preview-{cfg}" + ("" if (sh, sw) == (H, W) else f"-{pw}")
            frames_p = np.ascontiguousarray(src[:, :sh, :sw])
            zero_counts()
            got, ms = tick_run(p, frames_p, False)
            counts = read_counts()
            for k, v in counts.items():
                launches[k][pname] = v
            want, oms = tick_run(p, frames_p, True)
            d = np.abs(got.astype(np.int32) - want.astype(np.int32))
            # the ticks that blend no uint8 frame: every tick without
            # persistence, the first tick with it
            plain = d if not p.persistence_on else d[:1]
            frac_plain = (plain > 0).mean()
            if first_ms is None:
                first_ms = ms[0]
            else:
                miss_ms.append(ms[0])
            hit_ms += ms[1:]
            print(f"[5] preview {pname}: {N_TICKS} stateful ticks of a {sw}x{sh} source at "
                  f"{pw}x{ph} (persistence {p.persistence}) vs the PCRT_PREVIEW_ENGINE=0 oracle "
                  f"path: max {d.max()} LSB, {(d > 0).mean():.3e} of values off "
                  f"({frac_plain:.3e} on the {len(plain)} unblended ticks), mean "
                  f"{d.mean():.4f} LSB; engine {np.median(ms[1:]):.3f} ms per tick (median of "
                  f"{N_TICKS - 1} cache hits; the first, with the engine's build, "
                  f"{ms[0]:.1f} ms), oracle {np.mean(oms):.1f} ms per tick; launches {counts} "
                  f"on {card}", flush=True)
            # the blended ticks (persistence on) carry the engine's uint8
            # frame into the host blend: 1 LSB, with no limit on the share off
            if got.shape != (N_TICKS, ph, pw, 3) or d.max() > LSB_TOL or frac_plain >= 1e-3:
                fail(f"preview {pname} disagrees with the oracle path: {got.shape}, "
                     f"max {d.max()} LSB, {frac_plain:.3e} of the unblended values off")
            missing = [k for k in preview_needs[cfg] if counts[k] < 1]
            if missing:
                fail(f"preview {pname}: kernels never launched: {missing}")
        # a persistence-slider move is a hit; a preset evicted from the LRU of
        # 4 (the defaults, 6 presets ago) builds again
        slider = dataclasses.replace(configs["c4"], persistence=0.3)
        n_eng = len(gui_qt._PREVIEW_ENGINES)
        t0 = time.perf_counter()
        gui_qt.render_preview_frame(src[0], slider, 0.5, device="cuda")
        slider_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        gui_qt.render_preview_frame(src[0], configs["defaults"], 0.5, device="cuda")
        evicted_ms = (time.perf_counter() - t0) * 1e3
        print(f"[5] preview ticks on {card}: first tick {first_ms:.1f} ms (the first engine "
              f"build of the process, the kernels' library already loaded); cache miss "
              f"(preset change: an engine build) median {np.median(miss_ms):.1f} ms "
              f"({min(miss_ms):.1f}-{max(miss_ms):.1f}); cache hit median "
              f"{np.median(hit_ms):.3f} ms ({min(hit_ms):.3f}-{max(hit_ms):.3f}), "
              f"{1e3 / np.median(hit_ms):.1f} ticks/s; persistence-slider move {slider_ms:.3f} "
              f"ms ({len(gui_qt._PREVIEW_ENGINES) - n_eng} engines built); an evicted preset "
              f"{evicted_ms:.1f} ms", flush=True)
        if len(gui_qt._PREVIEW_ENGINES) != n_eng:
            fail("a persistence-slider move built a preview engine")

        # the window's export: its worker's core with the kwargs CRTWindow
        # builds (c4 set in the window, batch 8), and the reference's
        # process_video through compat, the CLI defaults, on the card
        clip16 = os.path.join(tmp, f"in{N_C3}.mp4")
        for pname, needs in (("gui-export", ("fused_pipeline", "glitch_shear",
                                             "persistence_scan")),
                             ("compat", ("fused_pipeline", "persistence_scan"))):
            outp = os.path.join(tmp, f"out_{pname}.mp4")
            zero_counts()
            t0 = time.perf_counter()
            if pname == "gui-export":
                prog, done = [], []
                gui_qt.run_render_job(dict(
                    input_path=clip16, output_path=outp, params=configs["c4"], width=None,
                    height=None, fps=None, crf=18, target_bitrate_kbps=0, gpu=False,
                    nvenc_preset="p4", encoder_preference="auto", decoder_preference="auto",
                    batch_size=B, engine_mode="export", report=False, device="cuda"),
                    prog.append, lambda ok, msg: done.append((ok, msg)))
                ok = done and done[0][0] and prog and prog[-1] == 1.0
                how = f"gui_qt.run_render_job: done {done}, progress {len(prog)} updates"
            else:
                d = EffectParams()
                used = compat.process_video(
                    clip16, outp, None, None, d.scanline_strength, d.triad_strength,
                    d.triad_gamma, d.triad_preserve_luma, d.triad_softness, d.aberration_px,
                    d.bloom_sigma, d.bloom_strength, d.noise_strength, d.vignette_strength,
                    d.persistence, None, 18, 0, d.scanline_speed_px_s, d.scanline_period_px,
                    d.fast_bloom, d.pixel_size, False, "p4")
                ok = used is False
                how = "compat.process_video (the reference's signature, positional)"
            wall = time.perf_counter() - t0
            counts = read_counts()
            for k, v in counts.items():
                launches[k][pname] = v
            n_out = vio.probe_clip(outp).frame_count
            print(f"[5] {pname}: {how}; {n_out} frames out of {N_C3}; {N_C3 / wall:.2f} fps wall "
                  f"(codecs included); launches {counts} on {card}", flush=True)
            missing = [k for k in needs if counts[k] < 1]
            if not ok or n_out != N_C3 or missing:
                fail(f"{pname}: ok {ok}, {n_out} frames, never launched {missing}")
        if gui.qt_available():
            print("[5] --gui: PySide6 is installed here; the window is not opened (no display)")
        else:
            err = io.StringIO()
            with contextlib.redirect_stderr(err):
                rc = cli.main(["--gui"])
            said = err.getvalue().strip().splitlines()
            print(f"[5] --gui without PySide6: exit {rc}: {said[0] if said else ''}", flush=True)
            if rc != 3:
                fail(f"--gui without PySide6 exited {rc}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # ---- 5b. the multi-GPU slice: the sharded engines ----
    # Frame sharding (ShardedCRTEngine) and clip sharding (MultiClipEngine
    # over a clip mesh) on logical shards: several shards on cuda:0 run the
    # per-shard kernels, the carry rounds, the corrections and the gathers
    # of a mesh of cards (not its peer copies, second-card launches or
    # scaling). Each path's launches are counted from 0 over its own run;
    # the oracle reference runs after the count is read. The sharded and
    # multi-clip engines against the single engine: tests/test_torch_cuda.py.
    from pythoncrt_tpu_torch.parallel import CLIP_AXIS, DeviceMesh, ShardedCRTEngine, make_mesh
    from pythoncrt_tpu_torch.parallel import mesh as pmesh
    from pythoncrt_tpu_torch.pipeline import render_stream

    ncard = torch.cuda.device_count()
    shard_needs = {"c4": ("fused_pipeline", "glitch_shear", "persistence_scan", "rng_grain",
                          "rng_export"),
                   "defaults": ("fused_pipeline", "persistence_scan", "rng_grain"),
                   "c3": ("fused_pipeline", "warp_planar", "rng_grain")}
    # (config, mesh tag, mesh, layout): c4 planar gbr (the ffmpeg pipe's
    # layout), the defaults and c3 NHWC (the OpenCV pipe's)
    shard_runs = [(cfg, f"x{k}", DeviceMesh([torch.device("cuda", 0)] * k), lay)
                  for cfg, ks, lay in (("c4", (2, 4, 8), "planar"), ("defaults", (2, 4, 8), "nhwc"),
                                       ("c3", (4,), "nhwc"))
                  for k in ks]
    if ncard > 1:
        shard_runs += [(cfg, "cards", make_mesh(), lay) for cfg, lay in
                       (("c4", "planar"), ("defaults", "nhwc"), ("c3", "nhwc"))]
        print(f"[5] sharding: {ncard} cards visible: the sharded checks run on logical shards "
              f"of cuda:0 and on the {ncard} real cards", flush=True)
    else:
        print("[5] sharding: one card visible: only logical shards of cuda:0 ran; no peer copy, "
              "no launch on a second card and no scaling was measured", flush=True)
    oracle_ref = {}  # config -> (host-rng frames, the oracle's stream)

    def shard_lay(a, lay):
        """NHWC RGB frames (numpy or tensor) in the run's layout."""
        if lay == "nhwc":
            return a
        t = torch.as_tensor(a)
        return t.permute(0, 3, 1, 2)[:, [1, 2, 0]].contiguous()

    def to_rgb(a, lay):
        t = torch.as_tensor(a)
        return t if lay == "nhwc" else t[:, [2, 0, 1]].permute(0, 2, 3, 1)

    def timed_step(sh, x, idx, st):
        """One sharded step, its parts between CUDA events on cuda:0's
        stream (every logical shard's work is there): ms of the shards'
        effects and local scans, the carry rounds, the corrections and
        the gather."""
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        ev[0].record()
        xx, aux, s, first = sh._inputs(x[None], idx, st)
        local = sh._local(xx[0], pmesh._uploads(sh.mesh, sh._reps, aux))
        ev[1].record()
        if sh._persist:
            carries, ns = sh._carry(local, s, first)
            ev[2].record()
            outs = sh._correct(local, carries)
        else:
            outs, ns = [y for y, _ in local], local[-1][1]
            ev[2].record()
        ev[3].record()
        out = pmesh._gather(outs, sh.engine.layout == "nhwc", sh.engine.device)
        ns = sh._state_out(ns)
        ev[4].record()
        torch.cuda.synchronize()
        return out, ns, [ev[i].elapsed_time(ev[i + 1]) for i in range(4)]

    for cfg, tag, mesh, lay in shard_runs:
        pname = f"sharded-{cfg}-{tag}"
        p = configs[cfg]
        kw = dict(layout="planar", channel_order="gbr") if lay == "planar" else {}
        eng = CRTEngine(p, H, W, FPS, device=dev, **kw)
        g = torch.Generator(device=dev).manual_seed(11)
        x = torch.randint(0, 256, (2 * B, H, W, 3), generator=g, device=dev, dtype=torch.uint8)
        x = shard_lay(x, lay)
        sh = ShardedCRTEngine(eng, mesh)
        zero_counts()
        t0 = time.perf_counter()
        o1, s1 = sh.process(x[:B], np.arange(B))
        o2, s2 = sh.process(x[B:], np.arange(B, 2 * B), s1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = read_counts()
        for k, v in got.items():
            launches[k][pname] = v
        # per-batch times: 5 more stateful batches, sharded (by parts) and single
        parts, steps, singles = [], [], []
        st, st1 = s2, None
        for k in range(2, 7):
            idx = np.arange(k * B, (k + 1) * B)
            xb = x[(k % 2) * B:(k % 2 + 1) * B]
            t1 = time.perf_counter()
            _, st, ms = timed_step(sh, xb, idx, st)
            steps.append((time.perf_counter() - t1) * 1e3)
            parts.append(ms)
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            _, st1 = eng.process(xb, idx, st1)
            e1.record()
            torch.cuda.synchronize()
            singles.append(e0.elapsed_time(e1))
        med = np.median(np.array(parts), axis=0)
        print(f"[5] main path {pname} ({mesh.size} shards on {sorted({str(v) for v in mesh.devices})}, "
              f"{lay}, native rng, 2 batches of {B} at {W}x{H}): launches {got}; per batch (median "
              f"of 5, CUDA events on cuda:0) effects + local scans {med[0]:.4f} ms, carry rounds "
              f"{med[1]:.4f} ms, corrections {med[2]:.4f} ms, gather {med[3]:.4f} ms; sharded step "
              f"{np.median(steps):.4f} ms wall, single-device step {np.median(singles):.4f} ms "
              f"(events); first two batches {wall * 1e3:.1f} ms wall on {card}", flush=True)
        missing = [k for k in shard_needs[cfg] if got[k] < 1]
        if missing:
            fail(f"main path {pname}: kernels never launched: {missing}")
        check_draws(pname, got, p, 2 * mesh.size, "batches x shards")
        del x, o1, o2, sh, eng
        # host rng against the oracle, its stream computed once per config
        if cfg not in oracle_ref:
            clip = synth(2 * B, H, W, seed=12)
            eng_o = CRTEngine(p, H, W, FPS, rng="host", device=dev)
            oracle_ref[cfg] = clip, oracle_stream(eng_o, clip, np.arange(2 * B))
        clip, want = oracle_ref[cfg]
        engh = CRTEngine(p, H, W, FPS, rng="host", device=dev, **kw)
        shh = ShardedCRTEngine(engh, mesh)
        xc = shard_lay(clip, lay)
        h1, hs = shh.process(xc[:B], np.arange(B))
        h2, hs = shh.process(xc[B:], np.arange(B, 2 * B), hs)
        d = np.abs(to_rgb(torch.cat([h1, h2]), lay).cpu().numpy().astype(np.int32)
                   - want.astype(np.int32))
        print(f"[5] {pname} with host rng vs the oracle, {2 * B} frames in two batches: max "
              f"{int(d.max())} LSB, {float((d > 0).mean()):.3e} of values off", flush=True)
        if d.max() > LSB_TOL or (d > 0).mean() >= 1e-3:
            fail(f"{pname} disagrees with the oracle")
        del shh, engh, h1, h2
        torch.cuda.empty_cache()

    # clip sharding: c5 (4 clips x 8 frames at 3840x2160, two steps of 4)
    # over 2 and 4 logical devices
    eng5 = CRTEngine(configs["c5"], H4, W4, FPS, layout="planar", channel_order="gbr",
                     device=dev)
    x5 = torch.randint(0, 256, (C5_CLIPS, B, 3, H4, W4), generator=gen, device=dev,
                       dtype=torch.uint8)
    idx5 = np.tile(np.arange(B), (C5_CLIPS, 1)) + B * np.arange(C5_CLIPS)[:, None]
    half = B // 2
    clip_meshes = [(f"x{k}", DeviceMesh([torch.device("cuda", 0)] * k, CLIP_AXIS)) for k in (2, 4)]
    if ncard > 1:
        clip_meshes.append(("cards", make_mesh(best_mesh_size(C5_CLIPS), axis=CLIP_AXIS)))
    for tag, mesh in clip_meshes:
        pname = f"c5-clips-{tag}"
        mc = MultiClipEngine(eng5, mesh)
        zero_counts()
        t0 = time.perf_counter()
        _, st = mc.process(x5[:, :half], idx5[:, :half])
        mc.process(x5[:, half:], idx5[:, half:], st)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = read_counts()
        for k, v in got.items():
            launches[k][pname] = v
        print(f"[5] main path {pname}: MultiClipEngine over {mesh.size} devices "
              f"({sorted({str(v) for v in mesh.devices})}), c5 {C5_CLIPS} clips x {B} frames "
              f"{W4}x{H4} in two steps, native rng: launches {got}; {C5_CLIPS * B / wall:.2f} "
              f"frames/s wall over the two steps on {card}", flush=True)
        missing = [k for k in ("fused_pipeline", "glitch_shear", "persistence_multiclip",
                               "rng_grain", "rng_export") if got[k] < 1]
        if missing:
            fail(f"main path {pname}: kernels never launched: {missing}")
        check_draws(pname, got, configs["c5"], 2 * mesh.size, "steps x clip devices")
        del mc, st
    del x5, eng5
    torch.cuda.empty_cache()

    # the pipeline: render_stream over a 4-shard runner, c4, 19 frames at B = 8
    # (two sharded batches, then the 3-frame tail on the single-device engine)
    n19 = 19
    clip19 = synth(n19, H, W, seed=13)
    render_meshes = [("x4", DeviceMesh([torch.device("cuda", 0)] * 4))]
    if ncard > 1 and B % ncard == 0:
        render_meshes.append(("cards", make_mesh()))
    eng_r = CRTEngine(configs["c4"], H, W, FPS, device=dev)
    plain = MemWriter()
    render_stream(MemReader(clip19, n19, H, W), plain, eng_r, batch_size=B)
    for tag, mesh in render_meshes:
        pname = f"sharded-render-c4-{tag}"
        wtr = MemWriter()
        zero_counts()
        t0 = time.perf_counter()
        n_out = render_stream(MemReader(clip19, n19, H, W), wtr, eng_r, batch_size=B,
                              runner=ShardedCRTEngine(eng_r, mesh))
        wall = time.perf_counter() - t0
        got = read_counts()
        for k, v in got.items():
            launches[k][pname] = v
        d = np.abs(np.stack(wtr.frames).astype(np.int32) - np.stack(plain.frames).astype(np.int32))
        print(f"[5] main path {pname}: render_stream, {n_out} of {n19} frames at batch {B} "
              f"through a {mesh.size}-shard runner (the {n19 % B}-frame tail on the engine), "
              f"against the unsharded render: max {int(d.max())} LSB, "
              f"{float((d > 0).mean()):.3e} of values off; launches {got}; "
              f"{n19 / wall:.2f} fps wall on {card}", flush=True)
        if n_out != n19 or d.max() > LSB_TOL:
            fail(f"{pname}: {n_out} frames, {int(d.max())} LSB against the unsharded render")
        missing = [k for k in shard_needs["c4"] if got[k] < 1]
        if missing:
            fail(f"main path {pname}: kernels never launched: {missing}")
        # the full batches on the shards, the tail on the engine
        check_draws(pname, got, configs["c4"], n19 // B * mesh.size + bool(n19 % B),
                    "batches x shards, and the tail")
    del eng_r, plain, clip19
    torch.cuda.empty_cache()

    # ---- 5c. steps per call: super-batches on the main paths ----
    # Each path renders at its steps per call (the stack: full super-batches
    # through process_stack) and at 1, with the launches counted from 0 over
    # each run: the encoder's frames must be bit for bit the same, and so must
    # every kernel's launch count. process_stack calls are counted by a
    # wrapper around the engines' method, so a path that never filled a
    # super-batch fails.
    from pythoncrt_tpu_torch import cli
    from pythoncrt_tpu_torch import pipeline as tpipe
    from pythoncrt_tpu_torch.multiclip import auto_steps_per_call

    spc_auto = tpipe.resolve_steps_per_call(H, W, False, 0)
    spc_c5 = auto_steps_per_call(H4, W4, C5_CLIPS, B)

    @contextlib.contextmanager
    def count_stacks(cls):
        calls, real = [], cls.process_stack

        def spy(self, frames_stack, frame_indices, *a, **k):
            calls.append(int(np.asarray(frame_indices).shape[0]))
            return real(self, frames_stack, frame_indices, *a, **k)
        cls.process_stack = spy
        try:
            yield calls
        finally:
            cls.process_stack = real

    def spc_pair(pname, run, n, needs, n_stacks):
        """Run ``run(spc_tag)`` for the stack and for 1 step per call; check
        frames, launches and stacks; record the stack run's launches."""
        res = {}
        for tag in ("stack", "one"):
            zero_counts()
            t0 = time.perf_counter()
            with count_stacks(CRTEngine) as c1, count_stacks(ShardedCRTEngine) as c2, \
                    count_stacks(MultiClipEngine) as c3:
                frames = run(tag)
            res[tag] = (frames, read_counts(), time.perf_counter() - t0, c1 + c2 + c3)
        (fs, ls, ws, st), (f1, l1, w1, s1) = res["stack"], res["one"]
        for k, v in ls.items():
            launches[k][pname] = v
        same = fs == f1 if isinstance(fs, list) else np.array_equal(fs, f1)
        print(f"[5] main path {pname}: {n} frames; process_stack calls {st} (steps each); "
              f"frames {'bit for bit' if same else 'DIFFERENT from'} one step per call's; "
              f"launches {ls} against {l1} at one step per call; {n / ws:.2f} fps wall against "
              f"{n / w1:.2f} at one step per call (codecs included) on {card}", flush=True)
        if not same or ls != l1 or st != n_stacks or s1:
            fail(f"{pname}: frames equal {same}, launches {ls} vs {l1}, stacks {st} vs "
                 f"{n_stacks} (one step per call: {s1})")
        missing = [k for k in needs if ls[k] < 1]
        if missing:
            fail(f"main path {pname}: kernels never launched: {missing}")
        return ws, w1

    tmp = tempfile.mkdtemp(prefix="chip_smoke_spc_")
    try:
        clip = synth(N_SPC_AUTO, H, W, seed=3)
        for n in (N_SPC, N_SPC_AUTO):
            wr, _ = vio.open_writer(os.path.join(tmp, f"in{n}.mp4"), W, H, FPS)
            for f in clip[:n]:
                wr.write_frame(f)
            wr.close()
        spc_paths = (  # name, flags, steps per call (0: auto), frames, kernels, stacks
            ("defaults-spc2", [], 2, N_SPC, ("fused_pipeline", "persistence_scan"), [2, 2]),
            ("c4-spc2", C4_FLAGS, 2, N_SPC,
             ("fused_pipeline", "glitch_shear", "persistence_scan"), [2, 2]),
            ("c3-spc2", C3_FLAGS, 2, N_SPC, ("fused_pipeline", "warp_planar"), [2, 2]),
            ("defaults-spc-auto", [], 0, N_SPC_AUTO, ("fused_pipeline", "persistence_scan"),
             [spc_auto]))
        render_wall = {}
        for pname, flags, spc, n, needs, n_stacks in spc_paths:
            def run(tag, flags=flags, spc=spc, n=n, pname=pname):
                outp = os.path.join(tmp, f"out_{pname}_{tag}.mp4")
                with capture_writers(vio) as cap:
                    rc = cli.main(["--input", os.path.join(tmp, f"in{n}.mp4"), "--output", outp,
                                   *flags, "--steps-per-call", str(spc if tag == "stack" else 1),
                                   "--batch-size", str(B), "--device", "cuda"])
                if rc != 0 or vio.probe_clip(outp).frame_count != n:
                    fail(f"{pname} ({tag}): exit {rc}, {vio.probe_clip(outp).frame_count} frames")
                return np.stack(cap[outp])
            render_wall[pname] = spc_pair(pname, run, n, needs, n_stacks)
        ws, w1 = render_wall["defaults-spc-auto"]
        print(f"[5] render fps, wall (cli.main, cv2 codecs, {N_SPC_AUTO} frames {W}x{H} at batch "
              f"{B}), the CLI defaults: {N_SPC_AUTO / w1:.2f} at one step per call, "
              f"{N_SPC_AUTO / ws:.2f} at the auto {spc_auto} on {card}", flush=True)
        del clip

        # c4 through a runner of 4 logical shards of cuda:0, in memory
        clip = synth(N_SPC, H, W, seed=13)
        eng_s = CRTEngine(configs["c4"], H, W, FPS, device=dev)
        mesh4 = DeviceMesh([torch.device("cuda", 0)] * 4)

        def run_sharded(tag):
            wtr = MemWriter()
            got = render_stream(MemReader(clip, N_SPC, H, W), wtr, eng_s, batch_size=B,
                                steps_per_call=2 if tag == "stack" else 1,
                                runner=ShardedCRTEngine(eng_s, mesh4))
            if got != N_SPC:
                fail(f"sharded-render-c4-x4-spc2 ({tag}) rendered {got} frames")
            return np.stack(wtr.frames)
        spc_pair("sharded-render-c4-x4-spc2", run_sharded, N_SPC,
                 ("fused_pipeline", "glitch_shear", "persistence_scan"), [2, 2])
        del clip, eng_s

        # c5: a manifest of 4K clips of two super-batches or more at the auto
        # steps per call, the last clip ragged, frames compared by digest
        t0 = time.perf_counter()
        srcs = []
        for c, n in enumerate(C5_STACK_LENGTHS):
            srcs.append(os.path.join(tmp, f"c5s_in{c}.mp4"))
            wr, _ = vio.open_writer(srcs[-1], W4, H4, FPS)
            for f in synth(n, H4, W4, seed=70 + c):
                wr.write_frame(f)
            wr.close()
        made = time.perf_counter() - t0

        def run_c5(tag):
            jobs = [{"input": src, "output": os.path.join(tmp, f"c5s_{tag}{c}.mp4")}
                    for c, src in enumerate(srcs)]
            manifest = os.path.join(tmp, f"c5s_{tag}.json")
            with open(manifest, "w") as f:
                json.dump(jobs, f)
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf), capture_writers(vio, digest=True) as cap:
                rc = cli.main(["--batch-manifest", manifest, *C4_FLAGS, "--batch-size", str(B),
                               "--steps-per-call", "0" if tag == "stack" else "1",
                               "--batch-journal", "none", "--device", "cuda"])
            counts = [len(cap[j["output"]]) for j in jobs]
            if rc != 0 or counts != list(C5_STACK_LENGTHS):
                fail(f"c5-stacks ({tag}): exit {rc}, frames {counts}: "
                     f"{buf.getvalue().strip().splitlines()[-4:]}")
            return [d for j in jobs for d in cap[j["output"]]]
        rounds = min(C5_STACK_LENGTHS) // (spc_c5 * B)
        print(f"[5] c5-stacks: {C5_CLIPS} clips of {list(C5_STACK_LENGTHS)} frames {W4}x{H4} "
              f"(cv2 mp4v, {made:.2f}s to write the sources), auto steps per call "
              f"{spc_c5}; frames compared by SHA-1", flush=True)
        spc_pair("c5-stacks", run_c5, sum(C5_STACK_LENGTHS),
                 ("fused_pipeline", "glitch_shear", "persistence_multiclip"), [spc_c5] * rounds)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # pinned host memory of render_stream's two pools (tpipe.host_pool)
    frame_bytes = H * W * 3
    for b in (B, tpipe.DEFAULT_BATCH):
        held = {s: 2 * np.prod(tpipe.host_pool(b, s)) * frame_bytes for s in (1, spc_auto)}
        print(f"[5] pinned host bytes of render_stream at {W}x{H}, batch {b}: "
              f"{held[1]} at one step per call ({tpipe.host_pool(b, 1)[1]} buffers of {b} "
              f"frames per direction), {held[spc_auto]} at the auto {spc_auto} "
              f"({tpipe.host_pool(b, spc_auto)[1]} buffers of {b * spc_auto} frames)",
              flush=True)

    # ---- 6. results ----
    # JSON row -> (its launch counter, the paths whose runs it counts;
    # None: every path). Kernels that share a counter (the fused modes,
    # the bloom3 and bloom2 variants) count on their own paths only; the
    # single-stream persistence row leaves out c5's multi-clip launches.
    # the multi-GPU slice's paths (5b): frame shards, clip shards, the render
    tags = ("x2", "x4", "x8", "cards")
    sh_c4 = tuple(f"sharded-c4-{t}" for t in tags) + tuple(
        f"sharded-render-c4-{t}" for t in tags)
    sh_defaults = tuple(f"sharded-defaults-{t}" for t in tags)
    sh_c3 = tuple(f"sharded-c3-{t}" for t in tags)
    sh_c5 = tuple(f"c5-clips-{t}" for t in tags)
    # the steps-per-call paths (5c)
    spc_c4 = ("c4-spc2", "sharded-render-c4-x4-spc2")
    spc_defaults = ("defaults-spc2", "defaults-spc-auto")
    runs_on = {
        "fused_pipeline_gaussian": ("fused_pipeline", ("c3", "c3-spc2") + sh_c3),
        "fused_pipeline": ("fused_pipeline", ("defaults", "c4", "defaults-yuv420p",
                                              "defaults-decode2", "c4-segments-crash",
                                              "c4-segments-resume", "gui-export", "compat")
                           + sh_c4 + sh_defaults + spc_c4 + spc_defaults),
        "fused_pipeline_c5": ("fused_pipeline", ("c5", "c5-stacks") + sh_c5),
        "fused_pipeline_f32in": ("fused_pipeline", ()),
        "fused_pipeline_text": ("fused_pipeline", ("c4-text",)),
        "fused_pipeline_raw_grain": ("fused_pipeline", ()),  # the defaults at grain size 2
        "warp_planar": ("warp_planar", None),  # every path but the previews
        "warp_planar_strength1": ("warp_planar", ()),
        "persistence_scan": ("persistence_scan", ("defaults", "c4", "defaults-angled",
                                                  "c4-text", "defaults-bloom2", "defaults-fast",
                                                  "defaults-yuv420p", "defaults-decode2",
                                                  "c4-segments-crash", "c4-segments-resume",
                                                  "gui-export", "compat") + sh_c4 + sh_defaults
                             + spc_c4 + spc_defaults),
        "persistence_scan_multiclip": ("persistence_multiclip", ("c5", "c5-stacks") + sh_c5),
        "glitch_shear": ("glitch_shear", ("c4", "c4-text", "c4-segments-crash",
                                          "c4-segments-resume", "gui-export") + sh_c4 + spc_c4),
        "glitch_shear_c5": ("glitch_shear", ("c5", "c5-stacks") + sh_c5),
        "glitch_shear_band": ("glitch_shear", ()),
        # c5's caption after the effects runs in the benchmark's c5.batch,
        # on no path here; the whole-frame grid on every path with the text
        # after the warp
        "text_after_c5": ("text_after", ()),
        "text_after_c3_angled": ("text_after", None),
        "bloom3_planar": ("bloom3", ("c3-angled",)),
        "bloom3_fast_planar": ("bloom3", ("defaults-angled",)),
        "bloom2_planar": ("bloom2", ("c3-bloom2",)),
        "bloom2_planar_fast": ("bloom2", ("defaults-bloom2",)),
        "bloom2_planar_pipelined": ("bloom2", ()),
        "bloom_stripe": ("bloom", ("c3-stripe",)),
        "fused_pipeline_s11": ("fused_pipeline", ("defaults-s11",)),
        "fused_pipeline_s20": ("fused_pipeline", ()),
        "fused_pipeline_f32in_s11": ("fused_pipeline", ()),
        "fused_pipeline_direct": ("fused_pipeline", ("defaults-fast",)),
        "fused_pipeline_gaussian_direct": ("fused_pipeline", ()),
        "fused_pipeline_text_direct": ("fused_pipeline", ()),
        "fused_pipeline_s11_direct": ("fused_pipeline", ()),
        # the GUI preview, one frame per tick at 960x540 (853x480 for c3 too)
        "fused_pipeline_preview": ("fused_pipeline", ("preview-defaults", "preview-c4")),
        "fused_pipeline_gaussian_preview": ("fused_pipeline", ("preview-c3", "preview-c3-853")),
        "fused_pipeline_text_preview": ("fused_pipeline", ("preview-c4-text",)),
        "warp_planar_preview": ("warp_planar", ("preview-c3", "preview-c3-angled",
                                                "preview-c3-853")),
        "glitch_shear_preview": ("glitch_shear", ("preview-c4", "preview-c4-text")),
        "bloom3_planar_preview": ("bloom3", ("preview-c3-angled",)),
        "bloom3_fast_planar_preview": ("bloom3", ("preview-defaults-angled",)),
        # the native draws: a counter per entry; each row counts the paths of
        # its shape
        "rng_grain_normals": ("rng_grain", ("defaults", "c4", "c4-text", "defaults-yuv420p",
                                            "defaults-decode2", "defaults-angled",
                                            "defaults-bloom2", "defaults-s11", "defaults-fast",
                                            "c4-segments-crash", "c4-segments-resume",
                                            "gui-export", "compat")
                              + sh_c4 + sh_defaults + spc_c4 + spc_defaults),
        "rng_grain_normals_c3": ("rng_grain", ("c3", "c3-spc2", "c3-angled", "c3-bloom2",
                                               "c3-stripe") + sh_c3),
        "rng_grain_normals_c5": ("rng_grain", ("c5", "c5-stacks") + sh_c5),
        "rng_glitch_export_offsets": ("rng_export", ("c4", "c4-text", "c4-segments-crash",
                                                     "c4-segments-resume", "gui-export")
                                      + sh_c4 + spc_c4),
        "rng_glitch_export_offsets_c5": ("rng_export", ("c5", "c5-stacks") + sh_c5),
        "rng_glitch_preview_offsets": ("rng_preview", ()),
    }
    for tag in SIGMAS:  # the stand-alone routes at large radii: on no main path
        runs_on.update({f"{k}_{tag}": (c, ()) for k, c in (
            ("bloom3_planar", "bloom3"), ("bloom_stripe", "bloom"), ("bloom2_planar", "bloom2"))})
    for kname, entry in table.items():
        counter, on = runs_on[kname]
        by_path = {pn: v for pn, v in launches[counter].items()
                   if (pn in on if on is not None else not pn.startswith("preview-"))}
        entry["launches"], entry["launches_by_path"] = sum(by_path.values()), by_path
    # ---- 6. device time of the draws, the glitch and the text ----
    def device_line(kname, nb, run, lib, kernel, lib_name):
        """The row's kernel's device time per launch beside its library
        call's in one window (device_ms), and against its event time per
        wrapper call."""
        dev_ms, lib_dev = device_ms((run, kernel), (lib, None))
        entry = table[kname]
        entry.update(device_ms=dev_ms, library_device_ms=lib_dev)
        print(f"[6] {kname}: the kernel's device time {dev_ms:.4f} ms per launch "
              f"({dev_ms / nb:.4f} ms/frame; {100 * entry['bound_ms'] / dev_ms:.1f}% of the bound, "
              f"{entry.get('bound_kind', 'bytes')}), {lib_name} {lib_dev:.4f} ms in the same window "
              f"(torch.profiler; the kernel / the library call {dev_ms / lib_dev:.3f}); event time "
              f"per wrapper call {entry['ms']:.4f} ms (the library call {entry['library_ms']:.4f}), "
              f"so {max(0.0, entry['ms'] - dev_ms):.4f} ms of it the wrapper's host path and the "
              f"launch, on {card}", flush=True)

    for kname, (nb, shape, run_draw, kern) in draw_device.items():
        device_line(kname, nb, run_draw, functools.partial(torch.randn, shape, device=dev), kern,
                    f"torch.randn of {shape}")
    # the glitch rows on fresh frames of each row's shape and offsets, beside
    # torch.gather of the same band and index
    for kname, (nb, shape, y0, off, seg, inplace) in glitch_device.items():
        frames = torch.rand(shape, device=dev)
        band = frames[:, :, y0:].contiguous()
        gidx = torch.remainder(torch.arange(shape[3], device=dev) + off.long()[:, :, seg.long()],
                               shape[3])[:, None].expand(band.shape).contiguous()
        run = (functools.partial(kglitch.shear_planar_inplace, frames, y0, off, seg) if inplace
               else functools.partial(kglitch.shear_planar, band, off, seg))
        device_line(kname, nb, run, functools.partial(torch.gather, band, 3, gidx),
                    "glitch_kernel", "torch.gather of the band")
        del frames, band, gidx, run
    # the text rows on fresh frames in [0, 1) of each row's shape and grid,
    # beside composite_text over the whole batch
    for kname, (nb, shape, tb, whole, alpha, rgb) in text_device.items():
        frames = torch.rand(shape, device=dev)
        device_line(kname, nb, functools.partial(ktext.composite_after, frames, tb, whole),
                    functools.partial(ocolor.composite_text, frames, alpha, rgb),
                    "text_after_kernel", "composite_text over the whole batch")
        del frames
    torch.cuda.empty_cache()

    # ---- 7. the card tests, in a process of their own ----
    cmd = [sys.executable, "-m", "pytest", "--noconftest", "-m", "cuda",
           "tests/test_torch_cuda.py", "-q"]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
                         text=True, timeout=3600)
    said = res.stdout.strip().splitlines()
    print(f"[7] card tests ({' '.join(['python', *cmd[1:]])}): exit {res.returncode} in "
          f"{time.perf_counter() - t0:.1f}s: {said[-1] if said else 'no output'}", flush=True)
    if res.returncode != 0:
        print("\n".join(said[-80:]), res.stderr[-4000:], sep="\n", flush=True)
        fail(f"the card tests failed (exit {res.returncode})")
    print(f"card: {card}")
    print(card)
    print(json.dumps({"kernels": list(table.values())}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
