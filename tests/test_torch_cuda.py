"""The port's CUDA kernels against their plain PyTorch twins on a card.

Marked ``cuda``; they skip on hosts without a CUDA device. The file
imports no JAX, so on a machine without it run

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Operands are the ones the engine's step hands each kernel (c3, the CLI
defaults, c4 and variants; the angled-scanline and text paths), at small
shapes (an odd one included) and at 1080p. Both sides keep one f32 op
order (the kernels build with -fmad=false and round pow once from
double, as the twins do), so fused f32 outputs agree to 2e-6 and uint8
outputs to 1 LSB; the stand-alone blooms' row walk (csrc/bloom_walk.cu:
bloom3's gaussian and fast bloom, the stripe, bloom2), the warp, the
persistence scan (its multi-clip mode too) and the glitch shear (also at
the GUI preview's B = 1, c5's width, offsets of +-3W, a frame base off 16
bytes and a row past 48 KB of shared memory) are bitwise, and so is the fused kernel past radius 31 (its register-blocked
tap loops; both inputs, both triads). The fused kernel's direct-pow
triad (``--precision fast``, triad_mode 3) is held to the same 2e-6 /
1 LSB in every instantiation
(gaussian at r = 4, a runtime radius and past 31; fast; f32 input) and
the split route, and the whole step with it to the CPU step; its three
pow sites (csrc/triad_pow.cuh: f32 fast paths, a rounding test, an FP64
fallback) bit for bit the FP64 expressions on 2^24 seeded inputs per site
and gamma, and on crafted inputs next to f32 rounding midpoints and the
subnormal boundaries, each of which takes the fallback. The GUI
preview's engine call (process_at, one frame at 960x540 and 853x480) is
held to the CPU step within 1 LSB. The frame-sharded engine over 2, 4
and 8 logical shards of cuda:0 (at 1080p too: c4 planar gbr, the CLI
defaults NHWC, c3 over 4), and over every visible card (skipped on a
one-card host), is held to the single-device engine: 0 LSB without
persistence, else 1 LSB and the state within 1e-4. The multi-clip engine
is bit for bit single-clip runs (c5 at 3840x2160 too) and, over 2 and 4
logical clip devices, the engine on one device. process_stack of
CRTEngine, of a 2-shard ShardedCRTEngine and of MultiClipEngine, into the
caller's ``out``, is bit for bit its process() loop. The native draws
(csrc/rng.cu: the grain field, the export and preview glitch offsets, one
launch per batch) are bit for bit their twin at the engine's shapes and at
edge shapes (rows 1, 15, 16, 17, 324 and 648; 1 and 120 segments; batches
1 and 9), and invariant to the batch split; their Box-Muller fast path
(csrc/box_muller.cuh) stays inside the bounds its rounding test assumes on
words next to its domains' edges (csrc/rng_sweep.cu); the fused kernel's raw-grain mode (grain
size above 1: the raw field upsampled in the kernel) is bit for bit the
kernel fed the twin's upsampled field, in every instantiation (each core,
both inputs, both triads) at grain sizes 2, 3 and 5 and with a raw field
one row or one column wide. The fused kernel's text mode (TEXT: the
overlay composited in the uint8 prologue over its box) is held to its
twin and to the bits of the f32-input mode fed the torch ops' stages 1-5,
in every instantiation, and the instantiations without it to the SASS
they had before it was added. The text after the effects (csrc/text.cu,
both grids) is ops/color.composite_text bit for bit at boxes on each
edge, on the engine's feeds (c5's 4K fused f32 emit, the warp's, the
staged step's), and a multi-clip c5 step is the benchmark's plain
reference bit for bit."""

import dataclasses

import numpy as np
import pytest
import torch

from pythoncrt_tpu_torch import CRTEngine, MultiClipEngine, TextParams
from pythoncrt_tpu_torch.kernels import bloom as kbloom
from pythoncrt_tpu_torch.kernels import bloom2 as kbloom2
from pythoncrt_tpu_torch.kernels import bloom3 as kbloom3
from pythoncrt_tpu_torch.kernels import fused as kfused
from pythoncrt_tpu_torch.kernels import glitch as kglitch
from pythoncrt_tpu_torch.kernels import persist as kpersist
from pythoncrt_tpu_torch.kernels import rng as krng
from pythoncrt_tpu_torch.kernels import text as ktext
from pythoncrt_tpu_torch.kernels import triad as ktriad
from pythoncrt_tpu_torch.kernels import warp as kwarp
from pythoncrt_tpu_torch.ops import color as ocolor
from pythoncrt_tpu_torch.params import EffectParams

C3 = dict(scanline_strength=0.6, triad_strength=0.35, triad_softness=0.5,
          aberration_px=1, bloom_sigma=1.2, bloom_strength=0.25, fast_bloom=False,
          noise_strength=1.5, vignette_strength=0.25, persistence=0.0, pixel_size=2,
          grain_size=2, warp_strength=0.15, flicker_strength=0.2, flicker_hz=2.0,
          brightness=0.02, contrast=1.05, gamma=1.1, saturation=0.9, temperature=0.1)
VARIANTS = {
    "c3": C3,
    "c3_gbr": C3,
    "luma_knee_px3": {**C3, "triad_preserve_luma": True, "bloom_threshold": 0.3,
                      "pixel_size": 3, "warp_strength": -0.5},
    "bloom_off_no_warp": {**C3, "bloom_strength": 0.0, "warp_strength": 0.0},
    "wide_bloom": {**C3, "bloom_sigma": 4.0},
    "defaults": {},
    "c4": dict(scanline_strength=0.6, triad_strength=0.35, aberration_px=1,
               bloom_strength=0.25, fast_bloom=True, noise_strength=1.5,
               vignette_strength=0.25, persistence=0.6, pixel_size=1, glitch_amp_px=6,
               glitch_height_frac=0.3, scanline_speed_px_s=120.0),
    "fast_knee_px3": {"bloom_threshold": 0.35, "pixel_size": 3, "grain_size": 2},
    "r31": {**C3, "bloom_sigma": 10.3},
    "ab_neg2_px3": {"aberration_px": -2, "pixel_size": 3},
    # above the 63 taps of the launch arguments: taps from a device table
    "s11": {**C3, "bloom_sigma": 11.0},
    "s20_knee": {**C3, "bloom_sigma": 20.0, "bloom_threshold": 0.3},
}
SHAPES = [(2, 48, 200), (2, 45, 251), (8, 1080, 1920)]
SHAPE_IDS = ["small", "odd", "1080p"]
# the fused kernel's walk at its edges: a frame smaller than the ring (H <
# 2r + 1, one row, one column), a width that is no multiple of the strip or
# of 4, and c5's flat batch of 4 clips x 8 frames at 3840x2160
FUSED_SHAPES = SHAPES + [(1, 7, 9), (1, 1, 300), (2, 40, 1), (2, 5, 200), (2, 33, 130),
                         (32, 2160, 3840)]
FUSED_IDS = SHAPE_IDS + ["tiny", "row", "column", "short", "ragged_strip", "c5_4k"]


@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: run on the card (README)")
    return torch.device("cuda")


def engine(name, h, w, dev):
    kw = dict(layout="planar", channel_order="gbr") if name.endswith("_gbr") else {}
    return CRTEngine(EffectParams(**VARIANTS[name]), h, w, 24.0, rng="host", device=dev, **kw)


def assert_fused_close(got, twin, b, u8):
    """The kernel's output against its twin, 8 frames at a time (the twin's
    intermediates at 4K): f32 within 2e-6, uint8 within 1 LSB on fewer
    than 1e-3 of values."""
    for k in range(0, b, 8):
        want = twin(k, min(k + 8, b))
        part = got[k:k + 8]
        if u8:
            d = (part.int() - want.int()).abs()
            assert d.max().item() <= 1 and (d > 0).float().mean().item() < 1e-3
        else:
            assert (part - want).abs().max().item() <= 2e-6


PER_FRAME = ("grain", "sl", "flicker")  # fused operands with one entry per frame


def frames(b, h, w, dev):
    g = torch.Generator(device=dev).manual_seed(5)
    return torch.randint(0, 256, (b, 3, h, w), generator=g, device=dev, dtype=torch.uint8)


def f32_input(eng):
    """The fused kernel's f32-input mode (pre=False) for an engine's spec:
    the spec and consts of the kernel fed ``eng._pre_bloom``'s f32 image
    (stages 1-5, the text before the bloom composited by torch ops). The
    engine's step composites that text in the kernel's prologue instead
    (its spec's text box); the text operands are not read here."""
    spec = dataclasses.replace(eng.spec, pre=False, text_box=())
    t = eng.fused_tables
    return spec, kfused.fused_consts(spec, eng.device, t.y_map, t.x_maps)


# the text composited in the fused kernel's prologue (TEXT): boxes
# (fractions of H and W) inside the frame, touching each of its edges and
# covering it, a clear overlay (no box), and a box whose alpha is 255
# throughout or 0 inside its border; "seeded" alphas hold 0 and 255 too
TEXT_BOXES = {"inner": (0.2, 0.5, 0.1, 0.33), "top": (0.0, 0.25, 0.25, 0.5),
              "bottom": (0.75, 1.0, 0.33, 0.67), "left": (0.17, 0.67, 0.0, 0.17),
              "right": (0.25, 0.75, 0.8, 1.0), "whole": (0.0, 1.0, 0.0, 1.0), "clear": None,
              "opaque": (0.2, 0.5, 0.1, 0.33), "hollow": (0.2, 0.5, 0.1, 0.33)}


def text_overlay(h, w, box, seed=4):
    """An (H, W, 4) uint8 overlay for the TEXT_BOXES entry ``box`` and
    the (y0, y1, x0, x1) its alpha covers (() when clear)."""
    ov = np.zeros((h, w, 4), np.uint8)
    frac = TEXT_BOXES[box]
    if frac is None:
        return ov, ()
    rng = np.random.default_rng(seed)
    y0, y1 = int(frac[0] * h), max(int(frac[1] * h), int(frac[0] * h) + 1)
    x0, x1 = int(frac[2] * w), max(int(frac[3] * w), int(frac[2] * w) + 1)
    bh, bw = y1 - y0, x1 - x0
    a = rng.integers(0, 256, (bh, bw))
    a[rng.random((bh, bw)) < 0.25] = 0
    a[rng.random((bh, bw)) < 0.25] = 255
    if box == "opaque":
        a[:] = 255
    elif box == "hollow":
        a[1:-1, 1:-1] = 0
    a[0, 0] = a[-1, -1] = 255  # the box is the bounding box of the alpha
    ov[y0:y1, x0:x1, :3] = rng.integers(0, 256, (bh, bw, 3))
    ov[y0:y1, x0:x1, 3] = a
    return ov, (y0, y1, x0, x1)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", FUSED_SHAPES, ids=FUSED_IDS)
@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_fused_kernel_matches_twin(cuda_dev, name, shape):
    b, h, w = shape
    eng = engine(name, h, w, cuda_dev)
    x = frames(b, h, w, cuda_dev)
    kw = eng.fused_operands(eng.make_aux(np.arange(b)))
    n0 = kfused.launches
    got = kfused.fused_pipeline(x, eng.spec, eng.fused_tables, **kw)
    torch.cuda.synchronize()
    assert kfused.launches == n0 + 1

    def twin(i, j):
        return kfused.fused_pipeline_ref(
            x[i:j], eng.spec, eng.fused_tables,
            **{k: v[i:j] if k in PER_FRAME else v for k, v in kw.items()})
    assert_fused_close(got, twin, b, eng.spec.emit == "u8")


@pytest.mark.cuda
@pytest.mark.parametrize("w", range(1, 9))
@pytest.mark.parametrize("ab", [8, -8])
@pytest.mark.parametrize("name", ["c3", "defaults"])
def test_fused_kernel_takes_aberration_wider_than_the_frame(cuda_dev, name, ab, w):
    """Frames 1-8 columns wide with the aberration at its clamp: the roll
    is taken mod W, and the kernel's staged ranges hold the wrapped
    columns."""
    p = EffectParams(**{**VARIANTS[name], "aberration_px": ab})
    eng = CRTEngine(p, 16, w, 24.0, rng="host", device=cuda_dev)
    assert abs(eng.spec.ab) < w
    x = frames(2, 16, w, cuda_dev)
    kw = eng.fused_operands(eng.make_aux(np.arange(2)))
    got = kfused.fused_pipeline(x, eng.spec, eng.fused_tables, **kw)
    torch.cuda.synchronize()
    want = kfused.fused_pipeline_ref(x, eng.spec, eng.fused_tables, **kw)
    assert_fused_close(got, lambda i, j: want[i:j], 2, eng.spec.emit == "u8")


# the first radius that fits no strip at the smallest frame (uint8, f32
# input; tests/test_torch_fused_plan.py): the three-launch split route
SPLIT_R = {True: 13923, False: 13779}


@pytest.mark.cuda
@pytest.mark.parametrize("pre", [True, False, "text"])
def test_fused_split_route_matches_twin(cuda_dev, pre):
    text, pre = pre == "text", bool(pre)
    r = SPLIT_R[pre]
    spec = kfused.build_fused_spec(1, 1, sigma=r / 3, strength=0.6, threshold=0.2, px=1, ab=1,
                                   pre=pre, triad=True, scanlines=True, noise=True,
                                   noise_scale=0.01, emit="u8", corder=(1, 2, 0),
                                   text_box=(0, 1, 0, 1) if text else ())
    consts = kfused.fused_consts(spec, cuda_dev)
    assert consts.plan.split and spec.r == r
    g = torch.Generator(device=cuda_dev).manual_seed(17)
    x = (torch.randint(0, 256, (3, 3, 1, 1), generator=g, device=cuda_dev, dtype=torch.uint8)
         if pre else torch.rand((3, 3, 1, 1), generator=g, device=cuda_dev))
    kw = dict(grain=torch.randn((3, 1, 1), generator=g, device=cuda_dev),
              sl=torch.rand((3, 1), generator=g, device=cuda_dev),
              tri=torch.ones((3, 1), device=cuda_dev))
    if text:  # the prologue launch composites it
        kw.update(talpha=torch.rand((1, 1), generator=g, device=cuda_dev),
                  trgb=torch.rand((3, 1, 1), generator=g, device=cuda_dev))
    n0 = (kfused.launches, kbloom3.launches)
    got = kfused.fused_pipeline(x, spec, consts, **kw)
    torch.cuda.synchronize()
    assert (kfused.launches - n0[0], kbloom3.launches - n0[1]) == (2 if pre else 1, 1)
    want = kfused.fused_pipeline_ref(x, spec, consts, **kw)
    assert torch.equal(got, want)


# batches of 1, 3, 8 and 9 frames; one pixel, a row, W % 4 != 0 (scalar
# loads and stores), small frames and 1080p
WARP_SHAPES = [(1, 48, 200), (3, 45, 251), (8, 1080, 1920), (9, 1080, 1920), (9, 33, 130),
               (1, 1, 1), (3, 1, 300), (8, 20, 100)]
WARP_IDS = ["small", "odd", "1080p", "1080p_b9", "ragged_b9", "pixel", "row", "tiny"]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", WARP_SHAPES, ids=WARP_IDS)
@pytest.mark.parametrize("strength", [1.0, -1.0, 0.15, -0.5])
def test_warp_kernel_matches_twin(cuda_dev, shape, strength):
    """Both emits bit for bit the twin."""
    b, h, w = shape
    g = torch.Generator(device=cuda_dev).manual_seed(3)
    img = torch.rand((b, 3, h, w), generator=g, device=cuda_dev)
    tables = kwarp.build_warp_tables(h, w, strength, cuda_dev)
    n0 = kwarp.launches
    got = kwarp.warp_planar(img, tables)
    got8 = kwarp.warp_planar(img, tables, emit_u8=True)
    torch.cuda.synchronize()
    assert kwarp.launches == n0 + 2
    assert torch.equal(got, kwarp.warp_planar_ref(img, tables))
    assert torch.equal(got8, kwarp.warp_planar_ref(img, tables, emit_u8=True))


@pytest.mark.cuda
def test_wrappers_refuse_bad_operands(cuda_dev):
    eng = engine("c3", 48, 200, cuda_dev)
    kw = eng.fused_operands(eng.make_aux(np.arange(2)))
    x = frames(2, 48, 200, cuda_dev)
    with pytest.raises(ValueError):
        kfused.fused_pipeline(x.float(), eng.spec, eng.fused_tables, **kw)
    with pytest.raises(ValueError):
        kfused.fused_pipeline(x, eng.spec, eng.fused_tables, **{**kw, "sl": kw["sl"].cpu()})
    with pytest.raises(ValueError):
        kwarp.warp_planar(x, eng.warp_tables)


@pytest.mark.cuda
def test_engine_on_card_matches_engine_on_cpu(cuda_dev):
    """The whole step on the card (kernels) against the CPU step (twins)
    on the same frames and host-rng noise."""
    eng_gpu = engine("c3", 96, 320, cuda_dev)
    eng_cpu = engine("c3", 96, 320, "cpu")
    x = np.random.default_rng(1).integers(0, 256, (4, 96, 320, 3), dtype=np.uint8)
    got = eng_gpu.process(x, np.arange(10, 14))[0].cpu()
    want = eng_cpu.process(x, np.arange(10, 14))[0]
    d = (got.int() - want.int()).abs()
    assert d.max().item() <= 1 and (d > 0).float().mean().item() < 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES + [(3, 5, 7)], ids=SHAPE_IDS + ["ragged"])
@pytest.mark.parametrize("first", [True, False])
@pytest.mark.parametrize("emit_u8", [True, False])
def test_persist_kernel_matches_twin(cuda_dev, shape, first, emit_u8):
    """Bitwise, with the carry in registers over B frames; the ragged
    shape (3 * 5 * 7 values) takes the scalar path."""
    b, h, w = shape
    g = torch.Generator(device=cuda_dev).manual_seed(7)
    imgs = torch.rand((b, 3, h, w), generator=g, device=cuda_dev)
    state = torch.rand((3, h, w), generator=g, device=cuda_dev)
    n0 = kpersist.launches
    got, gs = kpersist.persistence_scan(imgs, state, first, 0.6, emit_u8=emit_u8)
    want, ws = kpersist.persistence_scan_ref(imgs, state, first, 0.6, emit_u8=emit_u8)
    torch.cuda.synchronize()
    assert kpersist.launches == n0 + 1
    assert got.dtype == want.dtype and torch.equal(got, want) and torch.equal(gs, ws)


# the glitch shear at the engine's shapes and at the GUI preview's B = 1
# (960x540, 162 band rows) and c5's width (3840, 120 segments), a few frames
GLITCH_SHAPES = SHAPES + [(1, 540, 960), (4, 2160, 3840)]
GLITCH_IDS = SHAPE_IDS + ["preview", "c5_width"]


def glitch_entries(imgs, y0, off, seg):
    """Both entries, each counted: (in place on a copy of the frames, out of
    place on a contiguous copy of the band)."""
    n0 = kglitch.launches
    got = kglitch.shear_planar_inplace(imgs.clone(), y0, off, seg)
    assert kglitch.launches == n0 + 1
    band = kglitch.shear_planar(imgs[:, :, y0:].contiguous(), off, seg)
    assert kglitch.launches == n0 + 2
    torch.cuda.synchronize()
    return got, band


@pytest.mark.cuda
@pytest.mark.parametrize("shape", GLITCH_SHAPES, ids=GLITCH_IDS)
@pytest.mark.parametrize("engine_mode", ["export", "preview"])
def test_glitch_kernel_matches_twin(cuda_dev, shape, engine_mode):
    """Both entries (in place on frames, out of place on the band) are
    bitwise the twin's gather, with the c4 band and host-rng offsets; each
    launches once."""
    b, h, w = shape
    eng = CRTEngine(EffectParams(**VARIANTS["c4"]), h, w, 24.0, rng="host",
                    engine=engine_mode, device=cuda_dev)
    off = eng.glitch_offsets(eng.make_aux(np.arange(b)))
    seg = eng.consts["glitch_seg_index"]
    y0 = eng._glitch_y0
    g = torch.Generator(device=cuda_dev).manual_seed(2)
    imgs = torch.rand((b, 3, h, w), generator=g, device=cuda_dev)
    want = imgs.clone()
    want[:, :, y0:] = kglitch.shear_planar_ref(imgs[:, :, y0:], off, seg)
    got, band = glitch_entries(imgs, y0, off, seg)
    assert torch.equal(got, want) and torch.equal(band, want[:, :, y0:])


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["wrap_3w", "unaligned", "unaligned_3w", "wide"])
def test_glitch_kernel_edges(cuda_dev, case):
    """Offsets over +-3W (wrapping both ways), frames whose base is 4 bytes
    off 16 (the scalar path, W % 4 == 0 all the same), and a row past 48 KB
    of shared memory (the limit lifted once per device), both entries
    bitwise the twin; a row past the card's shared memory is refused."""
    b, h, w, y0, seg_len = {"wrap_3w": (3, 40, 1920, 13, 16), "unaligned": (2, 45, 1920, 30, 16),
                            "unaligned_3w": (1, 540, 960, 378, 960),
                            "wide": (1, 5, 16384, 2, 32)}[case]
    g = torch.Generator(device=cuda_dev).manual_seed(5)
    seg = (torch.arange(w, device=cuda_dev) // seg_len).to(torch.int32)
    nseg = int(seg.max().item()) + 1
    if case.endswith("3w"):
        off = torch.randint(-3 * w, 3 * w + 1, (b, h - y0, nseg), generator=g, device=cuda_dev,
                            dtype=torch.int32)
    else:
        off = torch.randint(-40, 41, (b, h - y0, nseg), generator=g, device=cuda_dev,
                            dtype=torch.int32)
    if case.startswith("unaligned"):  # a contiguous view 4 bytes into its storage
        imgs = torch.rand(b * 3 * h * w + 1, generator=g, device=cuda_dev)[1:].view(b, 3, h, w)
        assert imgs.data_ptr() % 16 == 4 and imgs.is_contiguous()
    else:
        imgs = torch.rand((b, 3, h, w), generator=g, device=cuda_dev)
    want = imgs.clone()
    want[:, :, y0:] = kglitch.shear_planar_ref(imgs[:, :, y0:], off, seg)
    got, band = glitch_entries(imgs, y0, off, seg)
    assert torch.equal(got, want) and torch.equal(band, want[:, :, y0:])
    if case == "wide":
        w2 = 60000  # 240 KB a row: more than a block may take
        band2 = torch.zeros((1, 3, 1, w2), device=cuda_dev)
        with pytest.raises(RuntimeError, match="crt_glitch_launch"):
            kglitch.shear_planar(band2, torch.zeros((1, 1, 1), dtype=torch.int32,
                                                    device=cuda_dev),
                                 torch.zeros(w2, dtype=torch.int32, device=cuda_dev))
        torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["defaults", "c4"])
@pytest.mark.parametrize("engine_mode", ["export", "preview"])
def test_temporal_engine_on_card_matches_cpu(cuda_dev, name, engine_mode):
    """The CLI defaults and c4 on the card against the CPU step, over two
    batches with the persistence state carried."""
    p = EffectParams(**VARIANTS[name])
    eng_gpu = CRTEngine(p, 96, 320, 24.0, rng="host", engine=engine_mode, device=cuda_dev)
    eng_cpu = CRTEngine(p, 96, 320, 24.0, rng="host", engine=engine_mode, device="cpu")
    x = np.random.default_rng(1).integers(0, 256, (6, 96, 320, 3), dtype=np.uint8)
    sg = sc = None
    for k in range(2):
        idx = np.arange(3 * k, 3 * k + 3)
        got, sg = eng_gpu.process(x[idx], idx, sg)
        want, sc = eng_cpu.process(x[idx], idx, sc)
        d = (got.cpu().int() - want.int()).abs()
        assert d.max().item() <= 1 and (d > 0).float().mean().item() < 1e-3
    assert (sg.cpu() - sc).abs().max().item() <= 2e-6


@pytest.mark.cuda
def test_native_rng_on_card_is_invariant_to_batch_split(cuda_dev):
    p = EffectParams(**VARIANTS["c4"])
    x = np.random.default_rng(3).integers(0, 256, (8, 64, 256, 3), dtype=np.uint8)
    whole, _ = CRTEngine(p, 64, 256, 24.0, seed=5, device=cuda_dev).process(x, np.arange(8))
    eng = CRTEngine(p, 64, 256, 24.0, seed=5, device=cuda_dev)
    head, st = eng.process(x[:4], np.arange(4))
    tail, _ = eng.process(x[4:], np.arange(4, 8), st)
    assert torch.equal(torch.cat([head, tail]), whole)


# the draws' shapes: grain (gh, gw) at c4's 1080p, c3's half field, c5's
# 4K, an odd field; glitch bands (rows, NSEG) of c4 at 1080p and 4K, a
# ragged one
RNG_GRAIN = [(8, 1080, 1920), (8, 540, 960), (32, 2160, 3840), (3, 7, 9)]
RNG_BANDS = [(8, 324, 120), (32, 648, 120), (3, 17, 5)]


def rng_frames(b, dev):
    """Frame indices whose counter words differ in both halves."""
    return torch.arange(b, device=dev) * ((1 << 32) + 1) + 3


@pytest.mark.cuda
@pytest.mark.parametrize("shape", RNG_GRAIN, ids=["c4", "c3_half", "c5_4k", "odd"])
def test_grain_draw_kernel_is_the_twin_bit_for_bit(cuda_dev, shape):
    b, gh, gw = shape
    fr = rng_frames(b, cuda_dev)
    n0 = krng.grain_launches
    got = krng.grain_normals(7, fr, gh, gw)
    torch.cuda.synchronize()
    assert krng.grain_launches == n0 + 1
    for k in range(0, b, 8):  # the twin's int64 intermediates, 8 frames at a time
        assert torch.equal(got[k:k + 8], krng.grain_normals_ref(7, fr[k:k + 8], gh, gw))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", RNG_BANDS, ids=["c4", "c5_4k", "ragged"])
@pytest.mark.parametrize("mode", ["export", "preview"])
def test_glitch_draw_kernel_is_the_twin_bit_for_bit(cuda_dev, mode, shape):
    b, rows, nseg = shape
    fr = rng_frames(b, cuda_dev)
    amp = torch.linspace(6.0, 0.1, rows, device=cuda_dev)
    n0 = getattr(krng, f"{mode}_launches")
    if mode == "export":
        got = krng.glitch_export_offsets(3, fr, nseg, amp)
        want = krng.glitch_export_offsets_ref(3, fr, nseg, amp)
    else:
        got = krng.glitch_preview_offsets(3, fr, amp)
        want = krng.glitch_preview_offsets_ref(3, fr, amp)
    torch.cuda.synchronize()
    assert getattr(krng, f"{mode}_launches") == n0 + 1 and got.dtype == torch.int32
    assert torch.equal(got, want)


EDGE_ROWS, EDGE_NSEG, EDGE_BATCH = (1, 15, 16, 17, 324, 648), (1, 120), (1, 9)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", EDGE_BATCH)
@pytest.mark.parametrize("nseg", EDGE_NSEG)
@pytest.mark.parametrize("rows", EDGE_ROWS)
def test_export_draw_kernel_at_edge_shapes(cuda_dev, rows, nseg, batch):
    """The export entry (one cluster per frame: the walk summed once, the
    segments split over its blocks) bit for bit its twin, one launch."""
    fr = rng_frames(batch, cuda_dev)
    amp = torch.linspace(6.25, 0.25, rows, device=cuda_dev)
    n0 = krng.export_launches
    got = krng.glitch_export_offsets(5, fr, nseg, amp)
    torch.cuda.synchronize()
    assert krng.export_launches == n0 + 1
    assert torch.equal(got, krng.glitch_export_offsets_ref(5, fr, nseg, amp))


@pytest.mark.cuda
@pytest.mark.parametrize("rows,nseg", [(13000, 3), (30000, 1)], ids=["smem_attr", "lim_global"])
def test_export_draw_kernel_on_tall_bands(cuda_dev, rows, nseg):
    """Bands past 48 KB of shared memory (the launcher raises the limit)
    and past the rows whose clip limits fit beside the walk (read from
    global memory), bit for bit the twin."""
    fr = rng_frames(2, cuda_dev)
    amp = torch.linspace(6.25, 0.25, rows, device=cuda_dev)
    got = krng.glitch_export_offsets(5, fr, nseg, amp)
    torch.cuda.synchronize()
    assert torch.equal(got, krng.glitch_export_offsets_ref(5, fr, nseg, amp))


@pytest.mark.cuda
@pytest.mark.parametrize("batch", EDGE_BATCH)
@pytest.mark.parametrize("rows", EDGE_ROWS)
def test_grain_and_preview_draw_kernels_at_edge_shapes(cuda_dev, rows, batch):
    """The grain entry on (rows, 120) and (rows, 1) fields and the preview
    entry on a band of ``rows``, each bit for bit its twin, one launch per
    batch and entry."""
    fr = rng_frames(batch, cuda_dev)
    for gw in EDGE_NSEG[::-1]:
        n0 = krng.grain_launches
        got = krng.grain_normals(5, fr, rows, gw)
        torch.cuda.synchronize()
        assert krng.grain_launches == n0 + 1
        assert torch.equal(got, krng.grain_normals_ref(5, fr, rows, gw))
    amp = torch.linspace(6.25, 0.25, rows, device=cuda_dev)
    n0 = krng.preview_launches
    got = krng.glitch_preview_offsets(5, fr, amp)
    torch.cuda.synchronize()
    assert krng.preview_launches == n0 + 1
    assert torch.equal(got, krng.glitch_preview_offsets_ref(5, fr, amp))


@pytest.mark.cuda
@pytest.mark.parametrize("mode,start,count", [
    ("radius", 0, 1 << 24), ("radius", (1 << 32) - (1 << 24), 1 << 24),
    ("angle", (1 << 32) - (1 << 20), 1 << 22), ("angle", (1 << 30) - (1 << 20), 1 << 21),
    ("angle", (3 << 30) - (1 << 20), 1 << 21), ("pairs", 0, 1 << 22)])
def test_box_muller_fast_path_within_its_bounds(cuda_dev, mode, start, count):
    """csrc/rng_sweep.cu on words next to the domains' edges (u near 0 and
    2^32, v across quadrant starts) and on 2^23 grain pairs: no fast factor
    reaches its bound, no accepted value differs from the FP64 expression,
    and only u = 2^32 - 1 of the radius words is left to the fallback."""
    r = krng.sweep(mode, start=start, count=count, device=cuda_dev)
    assert r["over"] == 0, r
    if mode == "radius":
        assert r["fallbacks"] == (start + count == 1 << 32)
        assert 0 < r["max_dev"][0] < krng.BM_RAD_REL
    elif mode == "angle":
        assert max(r["max_dev"]) < krng.BM_ANG_ABS
    else:
        assert r["fallbacks"] < 1e-4 * 2 * count


@pytest.mark.cuda
def test_draw_kernels_are_invariant_to_the_batch_split(cuda_dev):
    """Frames {3, 5} drawn alone equal rows 3 and 5 of a batch of 0-7, for
    the three entries."""
    whole, pick = torch.arange(8, device=cuda_dev), torch.tensor([3, 5], device=cuda_dev)
    amp = torch.linspace(6.0, 0.1, 33, device=cuda_dev)
    for draw in (lambda f: krng.grain_normals(1, f, 45, 67),
                 lambda f: krng.glitch_export_offsets(1, f, 9, amp),
                 lambda f: krng.glitch_preview_offsets(1, f, amp)):
        assert torch.equal(draw(whole)[pick], draw(pick))


# the raw-grain instantiations (GRAW): each core (fast, gaussian r = 4, a
# runtime radius, past 31, and the bloom off: radius 0, no tap pass, the
# split route's epilogue launch), the uint8 and the f32 input and the text
# mode, both triads; grain sizes 2, 3 and 5 at 1080p, at odd shapes shorter than a run (a last
# strip whose raw window ends at the field's edge; W % 4 != 0), and with a
# raw field one row (gh == 1) or one column (gw == 1) wide
RAW_CORES = {"fast": dict(fast_bloom=True), "r4": dict(fast_bloom=False, bloom_sigma=1.2),
             "runtime": dict(fast_bloom=False, bloom_sigma=4.0),
             "big": dict(fast_bloom=False, bloom_sigma=11.0), "off": dict(bloom_strength=0.0)}
RAW_MODES = {"exact": ("exact", "u8"), "f32_input": ("exact", "f32"), "direct": ("fast", "u8"),
             "text": ("exact", "text"), "text_direct": ("fast", "text")}
RAW_SHAPES = [(8, 1080, 1920), (2, 45, 251), (1, 7, 9), (2, 3, 130), (2, 33, 3)]
RAW_IDS = ["1080p", "odd", "tiny", "gh1", "gw1"]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", sorted(RAW_MODES))
@pytest.mark.parametrize("core", sorted(RAW_CORES))
@pytest.mark.parametrize("shape", RAW_SHAPES, ids=RAW_IDS)
@pytest.mark.parametrize("grain_size", [2, 3, 5])
def test_fused_raw_grain_is_the_upsampled_field_bit_for_bit(cuda_dev, grain_size, shape, core,
                                                           mode):
    """The kernel's raw-grain mode (the raw rows staged a chunk ahead, the
    upsample from shared memory) equals the kernel at grain size 1 fed the
    twin's upsample of the same field (ops/resize.resize_bilinear), in
    every instantiation."""
    b, h, w = shape
    precision, feed_kind = RAW_MODES[mode]
    p = {**C3, **RAW_CORES[core], "noise_strength": 24.0}
    text = {}
    if feed_kind != "u8":
        p["text"] = TextParams(text="T", after=False)
        text = dict(text_rgba=np.random.default_rng(4).integers(0, 256, (h, w, 4), np.uint8))
    eng, flat = (CRTEngine(EffectParams(**{**p, "grain_size": g}), h, w, 24.0, rng="host",
                           precision=precision, device=cuda_dev, **text)
                 for g in (grain_size, 1))
    (spec, consts), (fspec, fconsts) = ((e.spec, e.fused_tables) if feed_kind != "f32"
                                        else f32_input(e) for e in (eng, flat))
    assert consts.plan.grain == (grain_size, *spec.grain_hw)
    assert fconsts.plan.grain is None and spec.pre != (feed_kind == "f32")
    assert spec.bloom == (core != "off") and bool(spec.text_box) == (feed_kind == "text")
    x = frames(b, h, w, cuda_dev)
    feed = eng._pre_bloom(x) if feed_kind == "f32" else x
    kw = eng.fused_operands(eng.make_aux(np.arange(b)))
    t = consts.grain_taps
    field = kfused.oresize.resize_bilinear(kw["grain"], t[0].long(), t[1], t[2].long(), t[3])
    got = kfused.fused_pipeline(feed, spec, consts, **kw)
    want = kfused.fused_pipeline(feed, fspec, fconsts, **{**kw, "grain": field.contiguous()})
    torch.cuda.synchronize()
    assert torch.equal(got, want)


BLOOM3 = {  # variant -> (fast, sigma, threshold)
    "gaussian": (False, 1.2, 0.0),
    "gaussian_wide_knee": (False, 4.0, 0.3),
    "fast": (True, 0.0, 0.0),
    "fast_knee": (True, 0.0, 0.35),
    "gaussian_s10.5": (False, 10.5, 0.0),
    "gaussian_s11_knee": (False, 11.0, 0.3),
    "gaussian_s20": (False, 20.0, 0.0),  # radius 60: past H and W of the small shapes
}
# the walk's edges: a row, a column, W % 4 != 0, a frame narrower than a
# strip and shorter than a run
WALK_SHAPES = SHAPES + [(1, 7, 9), (2, 1, 300), (2, 40, 1), (2, 33, 130)]
WALK_IDS = SHAPE_IDS + ["tiny", "row", "column", "ragged"]
# and one half-res row or column (the fast source)
BLOOM3_SHAPES = WALK_SHAPES + [(2, 2, 300), (2, 40, 2)]
BLOOM3_IDS = WALK_IDS + ["h2", "w2"]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", BLOOM3_SHAPES, ids=BLOOM3_IDS)
@pytest.mark.parametrize("variant", sorted(BLOOM3))
def test_bloom3_kernel_matches_twin(cuda_dev, variant, shape):
    """bloom3's gaussian (the walk's FOLD instances) and fast bloom (its
    FAST source) bit for bit their twins."""
    b, h, w = shape
    fast, sigma, thr = BLOOM3[variant]
    spec = (kbloom3.build_bloom3_fast_spec(h, w, 0.25, thr) if fast
            else kbloom3.build_bloom3_spec(h, w, sigma, 0.25, thr))
    g = torch.Generator(device=cuda_dev).manual_seed(11)
    imgs = torch.rand((b, 3, h, w), generator=g, device=cuda_dev)
    n0 = kbloom3.launches
    if fast:
        got = kbloom3.bloom3_fast_planar(imgs, spec)
        want = kbloom3.bloom3_fast_planar_ref(imgs, spec)
    else:
        got = kbloom3.bloom3_planar(imgs, spec)
        want = kbloom3.bloom3_planar_ref(imgs, spec)
    torch.cuda.synchronize()
    assert kbloom3.launches == n0 + 1
    assert torch.equal(got, want)


TEXT_BEFORE = {"c4_text": VARIANTS["c4"], "c3_text": C3, "r31_text": VARIANTS["r31"],
               "ab_neg2_text": VARIANTS["ab_neg2_px3"], "s20_text": VARIANTS["s20_knee"]}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", FUSED_SHAPES, ids=FUSED_IDS)
@pytest.mark.parametrize("name", sorted(TEXT_BEFORE))
def test_fused_f32_input_matches_twin(cuda_dev, name, shape):
    """The fused kernel's f32-input mode on the torch ops' feed (stages
    1-5 with a text overlay composited before the bloom)."""
    b, h, w = shape
    ov = np.random.default_rng(4).integers(0, 256, (h, w, 4), dtype=np.uint8)
    p = EffectParams(**TEXT_BEFORE[name], text=TextParams(text="T", after=False))
    eng = CRTEngine(p, h, w, 24.0, rng="host", layout="planar", channel_order="gbr",
                    device=cuda_dev, text_rgba=ov)
    spec, consts = f32_input(eng)
    assert not spec.pre
    feed = eng._pre_bloom(frames(b, h, w, cuda_dev))
    kw = eng.fused_operands(eng.make_aux(np.arange(b)))
    n0 = kfused.launches
    got = kfused.fused_pipeline(feed, spec, consts, **kw)
    torch.cuda.synchronize()
    assert kfused.launches == n0 + 1

    def twin(i, j):
        return kfused.fused_pipeline_ref(
            feed[i:j], spec, consts,
            **{k: v[i:j] if k in PER_FRAME else v for k, v in kw.items()})
    assert_fused_close(got, twin, b, False)


# the SASS of each fused instantiation without TEXT (scripts/port_bloom_ab.py
# fused_sass: "core/radius/f32-input/direct[/raw]", a digest of its
# instructions without names and encodings) at the commit before TEXT was
# added, as the nvcc named here built it on an H100: TEXT, an instantiation
# of its own, leaves the others the code they were
SASS_NVCC = "release 12.9, V12.9.86"
SASS_BEFORE_TEXT = {
    "0/4/0/0": "4a31be5b6b70e024", "0/4/0/0/raw": "e5f0f63f77b0084b",
    "0/4/0/1": "65ea91f607b30651", "0/4/0/1/raw": "a5027f3b58cd6740",
    "0/4/1/0": "37750f7f39c0b686", "0/4/1/0/raw": "5f3c84066bb912e0",
    "0/4/1/1": "6b6c10fe6c9d81fe", "0/4/1/1/raw": "ae005a63747a385f",
    "0/n1/0/0": "87cb4f3e5d5f75a3", "0/n1/0/0/raw": "f46af72fc48362b3",
    "0/n1/0/1": "04c9090f71fac779", "0/n1/0/1/raw": "fccb9da21a79f7d0",
    "0/n1/1/0": "b399ffc14602a4ab", "0/n1/1/0/raw": "45c4a5b9a548001a",
    "0/n1/1/1": "e513a17d07aca909", "0/n1/1/1/raw": "99e163de1eaed32f",
    "0/n2/0/0": "151ba3e25a50491b", "0/n2/0/0/raw": "99da9481dcce6137",
    "0/n2/0/1": "08c0a93492737853", "0/n2/0/1/raw": "8fdb9ea67b41836e",
    "0/n2/1/0": "add5d649cf722044", "0/n2/1/0/raw": "3cc4384bb6e9b115",
    "0/n2/1/1": "a7e6c7cfa12afb09", "0/n2/1/1/raw": "f4ef7a3c806d1444",
    "1/0/0/0": "4d482c524468ffdc", "1/0/0/0/raw": "7fb0ff3a96ca95a2",
    "1/0/0/1": "f784397658e257b5", "1/0/0/1/raw": "4020520362389f41",
    "1/0/1/0": "beb3edd3809bb18a", "1/0/1/0/raw": "6206ba3705ef78c4",
    "1/0/1/1": "c9d2cb9dfda968a2", "1/0/1/1/raw": "f44ac76e22afdb90"
}


@pytest.mark.cuda
def test_fused_instantiations_without_text_keep_their_sass(cuda_dev, monkeypatch):
    """The 32 instantiations without TEXT compile to the SASS they had
    before it, and TEXT adds 16: one for each uint8-input instantiation."""
    import pathlib
    import subprocess

    from pythoncrt_tpu_torch.kernels import _build

    nvcc = _build.find_nvcc()
    version = subprocess.run([nvcc, "--version"], capture_output=True, text=True).stdout
    if SASS_NVCC not in version:
        pytest.skip(f"the digests were recorded with nvcc {SASS_NVCC}, not {version!r}")
    monkeypatch.syspath_prepend(str(pathlib.Path(__file__).resolve().parents[1] / "scripts"))
    from port_bloom_ab import fused_sass

    sass = {k: v["sha256"] for k, v in fused_sass(_build.library()._name, nvcc).items()}
    text = sorted(k for k in sass if k.endswith("/text"))
    assert {k: v for k, v in sass.items() if k not in text} == SASS_BEFORE_TEXT
    assert len(text) == 16 and {k.removesuffix("/text") for k in text} == {
        k for k in SASS_BEFORE_TEXT if k.split("/")[2] == "0"}


# the TEXT instantiations: each core (fast, gaussian r = 4, a runtime
# radius, past 31, the bloom off), both triads, the full-size and the raw
# grain, pixel sizes 1-3 with and without aberration
TEXT_CORES = {"fast": dict(fast_bloom=True, pixel_size=1, aberration_px=1),
              "fast_knee_px3": dict(fast_bloom=True, bloom_threshold=0.35, pixel_size=3),
              "r4_px2": dict(fast_bloom=False, bloom_sigma=1.2, pixel_size=2, aberration_px=1),
              "runtime_px3": dict(fast_bloom=False, bloom_sigma=4.0, pixel_size=3,
                                  aberration_px=-2, bloom_threshold=0.3),
              "big_px2": dict(fast_bloom=False, bloom_sigma=11.0, pixel_size=2),
              "off_px1": dict(bloom_strength=0.0, pixel_size=1)}
TEXT_MODES = {"exact": ("exact", 1), "direct": ("fast", 1), "raw": ("exact", 2),
              "raw_direct": ("fast", 2)}


# every box at an odd shape; at 1080p the inner box and the whole frame
TEXT_CASES = [((2, 45, 251), box) for box in sorted(TEXT_BOXES)] + [
    ((2, 1080, 1920), box) for box in ("inner", "whole")]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", sorted(TEXT_MODES))
@pytest.mark.parametrize("core", sorted(TEXT_CORES))
@pytest.mark.parametrize("shape,box", TEXT_CASES,
                         ids=[f"{s[1]}x{s[2]}_{b}" for s, b in TEXT_CASES])
def test_fused_text_is_the_twin_and_the_f32_route(cuda_dev, shape, box, core, mode):
    """The text composited in the kernel's prologue (TEXT) gives the
    twin's values within the fused contract, and the bits of the route it
    replaces: the torch ops' stages 1-5 (``_pre_bloom``, the composite
    over the whole frame) fed to the f32-input mode."""
    b, h, w = shape
    precision, grain = TEXT_MODES[mode]
    ov, want_box = text_overlay(h, w, box)
    p = EffectParams(**{**C3, "warp_strength": 0.0, **TEXT_CORES[core], "grain_size": grain},
                     text=TextParams(text="T", after=False))
    eng = CRTEngine(p, h, w, 24.0, rng="host", precision=precision, layout="planar",
                    channel_order="gbr", device=cuda_dev, text_rgba=ov)
    assert eng.text_route == "fused" and eng.spec.pre and eng.spec.text_box == want_box
    assert not eng.fused_tables.plan.split
    x = frames(b, h, w, cuda_dev)
    kw = eng.fused_operands(eng.make_aux(np.arange(b)))
    n0 = kfused.launches
    got = kfused.fused_pipeline(x, eng.spec, eng.fused_tables, **kw)
    torch.cuda.synchronize()
    assert kfused.launches == n0 + 1

    def twin(i, j):
        return kfused.fused_pipeline_ref(
            x[i:j], eng.spec, eng.fused_tables,
            **{k: v[i:j] if k in PER_FRAME else v for k, v in kw.items()})
    assert_fused_close(got, twin, b, eng.spec.emit == "u8")
    spec, consts = f32_input(eng)
    assert torch.equal(got, kfused.fused_pipeline(eng._pre_bloom(x), spec, consts, **kw))


# the fused kernel past radius 31 (the BIG instantiations: register-blocked
# taps): radii 32, 33 and 60; frames with edge strips and border rows only,
# frames narrower than 2r and than a strip, and one with interior strips,
# blocked row groups and W % 4 != 0
BIG_SIGMAS = {"r32": 10.5, "r33": 11.0, "r60": 20.0}
BIG_SHAPES = [(2, 96, 160), (2, 48, 256), (1, 200, 50), (2, 40, 1), (2, 160, 522)]
BIG_IDS = ["96x160", "48x256", "narrow", "column", "interior"]


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["exact", "fast"])
@pytest.mark.parametrize("feed_kind", ["u8_input", "f32_input", "text"])
@pytest.mark.parametrize("px", [1, 2])
@pytest.mark.parametrize("shape", BIG_SHAPES, ids=BIG_IDS)
@pytest.mark.parametrize("radius", sorted(BIG_SIGMAS))
def test_fused_big_radius_is_the_twin_bit_for_bit(cuda_dev, radius, shape, px, feed_kind,
                                                  precision):
    """The six BIG instantiations (uint8 and f32 input and the uint8 input
    with the text composited, LUT-exact and direct-pow triad) give the
    twin's bits: every tap sum in the twin's order, the border fold
    included."""
    b, h, w = shape
    p = dict(fast_bloom=False, bloom_sigma=BIG_SIGMAS[radius], pixel_size=px)
    text = {}
    if feed_kind != "u8_input":
        p["text"] = TextParams(text="T", after=False)
        text = dict(text_rgba=np.random.default_rng(4).integers(0, 256, (h, w, 4), np.uint8))
    eng = CRTEngine(EffectParams(**p), h, w, 24.0, rng="host", precision=precision,
                    layout="planar", channel_order="gbr", device=cuda_dev, **text)
    spec, consts = f32_input(eng) if feed_kind == "f32_input" else (eng.spec, eng.fused_tables)
    assert spec.r == int(radius[1:]) > kfused.MAX_R and not consts.plan.split
    assert spec.pre != (feed_kind == "f32_input") and (kfused.triad_mode(spec) == 3) == (
        precision == "fast") and bool(spec.text_box) == (feed_kind == "text")
    x = frames(b, h, w, cuda_dev)
    feed = eng._pre_bloom(x) if feed_kind == "f32_input" else x
    kw = eng.fused_operands(eng.make_aux(np.arange(b)))
    n0 = kfused.launches
    got = kfused.fused_pipeline(feed, spec, consts, **kw)
    torch.cuda.synchronize()
    assert kfused.launches == n0 + 1
    assert torch.equal(got, kfused.fused_pipeline_ref(feed, spec, consts, **kw))


NEW_PATHS = {
    "c3_angled_text_after": ({**C3, "scanline_angle": 5.0, "scanline_thickness": 1.5}, True),
    "defaults_angled": ({"scanline_angle": 12.0, "scanline_thickness": 2.0}, None),
    "c4_text_before": (VARIANTS["c4"], False),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(NEW_PATHS))
def test_staged_and_text_engine_on_card_matches_cpu(cuda_dev, name):
    """The angled-scanline and text paths on the card (bloom3, the fused
    kernel's text mode) against the CPU step, two batches, state carried."""
    overrides, after = NEW_PATHS[name]
    text = TextParams() if after is None else TextParams(text="T", after=after)
    ov = np.random.default_rng(6).integers(0, 256, (96, 320, 4), dtype=np.uint8)
    p = EffectParams(**overrides, text=text)
    eng_gpu = CRTEngine(p, 96, 320, 24.0, rng="host", device=cuda_dev, text_rgba=ov)
    eng_cpu = CRTEngine(p, 96, 320, 24.0, rng="host", device="cpu", text_rgba=ov)
    x = np.random.default_rng(1).integers(0, 256, (6, 96, 320, 3), dtype=np.uint8)
    n0 = (kbloom3.launches, kfused.launches)
    sg = sc = None
    for k in range(2):
        idx = np.arange(3 * k, 3 * k + 3)
        got, sg = eng_gpu.process(x[idx], idx, sg)
        want, sc = eng_cpu.process(x[idx], idx, sc)
        d = (got.cpu().int() - want.int()).abs()
        assert d.max().item() <= 1 and (d > 0).float().mean().item() < 1e-3
    assert (kbloom3.launches > n0[0]) == eng_gpu._staged
    assert (kfused.launches > n0[1]) == (not eng_gpu._staged)


OPTIN_BLOOMS = {  # kernel -> (variant, sigma, threshold, limbs)
    "stripe": (None, 1.2, 0.0, None),
    "stripe_wide_knee": (None, 4.0, 0.3, None),
    "bloom2_gauss": ("gaussian", 1.2, 0.0, 3),
    "bloom2_gauss_knee": ("gaussian", 2.0, 0.4, 3),
    "bloom2_fast": ("fast", 0.0, 0.0, 3),
    "bloom2_fast_knee": ("fast", 0.0, 0.35, 3),
    "bloom2_pipelined_1": ("gaussian", 1.2, 0.2, 1),
    "bloom2_pipelined_2": ("fast", 0.0, 0.2, 2),
    "bloom2_pipelined_3": ("gaussian", 1.2, 0.2, "3p"),
    # past the 63 taps of the launch arguments, and past H and W (radius 60)
    "stripe_s10.5": (None, 10.5, 0.0, None),
    "stripe_s20_knee": (None, 20.0, 0.3, None),
    "bloom2_gauss_s11": ("gaussian", 11.0, 0.0, 3),
    "bloom2_gauss_s20_knee": ("gaussian", 20.0, 0.3, 3),
    "bloom2_pipelined_1_s11": ("gaussian", 11.0, 0.2, 1),
}
OPTIN_SHAPES = [(8, 1080, 1920), (2, 45, 250), (1, 7, 9), (2, 1, 5), (2, 40, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", OPTIN_SHAPES, ids=["1080p", "odd", "tiny", "row", "column"])
@pytest.mark.parametrize("name", sorted(OPTIN_BLOOMS))
def test_optin_bloom_kernels_match_twins(cuda_dev, name, shape):
    """The stripe bloom, bloom2 (both variants) and bloom2's pipelined
    entry (limbs 1-3), the walk's CLAMP and TABLE instances, bit for bit
    their twins."""
    b, h, w = shape
    variant, sigma, thr, limbs = OPTIN_BLOOMS[name]
    g = torch.Generator(device=cuda_dev).manual_seed(13)
    imgs = torch.rand((b, 3, h, w), generator=g, device=cuda_dev)
    if variant is None:
        spec = kbloom.build_bloom_spec(h, w, sigma, 0.25, thr)
        n0, mod = kbloom.launches, kbloom
        got, want = kbloom.bloom_planar(imgs, spec), kbloom.bloom_planar_ref(imgs, spec)
    else:
        spec = kbloom2.build_bloom2_spec(h, w, variant=variant, sigma=sigma, strength=0.25,
                                         threshold=thr)
        n0, mod = kbloom2.launches, kbloom2
        if limbs == 3:
            got, want = kbloom2.bloom2_planar(imgs, spec), kbloom2.bloom2_planar_ref(imgs, spec)
        else:
            lb = 3 if limbs == "3p" else limbs
            tabs = kbloom2.bloom2_tables(spec, cuda_dev, lb)
            got = kbloom2.bloom2_planar_pipelined(imgs, spec, lb, tabs)
            want = kbloom2.bloom2_planar_pipelined_ref(imgs, spec, lb, tabs)
    torch.cuda.synchronize()
    assert mod.launches == n0 + 1
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("src", ["fold", "clamp", "table"])
def test_walk_scratch_route_matches_twins(cuda_dev, src):
    """A band too wide for a block even at 4-column strips (the first
    reach of each source at one pixel, tests/test_torch_walk_plan.py):
    the two passes through a device buffer, bit for bit the twins."""
    from pythoncrt_tpu_torch.kernels import bloom_walk as kwalk

    g = torch.Generator(device=cuda_dev).manual_seed(19)
    imgs = torch.rand((2, 3, 1, 1), generator=g, device=cuda_dev)
    if src == "table":
        r = 7262
        rng = np.random.default_rng(1)
        hw, vw = (rng.random((2 * r + 1, 1), np.float32) / (2 * r + 1) for _ in range(2))
        spec = kbloom2.Bloom2Spec(h=1, w=1, variant="gaussian", strength=0.25, threshold=0.3,
                                  hd0=-r, hd1=r, vd0=-r, vd1=r, hw=hw, vw=vw)
        run, twin, mod = kbloom2.bloom2_planar, kbloom2.bloom2_planar_ref, kbloom2
    elif src == "clamp":
        r = 29048
        spec = kbloom.build_bloom_spec(1, 1, r / 3, 0.25, 0.3)
        run, twin, mod = kbloom.bloom_planar, kbloom.bloom_planar_ref, kbloom
    else:
        r = 14524
        spec = kbloom3.build_bloom3_spec(1, 1, r / 3, 0.25, 0.3)
        run, twin, mod = kbloom3.bloom3_planar, kbloom3.bloom3_planar_ref, kbloom3
    code = {"fold": kwalk.FOLD, "clamp": kwalk.CLAMP, "table": kwalk.TABLE}[src]
    assert kwalk.walk_plan(code, 1, 1, -r, r, -r, r).scratch
    n0 = mod.launches
    got = run(imgs, spec)
    torch.cuda.synchronize()
    assert mod.launches == n0 + 1
    assert torch.equal(got, twin(imgs, spec))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 8, 3, 1080, 1920), (3, 2, 3, 45, 251), (2, 3, 3, 5, 7)],
                         ids=["1080p", "odd", "ragged"])
@pytest.mark.parametrize("first", [True, False])
@pytest.mark.parametrize("emit_u8", [True, False])
def test_persist_multiclip_kernel_matches_twin(cuda_dev, shape, first, emit_u8):
    """C clips of B frames, flat: bitwise the twin (and so the per-clip
    sequential scans)."""
    c, b, *frame = shape
    g = torch.Generator(device=cuda_dev).manual_seed(9)
    imgs = torch.rand((c * b, *frame), generator=g, device=cuda_dev)
    states = torch.rand((c, *frame), generator=g, device=cuda_dev)
    n0 = kpersist.launches
    got, gs = kpersist.persistence_scan(imgs, None, first, 0.6, emit_u8=emit_u8,
                                        clip_states=states)
    want, ws = kpersist.persistence_scan_ref(imgs, None, first, 0.6, emit_u8=emit_u8,
                                             clip_states=states)
    torch.cuda.synchronize()
    assert kpersist.launches == n0 + 1
    assert torch.equal(got, want) and torch.equal(gs, ws)


ENV_ROUTES = {
    "c3_bloom2": ({"PCRT_BLOOM2_GAUSS": "1"}, C3, "bloom2"),
    "defaults_bloom2": ({"PCRT_BLOOM2_FAST": "1"}, {}, "bloom2"),
    "c3_stripe": ({"PCRT_PALLAS_BLOOM": "1"}, C3, "stripe"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(ENV_ROUTES))
def test_env_routes_on_card_match_cpu(cuda_dev, name, monkeypatch):
    """The three bloom opt-ins on the card (their kernels launched)
    against the CPU step, two batches, state carried."""
    env, overrides, route = ENV_ROUTES[name]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    p = EffectParams(**overrides)
    eng_gpu = CRTEngine(p, 96, 320, 24.0, rng="host", device=cuda_dev)
    eng_cpu = CRTEngine(p, 96, 320, 24.0, rng="host", device="cpu")
    assert eng_gpu.bloom_route == route == eng_cpu.bloom_route
    mod = kbloom if route == "stripe" else kbloom2
    x = np.random.default_rng(1).integers(0, 256, (6, 96, 320, 3), dtype=np.uint8)
    n0 = mod.launches
    sg = sc = None
    for k in range(2):
        idx = np.arange(3 * k, 3 * k + 3)
        got, sg = eng_gpu.process(x[idx], idx, sg)
        want, sc = eng_cpu.process(x[idx], idx, sc)
        d = (got.cpu().int() - want.int()).abs()
        assert d.max().item() <= 1 and (d > 0).float().mean().item() < 1e-3
    assert mod.launches == n0 + 2


# case -> (clips, frames a clip, height, width, layout, logical clip
# devices): c4's strengths on small frames, then c5 (the same strengths) at
# 3840x2160 with native draws, on one device and over a clip mesh of 2 and 4
MULTICLIP = {"nhwc": (3, 8, 96, 320, "nhwc", 0), "planar": (3, 8, 96, 320, "planar", 0),
             "c5_4k": (4, 16, 2160, 3840, "nhwc", 0),
             "c5_clips_x2": (4, 8, 2160, 3840, "planar", 2),
             "c5_clips_x4": (4, 8, 2160, 3840, "planar", 4)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(MULTICLIP))
def test_multiclip_engine_on_card(cuda_dev, case):
    """c4 on 3 clips x 8 frames (host rng), two steps: equal, bit for bit,
    to three single-clip runs on the card, and within 1 LSB of the CPU's.
    c5 on 4 clips x 16 frames at 3840x2160 (native rng): bit for bit four
    single-clip runs, one multi-clip persistence launch a step; on 4 clips
    x 8 over 2 and 4 logical clip devices of cuda:0: bit for bit the
    engine on one device, frames and states."""
    from pythoncrt_tpu_torch.parallel import CLIP_AXIS, DeviceMesh

    clips, n, h, w, layout, ndev = MULTICLIP[case]
    p = EffectParams(**VARIANTS["c4"])
    kw = dict(layout="planar", channel_order="gbr") if layout == "planar" else {}
    shape = (clips, n, 3, h, w) if layout == "planar" else (clips, n, h, w, 3)
    small = h < 1080
    if small:
        x = np.random.default_rng(2).integers(0, 256, shape, dtype=np.uint8)
    else:  # 4K frames made on the card
        g = torch.Generator(device=cuda_dev).manual_seed(5)
        x = torch.randint(0, 256, shape, generator=g, device=cuda_dev, dtype=torch.uint8)
    idx = np.tile(np.arange(n), (clips, 1))
    half = n // 2

    def two_steps(run):
        o1, st = run.process(x[:, :half], idx[:, :half])
        o2, st = run.process(x[:, half:], idx[:, half:], st)
        return torch.cat([o1, o2], 1), st

    rng = "host" if small else "native"
    if ndev:
        eng = CRTEngine(p, h, w, 24.0, rng=rng, device=cuda_dev, **kw)
        got, gst = two_steps(MultiClipEngine(eng, DeviceMesh([torch.device("cuda", 0)] * ndev,
                                                              CLIP_AXIS)))
        want, wst = two_steps(MultiClipEngine(eng))
        assert torch.equal(got, want) and torch.equal(gst, wst)
        return
    res = {}
    for dev in (cuda_dev, "cpu") if small else (cuda_dev,):
        mc = MultiClipEngine(CRTEngine(p, h, w, 24.0, rng=rng, device=dev, **kw))
        n0, m0 = kpersist.launches, kpersist.multiclip_launches
        o, st = res[str(dev)] = two_steps(mc)
        if dev != "cpu":
            assert kpersist.launches == n0 + 2 and kpersist.multiclip_launches == m0 + 2
            for c in range(clips):
                eng = CRTEngine(p, h, w, 24.0, rng=rng, device=dev, **kw)
                a, s = eng.process(x[c, :half], idx[c, :half])
                b, s = eng.process(x[c, half:], idx[c, half:], s)
                assert torch.equal(torch.cat([a, b]), o[c]) and torch.equal(s, st[c])
    if small:
        (og, sg), (oc, sc) = res[str(cuda_dev)], res["cpu"]
        d = (og.cpu().int() - oc.int()).abs()
        assert d.max().item() <= 1 and (d > 0).float().mean().item() < 1e-3
        assert (sg.cpu() - sc).abs().max().item() <= 2e-6


# --precision fast (triad_mode 3): every instantiation of the fused kernel
# (GAUSS at r = 4, at a runtime radius and past 31; FAST; the f32-input
# mode) and the split route, gamma 1.1 and 2.2, the triad luma on and off
FAST_CORES = {"gauss_r4": C3, "gauss_r12": {**C3, "bloom_sigma": 4.0},
              "gauss_big": VARIANTS["s11"], "fast": VARIANTS["c4"],
              "fast_knee": VARIANTS["fast_knee_px3"],
              # text before the bloom: the f32-input instantiations, and the
              # uint8 ones that composite it (TEXT)
              "gauss_r4_f32": C3, "fast_f32": VARIANTS["c4"],
              "gauss_r4_text": C3, "fast_text": VARIANTS["c4"]}
FAST_SHAPES = [(2, 45, 251), (1, 7, 9), (2, 33, 130), (8, 1080, 1920)]
FAST_IDS = ["odd", "tiny", "ragged_strip", "1080p"]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", FAST_SHAPES, ids=FAST_IDS)
@pytest.mark.parametrize("luma", [False, True], ids=["luma_off", "luma_on"])
@pytest.mark.parametrize("gamma", [1.1, 2.2])
@pytest.mark.parametrize("core", sorted(FAST_CORES))
def test_fused_direct_pow_triad_matches_twin(cuda_dev, core, gamma, luma, shape):
    """triad_mode 3 against its twin: f32 within 2e-6, uint8 within 1 LSB
    (the exact mode's contract), one launch."""
    b, h, w = shape
    over = {**FAST_CORES[core], "triad_gamma": gamma, "triad_preserve_luma": luma}
    text = {}
    if core.endswith(("_f32", "_text")):
        over["text"] = TextParams(text="T", after=False)
        text = dict(text_rgba=np.random.default_rng(4).integers(0, 256, (h, w, 4), np.uint8))
    eng = CRTEngine(EffectParams(**over), h, w, 24.0, rng="host", precision="fast",
                    layout="planar", channel_order="gbr", device=cuda_dev, **text)
    spec, consts = f32_input(eng) if core.endswith("_f32") else (eng.spec, eng.fused_tables)
    assert kfused.triad_mode(spec) == 3 and spec.pre == (not core.endswith("_f32"))
    assert bool(spec.text_box) == core.endswith("_text")
    assert consts.lut_fwd is None and not consts.plan.split
    x = frames(b, h, w, cuda_dev)
    feed = x if spec.pre else eng._pre_bloom(x)
    kw = eng.fused_operands(eng.make_aux(np.arange(b)))
    n0 = kfused.launches
    got = kfused.fused_pipeline(feed, spec, consts, **kw)
    torch.cuda.synchronize()
    assert kfused.launches == n0 + 1

    def twin(i, j):
        return kfused.fused_pipeline_ref(
            feed[i:j], spec, consts,
            **{k: v[i:j] if k in PER_FRAME else v for k, v in kw.items()})
    assert_fused_close(got, twin, b, spec.emit == "u8")


@pytest.mark.cuda
@pytest.mark.parametrize("pre", [True, False])
def test_fused_split_route_direct_pow(cuda_dev, pre):
    """The three-launch route with the direct-pow triad: its epilogue
    launch runs triad_mode 3, bit for bit the twin's one-pixel frames."""
    spec = kfused.build_fused_spec(1, 1, sigma=15000 / 3, strength=0.6, threshold=0.2, px=1,
                                   ab=1, pre=pre, triad=True, triad_luma=True, scanlines=True,
                                   noise=True, noise_scale=0.01, emit="u8", corder=(1, 2, 0),
                                   lut_exact=False)
    consts = kfused.fused_consts(spec, cuda_dev)
    assert consts.plan.split and kfused.triad_mode(consts.split[3]) == 3
    g = torch.Generator(device=cuda_dev).manual_seed(17)
    x = (torch.randint(0, 256, (3, 3, 1, 1), generator=g, device=cuda_dev, dtype=torch.uint8)
         if pre else torch.rand((3, 3, 1, 1), generator=g, device=cuda_dev))
    kw = dict(grain=torch.randn((3, 1, 1), generator=g, device=cuda_dev),
              sl=torch.rand((3, 1), generator=g, device=cuda_dev),
              tri=torch.rand((3, 1), generator=g, device=cuda_dev))
    got = kfused.fused_pipeline(x, spec, consts, **kw)
    torch.cuda.synchronize()
    want = kfused.fused_pipeline_ref(x, spec, consts, **kw)
    assert (got.int() - want.int()).abs().max().item() <= 1


# the direct-pow triad's pow sites (csrc/triad_pow.cuh) swept through
# csrc/triad_sweep.cu: every site, the smoke's gammas
SITE_CASES = [("log2", 1.0), ("exp2", 1.0)] + [("forward", g) for g in ktriad.SWEEP_GAMMAS]
SITE_IDS = [f"{s}-{g:g}" if s == "forward" else s for s, g in SITE_CASES]


@pytest.mark.cuda
@pytest.mark.parametrize("site, gamma", SITE_CASES, ids=SITE_IDS)
def test_triad_pow_sites_match_fp64_on_seeded_inputs(cuda_dev, site, gamma):
    """2^24 seeded f32 inputs drawn over each site's domain, and 2^24 over
    its pixel range, through triad_pow.cuh: every value bit for bit the
    FP64 expression's, each fast value within 2^-36 of it (the rounding
    test's margin), and under 2^-9 of the pixel range's values take the
    FP64 fallback."""
    n = 1 << 24
    start, count = ktriad.DOMAINS[site]
    rng = np.random.default_rng(ktriad.SITES.index(site) * 100 + int(gamma * 10))
    bits = (start + rng.integers(0, count, n, dtype=np.int64)).astype(np.uint32)
    r = ktriad.sweep(site, gamma, xs=torch.from_numpy(bits.view(np.float32)).to(cuda_dev))
    assert r["mismatches"] == 0 and r["max_distance"] < 2.0 ** -36, r
    u = rng.random(n)
    px = (-8.0 * u if site == "exp2" else np.exp2(-8.0 * u)).astype(np.float32)
    r = ktriad.sweep(site, gamma, xs=torch.from_numpy(px).to(cuda_dev))
    assert r["mismatches"] == 0 and r["fallbacks"] < n / 512, r


@pytest.mark.cuda
@pytest.mark.parametrize("site, gamma", [("log2", 1.0), ("exp2", 1.0), ("forward", 0.1),
                                         ("forward", 2.2), ("forward", 10.0)],
                         ids=["log2", "exp2", "forward-0.1", "forward-2.2", "forward-10"])
def test_triad_crafted_inputs_take_the_fallback(cuda_dev, site, gamma):
    """Inputs whose FP64 value lies within 2^-40 of an f32 rounding
    midpoint, and the subnormal boundaries (subnormal inputs, results below
    2^-124), each take the FP64 fallback and give its value; x = 0 and the
    arguments whose result rounds to 0 are answered exactly, without it."""
    c = ktriad.crafted_inputs(site, gamma)
    xs = torch.from_numpy(c["fallback"]).to(cuda_dev)
    assert xs.numel() > 40
    fell = torch.zeros(xs.numel(), dtype=torch.uint8, device=cuda_dev)
    out = torch.empty_like(xs)
    r = ktriad.sweep(site, gamma, xs=xs, out=out, fell=fell)
    assert r["mismatches"] == 0 and bool(fell.bool().all()), r
    want = ktriad.expr(site, c["fallback"], gamma).astype(np.float32)
    assert np.array_equal(out.cpu().numpy().view(np.int32), want.view(np.int32))
    xs = torch.from_numpy(c["exact"]).to(cuda_dev)
    fell = torch.ones(xs.numel(), dtype=torch.uint8, device=cuda_dev)
    r = ktriad.sweep(site, gamma, xs=xs, fell=fell)
    assert r["mismatches"] == 0 and r["exact"] == xs.numel() and not fell.bool().any(), r


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["c3", "defaults", "c4", "luma_knee_px3"])
def test_fast_engine_on_card_matches_cpu(cuda_dev, name):
    """The whole step with precision fast on the card against the CPU step,
    two batches, state carried: <= 1 LSB on fewer than 1e-3 of values."""
    p = EffectParams(**VARIANTS[name])
    x = np.random.default_rng(2).integers(0, 256, (6, 90, 250, 3), dtype=np.uint8)
    outs = []
    for dev in (cuda_dev, "cpu"):
        eng = CRTEngine(p, 90, 250, 24.0, rng="host", precision="fast", device=dev)
        a, st = eng.process(x[:3], np.arange(3))
        b, st = eng.process(x[3:], np.arange(3, 6), st)
        outs.append(torch.cat([a, b]).cpu().int())
    d = (outs[0] - outs[1]).abs()
    assert d.max().item() <= 1 and (d > 0).float().mean().item() < 1e-3


PREVIEW = {  # the GUI preview's configurations: overrides, text after (None: no text)
    "defaults": ({}, None),
    "c3": (C3, None),
    "c4": (VARIANTS["c4"], None),
    "c3_angled": ({**C3, "scanline_angle": 5.0, "scanline_thickness": 1.5}, True),
    "defaults_angled": ({"scanline_angle": 12.0, "scanline_thickness": 2.0}, None),
    "c4_text": (VARIANTS["c4"], False),
}


@pytest.mark.cuda
@pytest.mark.parametrize("hw", [(540, 960), (480, 853)], ids=["960x540", "853x480"])
@pytest.mark.parametrize("name", sorted(PREVIEW))
def test_process_at_on_card_matches_cpu(cuda_dev, name, hw):
    """The GUI preview's engine (engine "preview", host rng, persistence
    zeroed) addressed by time, one frame per call as the preview ticks,
    on the card against the CPU step; the preview path's kernels launch
    (fused or bloom3, the warp, the glitch shear)."""
    overrides, after = PREVIEW[name]
    h, w = hw
    text = TextParams() if after is None else TextParams(text="T", after=after)
    ov = np.random.default_rng(6).integers(0, 256, (h, w, 4), dtype=np.uint8)
    p = EffectParams(**{**overrides, "persistence": 0.0}, text=text)
    engs = [CRTEngine(p, h, w, 30.0, engine="preview", rng="host", device=dev, text_rgba=ov)
            for dev in (cuda_dev, "cpu")]
    x = np.random.default_rng(3).integers(0, 256, (3, h, w, 3), dtype=np.uint8)
    counters = (kfused, kbloom3, kwarp, kglitch)
    n0 = [m.launches for m in counters]
    for k, t in enumerate((0.0, 1 / 30.0, 0.4567)):
        noise = (np.random.default_rng(int(t * 1000)).standard_normal(
            engs[0]._grain_hw, dtype=np.float32)[None] if p.noise_on else None)
        got, want = (e.process_at(x[k:k + 1], np.array([t]), noise)[0].cpu().int()
                     for e in engs)
        d = (got - want).abs()
        assert d.max().item() <= 1 and (d > 0).float().mean().item() < 1e-3, t
    ran = [m.launches > n for m, n in zip(counters, n0)]
    assert ran == [not engs[0]._staged, engs[0]._staged, p.warp_on, p.glitch_on]


SHARDED = {"c4": VARIANTS["c4"], "defaults": {}, "c3": C3}


def sharded_against_single(mesh, name, planar_gbr, h=64, w=200, b=8):
    """Two stateful batches of b frames (native rng) through a
    ShardedCRTEngine over ``mesh`` against the single-device engine: 0
    LSB without persistence, else at most 1 LSB and the state within
    1e-4 (the JAX package's tests/test_sharding.py tolerances)."""
    from pythoncrt_tpu_torch.parallel import ShardedCRTEngine

    kw = dict(layout="planar", channel_order="gbr") if planar_gbr else {}
    p = EffectParams(**SHARDED[name])
    eng = CRTEngine(p, h, w, 24.0, device=mesh.devices[0], **kw)
    sh = ShardedCRTEngine(eng, mesh)
    x = frames(2 * b, h, w, mesh.devices[0])
    if not planar_gbr:
        x = x.permute(0, 2, 3, 1).contiguous()
    got, want = [], []
    for run, out in ((sh, got), (eng, want)):
        o1, s = run.process(x[:b], np.arange(b))
        o2, s = run.process(x[b:], np.arange(b, 2 * b), s)
        out += [torch.cat([o1, o2]).int(), s]
    torch.cuda.synchronize()
    d = (got[0] - want[0]).abs().max().item()
    assert got[0].shape == want[0].shape and got[0].device == want[0].device
    if not p.persistence_on:
        assert d == 0
    else:
        assert d <= 1 and (got[1] - want[1]).abs().max().item() <= 1e-4


# (config, shards, planar gbr, frame size): every configuration and layout
# at 64x200, then the renders' frame size: c4 planar gbr (the ffmpeg pipe's
# layout) and the CLI defaults NHWC (the OpenCV pipe's) over 2, 4 and 8
# shards, c3 NHWC over 4
SHARD_CASES = ([(name, n, gbr, (64, 200)) for name in sorted(SHARDED) for n in (2, 4, 8)
                for gbr in (False, True)]
               + [("c4", n, True, (1080, 1920)) for n in (2, 4, 8)]
               + [("defaults", n, False, (1080, 1920)) for n in (2, 4, 8)]
               + [("c3", 4, False, (1080, 1920))])
SHARD_IDS = [f"{name}-{n}-{'planar_gbr' if gbr else 'nhwc'}" + ("-1080p" if hw[0] == 1080 else "")
             for name, n, gbr, hw in SHARD_CASES]


@pytest.mark.cuda
@pytest.mark.parametrize("name, n, planar_gbr, hw", SHARD_CASES, ids=SHARD_IDS)
def test_sharded_engine_logical_shards_on_one_card(cuda_dev, name, n, planar_gbr, hw):
    """n logical shards on cuda:0 (B = 8: one frame a shard at n = 8)."""
    from pythoncrt_tpu_torch.parallel import DeviceMesh

    sharded_against_single(DeviceMesh([torch.device("cuda", 0)] * n), name, planar_gbr, *hw)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SHARDED))
def test_sharded_engine_over_the_visible_cards(cuda_dev, name):
    """A ShardedCRTEngine over every visible card (make_mesh), and the
    clip-sharded MultiClipEngine over them against one card: kernels
    launched on each card, peer copies of the carry and the gathers."""
    from pythoncrt_tpu_torch.parallel import CLIP_AXIS, make_mesh

    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip(f"needs two or more CUDA devices; this host has {n}")
    sharded_against_single(make_mesh(), name, False, b=2 * n)
    eng = CRTEngine(EffectParams(**SHARDED[name]), 64, 200, 24.0, device="cuda:0")
    x = frames(n * 4, 64, 200, "cuda:0").permute(0, 2, 3, 1).reshape(n, 4, 64, 200, 3)
    idx = np.tile(np.arange(4), (n, 1))
    got, gs = MultiClipEngine(eng, make_mesh(axis=CLIP_AXIS)).process(x, idx)
    want, ws = MultiClipEngine(eng).process(x, idx)
    assert torch.equal(got, want) and torch.equal(gs, ws)


@pytest.mark.cuda
@pytest.mark.parametrize("planar_gbr", [False, True], ids=["nhwc", "planar_gbr"])
@pytest.mark.parametrize("which", ["crt", "sharded_x2", "multiclip"])
@pytest.mark.parametrize("name", ["c4", "defaults", "c3"])
def test_process_stack_on_card_is_the_process_loop(cuda_dev, name, which, planar_gbr):
    """process_stack (3 chunks of 4 frames, native rng, into the caller's
    ``out``) on the card: bit for bit three process() calls, frames and
    state, for CRTEngine, a ShardedCRTEngine over 2 logical shards of
    cuda:0 and a MultiClipEngine of 2 clips; under torch's CUDA sync debug
    mode "error", which raises on a synchronizing call."""
    from pythoncrt_tpu_torch.parallel import DeviceMesh, ShardedCRTEngine

    kw = dict(layout="planar", channel_order="gbr") if planar_gbr else {}
    h, w, n, b = 64, 200, 3, 4
    eng = CRTEngine(EffectParams(**VARIANTS[name]), h, w, 24.0, device="cuda:0", **kw)
    clips = 2 if which == "multiclip" else 1
    x = frames(clips * n * b, h, w, "cuda:0")
    if not planar_gbr:
        x = x.permute(0, 2, 3, 1).contiguous()
    if which == "multiclip":
        run = MultiClipEngine(eng)
        stack = x.reshape(clips, n, b, *x.shape[1:]).transpose(0, 1).contiguous()
        idx = np.stack([np.arange(n * b), np.arange(n * b) + 40]).reshape(2, n, b)
        idx = idx.transpose(1, 0, 2)
    else:
        run = eng if which == "crt" else ShardedCRTEngine(
            eng, DeviceMesh([torch.device("cuda", 0)] * 2))
        stack, idx = x.reshape(n, b, *x.shape[1:]), np.arange(n * b).reshape(n, b) + 9
    outs, st = [], None
    for k in range(n):
        o, st = run.process(stack[k], idx[k], st)
        outs.append(o)
    dst = torch.empty_like(stack)
    torch.cuda.set_sync_debug_mode("error")  # no host sync between the chunks
    try:
        got, gst = run.process_stack(stack, idx, out=dst)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert got is dst
    assert torch.equal(got, torch.stack(outs)) and torch.equal(gst, st)


# ---- stage 13: the text after the effects (csrc/text.cu) ----------------

TEXT_AFTER_SHAPES = [(2, 45, 251), (2, 48, 200), (3, 33, 132), (1, 7, 9)]


def text_planes(ov, dev):
    """An (H, W, 4) uint8 overlay as the engine holds it: (H, W) alpha and
    (3, H, W) colour, u8 / 255 in f32, on ``dev``."""
    t = torch.from_numpy(ov).to(dev).float() / 255.0
    return t[..., 3].contiguous(), t[..., :3].permute(2, 0, 1).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("base", ["aligned", "offset"])
@pytest.mark.parametrize("whole", [False, True], ids=["box", "whole"])
@pytest.mark.parametrize("box", sorted(TEXT_BOXES))
@pytest.mark.parametrize("shape", TEXT_AFTER_SHAPES, ids=["odd", "w200", "w132", "tiny"])
def test_text_after_kernel_is_composite_text(cuda_dev, shape, box, whole, base):
    """text_after_kernel bit for bit ops/color.composite_text over boxes at
    each edge, the whole frame, none (the box grid launches nothing), on a
    batch in [0, 1] for the box grid and with values planted off it (-0.5,
    1 + 2^-23, 3) for the whole-frame grid; ``offset``: the batch 4 bytes
    off 16, so the scalar walk."""
    b, h, w = shape
    ov, want_box = text_overlay(h, w, box)
    alpha, rgb = text_planes(ov, cuda_dev)
    tb = ktext.find_box(alpha, rgb)
    assert tb.box == want_box
    g = torch.Generator(device=cuda_dev).manual_seed(11)
    img = torch.rand((b, 3, h, w), generator=g, device=cuda_dev)
    img[torch.rand(img.shape, generator=g, device=cuda_dev) < 0.05] = 1.0
    if whole:
        for v in (-0.5, 1.0 + 2.0 ** -23, 3.0):
            img[torch.rand(img.shape, generator=g, device=cuda_dev) < 0.05] = v
    want = ocolor.composite_text(img, alpha, rgb)
    got = img.clone()
    if base == "offset":
        got = torch.empty(img.numel() + 1, device=cuda_dev)[1:].view(img.shape).copy_(img)
    n0 = ktext.launches
    assert ktext.composite_after(got, tb, whole) is got
    torch.cuda.synchronize()
    assert ktext.launches == n0 + int(bool(tb.box) or whole)
    assert torch.equal(got, want if (whole or tb.box) else img)
    if ktext.launches > n0:
        assert ktext.last_plan.vec == int(base == "aligned" and w % 4 == 0)


def c5_caption(h, w, seed=6):
    """The c5 cell's caption box (portbench/traffic/manifest.json, [216, 384,
    270, 1280] at 3840x2160) scaled to h x w, seeded RGBA with 0s and 255s."""
    ov = np.zeros((h, w, 4), np.uint8)
    y0, x0, bh, bw = 216 * h // 2160, 384 * w // 3840, 270 * h // 2160, 1280 * w // 3840
    a = np.random.default_rng(seed).integers(0, 256, (bh, bw, 4), dtype=np.uint8)
    a[1::7, :, 3] = 0
    a[0, 0, 3] = a[-1, -1, 3] = 255
    ov[y0:y0 + bh, x0:x0 + bw] = a
    return ov


# route -> (params, shape, grid): the feeds that reach stage 13
TEXT_AFTER_FEEDS = {
    "c5_fused_4k": (VARIANTS["c4"], (16, 2160, 3840), "box"),
    "c3_warp": (C3, (4, 270, 480), "whole"),
    "c4_angled_staged": ({**VARIANTS["c4"], "scanline_angle": 5.0, "scanline_thickness": 1.5},
                         (4, 96, 320), "box"),
    "c3_angled_warp": ({**C3, "scanline_angle": 5.0, "scanline_thickness": 1.5}, (3, 45, 251),
                       "whole"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("route", sorted(TEXT_AFTER_FEEDS))
def test_text_after_kernel_on_the_engines_feeds(cuda_dev, route):
    """Stage 13 on the batch the engine's step hands it (the fused kernel's
    f32 emit at c5's 4K shape and caption, the warp's f32 emit, the staged
    step's epilogue, with and without the warp): text_after_kernel on the
    engine's grid bit for bit composite_text over the whole batch."""
    over, (b, h, w), grid = TEXT_AFTER_FEEDS[route]
    p = EffectParams(**over, text=TextParams(text="T", after=True))
    eng = CRTEngine(p, h, w, 24.0, seed=2**31 + 9, device=cuda_dev, layout="planar",
                    channel_order="gbr", text_rgba=c5_caption(h, w))
    assert eng.text_route == "after" and eng.text_grid == grid
    assert eng._staged == ("angled" in route)
    aux = eng.upload(eng.make_aux(np.arange(b)))
    x = frames(b, h, w, cuda_dev)
    if eng._staged:
        feed = eng._staged_stages(x, aux)
    else:
        feed = kfused.fused_pipeline(x, eng.spec, eng.fused_tables, **eng.fused_operands(aux))
    if p.warp_on:
        feed = kwarp.warp_planar(feed, eng.warp_tables, emit_u8=False)
    want = ocolor.composite_text(feed, *eng._text)
    n0 = ktext.launches
    got = ktext.composite_after(feed, eng._text_crops, grid == "whole")
    torch.cuda.synchronize()
    assert got is feed and ktext.launches == n0 + 1 and torch.equal(got, want)
    if route == "c5_fused_4k":
        assert eng._text_crops.box == (216, 486, 384, 1664)
        assert ktext.last_plan == ktext.TextPlan(1, 1, 160)


@pytest.mark.cuda
def test_multiclip_text_after_on_card_is_the_plain_reference(cuda_dev):
    """c5 (c4's strengths, planar gbr, native draws, the caption after the
    effects) at 540x960, 2 clips x 8 frames over two steps of one
    process_stack call, enqueued with no host sync, against the
    benchmark's plain reference rendering each clip as a stream: bit for
    bit, one text_after_kernel launch a step."""
    import json
    import os

    from portbench.reference.chain import Chain
    from portbench.reference.compare import gaps, to_rgb

    h, w, seed = 540, 960, 2**31 + 29
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "portbench", "configs", "c5_batch_4k.json")) as f:
        cfg = json.load(f)
    cfg = dict(cfg, height=h, width=w, params=dict(cfg["params"], text={
        "text": "PLAY", "size": 24, "after": True}))
    ov = c5_caption(h, w)
    p = EffectParams(**{k: v for k, v in cfg["params"].items() if k != "text"},
                     text=TextParams(**cfg["params"]["text"]))
    mc = MultiClipEngine(CRTEngine(p, h, w, cfg["fps"], engine=cfg["engine"], rng=cfg["rng"],
                                   seed=seed, text_rgba=ov, layout=cfg["layout"],
                                   channel_order=cfg["channel_order"], device=cuda_dev))
    assert mc.engine.text_grid == "box"
    x = frames(16, h, w, cuda_dev).reshape(2, 8, 3, h, w)
    stack = x.reshape(2, 2, 4, 3, h, w).transpose(0, 1).contiguous()
    idx = np.tile(np.arange(8).reshape(2, 1, 4), (1, 2, 1))
    n0 = ktext.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs, _ = mc.process_stack(stack, idx)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert ktext.launches == n0 + 2
    chain = Chain(cfg, seed, cuda_dev, torch.float32, ov)
    for c in range(2):
        want, _ = chain.render(to_rgb(x[c], cfg), np.arange(8), None)
        got = to_rgb(outs[:, c].reshape(8, 3, h, w), cfg)
        assert gaps(got, want) == (0, 0), c
