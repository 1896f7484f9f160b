"""The port's fused stage 1-11 pass (pythoncrt_tpu_torch.kernels.fused)
against the JAX Pallas kernel it replaces, run in interpret mode on the
same spec and operands. The CUDA kernel against its twin on a card is
in test_torch_cuda.py.

The CPU path of the port is the kernel's plain PyTorch twin. Both sides
keep the reference's f32 op order, so f32 outputs agree to 2e-6 (the
FMA-contraction class of tests/test_fused.py) and the uint8 emit to
<= 1 LSB with fewer than 1e-3 of values off. The grain operand is a
plain (B, H, W) field (grain_g=1): the JAX kernel's half-field bf16
window forms are TPU workarounds, covered at engine level by
test_torch_engine.py. The twin's text mode (the overlay composited over
its box after the prologue) is held bit for bit to the route it replaces:
the torch ops' stages 1-5 fed to the f32-input mode."""

import dataclasses

import numpy as np
import pytest
import torch

from pythoncrt_tpu import oracle
from pythoncrt_tpu.kernels import fused as jfused
from pythoncrt_tpu_torch import CRTEngine, EffectParams, TextParams
from pythoncrt_tpu_torch.kernels import fused as tfused
from pythoncrt_tpu_torch.ops import color as ocolor

from test_engine_vs_oracle import identity_params
from test_fused import CASES
from test_torch_cuda import TEXT_BOXES, text_overlay

H, W, B = 48, 256, 2

PORTED = ("c3_full", "no_warp", "luma_knee", "bloom_only", "ab_only",
          "c2_retro", "no_bloom_warp", "c1_scan_vig")


def spec_kwargs(p, corder=(0, 1, 2), emit="f32"):
    """The build_fused_spec arguments the JAX engine derives from params
    (engine._resolve_fused), for a plain (B, H, W) grain operand."""
    t = float(p.temperature)
    return dict(
        sigma=float(p.bloom_sigma), strength=float(p.bloom_strength),
        threshold=float(p.bloom_threshold), fast=bool(p.fast_bloom), bloom=p.bloom_on,
        pre=True, px=int(p.pixel_size) if p.pixelate_on else 1,
        ab=int(p.aberration_px) if p.aberration_on else 0,
        saturation=float(p.saturation),
        temp_r=float(np.clip(1.0 + 0.5 * t, 0.5, 1.5)) if t != 0.0 else 1.0,
        temp_b=float(np.clip(1.0 - 0.5 * t, 0.5, 1.5)) if t != 0.0 else 1.0,
        brightness=float(p.brightness), contrast=float(p.contrast),
        inv_gamma=(1.0 / float(p.gamma)) if p.gamma != 1.0 else 1.0,
        triad=p.triad_on, triad_gamma=float(p.triad_gamma),
        triad_luma=bool(p.triad_preserve_luma), lut_exact=True,
        scanlines=p.scanlines_on, vignette=p.vignette_on,
        vig_strength=float(p.vignette_strength), flicker=p.flicker_on,
        noise=p.noise_on, noise_scale=float(p.noise_strength) / 255.0,
        emit=emit, corder=corder)


def operands(p, corder, seed=11):
    """Seeded numpy operands, in each kernel's operand shapes."""
    from conftest import synth_frames

    rng = np.random.default_rng(seed)
    frames = synth_frames(B, H, W, seed=seed)  # (B, H, W, 3) RGB
    img = np.ascontiguousarray(np.transpose(frames, (0, 3, 1, 2))[:, list(corder)])
    ops = dict(
        grain=rng.standard_normal((B, H, W), dtype=np.float32),
        sl=(1.0 - 0.6 * rng.random((B, H))).astype(np.float32),
        vy2=np.linspace(0.0, 1.0, H, dtype=np.float32) ** 2,
        vx2=np.linspace(-1.0, 1.0, W, dtype=np.float32) ** 2,
        tri=oracle.triad_mask(1, W, p.triad_strength, p.triad_softness)[0].T[list(corder)],
        flicker=(1.0 + 0.05 * rng.standard_normal(B)).astype(np.float32))
    return img, ops


def run_both(p, corder, emit_jax, emit_port, pre=True):
    """Both kernels on the same operands; ``pre`` False feeds them a
    seeded f32 image in [0, 1] in place of the uint8 frames."""
    jspec = jfused.build_fused_spec(H, W, **{**spec_kwargs(p, corder, emit_jax), "pre": pre})
    tspec = tfused.build_fused_spec(H, W, **{**spec_kwargs(p, corder, emit_port), "pre": pre})
    img, ops = operands(p, corder)
    if not pre:
        img = np.random.default_rng(12).random(img.shape, dtype=np.float32)
    jkw = {k: ops[k] for k, on in (("grain", jspec.noise), ("sl", jspec.scanlines),
                                    ("vy2", jspec.vignette), ("vx2", jspec.vignette),
                                    ("tri", jspec.triad), ("flicker", jspec.flicker)) if on}
    shape = dict(sl=(B, H, 1), vy2=(H, 1), vx2=(1, W), tri=(3, 1, W), flicker=(B, 1))
    want = np.asarray(jfused.fused_pipeline(
        img, jspec, interpret=True,
        **{k: v.reshape(shape.get(k, v.shape)) for k, v in jkw.items()}))
    got = tfused.fused_pipeline(
        torch.from_numpy(img), tspec, tfused.fused_consts(tspec),
        **{k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in jkw.items()}).numpy()
    return got, want


@pytest.mark.parametrize("name", PORTED + ("c3_full_gbr",))
def test_fused_twin_matches_jax_kernel(name):
    corder = (1, 2, 0) if name.endswith("_gbr") else (0, 1, 2)
    p = identity_params(**CASES[name.replace("_gbr", "")][0])
    got, want = run_both(p, corder, "f32", "f32")
    assert got.dtype == np.float32 and got.shape == (B, 3, H, W)
    err = np.abs(got - want).max()
    assert err <= 2e-6, f"{name}: max |port - jax| = {err:.3g}"


def test_fused_u8_emit_matches_jax_kernel():
    p = identity_params(**CASES["no_warp"][0])
    got, want = run_both(p, (0, 1, 2), "u8_255", "u8")
    assert got.dtype == np.uint8
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert d.max() <= 1 and (d > 0).mean() < 1e-3, (
        f"u8 emit: max {d.max()} LSB, {(d > 0).mean():.2e} off")


def test_fused_spec_refuses_out_of_slice():
    """precision fast (lut_exact=False) builds the direct-pow triad
    (triad_mode 3, no tables); an unknown emit is refused; the f32-input
    mode (pre=False, text before the bloom) builds and renders."""
    p = identity_params(**CASES["c4_fast"][0])
    fast = tfused.build_fused_spec(H, W, **{**spec_kwargs(p), "lut_exact": False})
    assert tfused.triad_mode(fast) == 3 and tfused.fused_consts(fast).lut_fwd is None
    with pytest.raises(ValueError, match="emit"):
        tfused.build_fused_spec(H, W, **{**spec_kwargs(p), "emit": "bf16_255"})
    spec = tfused.build_fused_spec(H, W, **{**spec_kwargs(p), "pre": False, "noise": False})
    assert spec.pre is False
    x = torch.rand((B, 3, H, W), generator=torch.Generator().manual_seed(1))
    _, ops = operands(p, (0, 1, 2))
    out = tfused.fused_pipeline(x, spec, tfused.fused_consts(spec),
                                **{k: torch.from_numpy(np.ascontiguousarray(ops[k]))
                                   for k in ("sl", "vy2", "vx2", "tri")})
    assert out.shape == (B, 3, H, W) and out.dtype == torch.float32
    assert torch.isfinite(out).all() and 0.0 <= out.min() and out.max() <= 1.0


@pytest.mark.parametrize("name", ["c4_fast", "c3_full", "luma_knee", "c3_full_gbr"])
def test_fused_f32_input_matches_jax_kernel(name):
    """The f32-input mode (pre=False: the JAX engine's route for text
    composited before the bloom) against the JAX kernel's, on the same
    f32 image and operands."""
    corder = (1, 2, 0) if name.endswith("_gbr") else (0, 1, 2)
    p = identity_params(**CASES[name.replace("_gbr", "")][0])
    got, want = run_both(p, corder, "f32", "f32", pre=False)
    err = np.abs(got - want).max()
    assert err <= 2e-6, f"{name}: max |port - jax| = {err:.3g}"


@pytest.mark.parametrize("name", ["c4_fast", "fast_knee", "defaults", "defaults_gbr"])
def test_fast_core_twin_matches_jax_kernel(name):
    """The fast-bloom core (half-res down+up) against the JAX kernel's
    fast variant in interpret mode."""
    corder = (1, 2, 0) if name.endswith("_gbr") else (0, 1, 2)
    base = name.replace("_gbr", "")
    p = EffectParams() if base == "defaults" else identity_params(**CASES[base][0])
    assert p.fast_bloom and p.bloom_on
    got, want = run_both(p, corder, "f32", "f32")
    err = np.abs(got - want).max()
    assert err <= 2e-6, f"{name}: max |port - jax| = {err:.3g}"


@pytest.mark.parametrize("shape", [(48, 256), (45, 250), (7, 9), (1, 5)])
@pytest.mark.parametrize("threshold", [0.0, 0.35])
def test_fast_core_twin_matches_the_oracle(shape, threshold):
    """Stages 1-6 with the fast bloom, uint8 emit, against the oracle's
    resize_bilinear down and up, at the frame edges and on odd sizes
    (bilinear_taps clamps the last half-res row and column): <= 1 LSB."""
    h, w = shape
    p = identity_params(bloom_strength=0.4, fast_bloom=True, bloom_threshold=threshold,
                        aberration_px=1, pixel_size=2, saturation=0.8)
    spec = tfused.build_fused_spec(h, w, **{**spec_kwargs(p, emit="u8"), "noise": False,
                                            "triad": False, "scanlines": False,
                                            "vignette": False, "flicker": False})
    frames = np.random.default_rng(h * w).integers(0, 256, (2, h, w, 3), dtype=np.uint8)
    got = tfused.fused_pipeline(torch.from_numpy(np.ascontiguousarray(frames.transpose(0, 3, 1, 2))),
                                spec, tfused.fused_consts(spec)).numpy()
    want = np.stack([oracle.ops.to_uint8(oracle.apply_effects(f, p)) for f in frames])
    d = np.abs(got.transpose(0, 2, 3, 1).astype(np.int32) - want.astype(np.int32))
    assert d.max() <= 1 and (d > 0).mean() < 1e-3, f"{shape}: max {d.max()} LSB"



# the text composited in the prologue: per pixel size a core (1: the fast
# core with the full-size grain, 2: the gaussian with the raw grain, 3: the
# fast core with a knee and the grade on), the aberration off and on
TEXT_PX = {1: (dict(fast_bloom=True, noise_strength=1.5), 1),
           2: (dict(fast_bloom=False, bloom_sigma=1.2, grain_size=2, noise_strength=1.5), 1),
           3: (dict(fast_bloom=True, bloom_threshold=0.35, saturation=0.8, gamma=1.1,
                    contrast=1.05), -2)}


@pytest.mark.parametrize("box", sorted(TEXT_BOXES))
@pytest.mark.parametrize("ab", [False, True], ids=["ab_off", "ab_on"])
@pytest.mark.parametrize("px", sorted(TEXT_PX))
def test_fused_text_twin_is_the_f32_route(px, ab, box):
    """The twin's text mode (the composite over the box the engine finds
    from the overlay's alpha, after the prologue) gives the bits of the
    route it replaces, the torch ops' stages 1-5 over the whole frame
    (``_pre_bloom``) fed to the f32-input mode, at boxes touching each edge
    of the frame, covering it and none, with alpha 0 and 255 inside."""
    h, w, b = 45, 251, 2
    over, shift = TEXT_PX[px]
    ov, want_box = text_overlay(h, w, box)
    p = EffectParams(**{**over, "pixel_size": px, "aberration_px": shift if ab else 0,
                        "triad_strength": 0.35, "scanline_strength": 0.6,
                        "vignette_strength": 0.25, "bloom_strength": 0.25},
                     text=TextParams(text="T", after=False))
    eng = CRTEngine(p, h, w, 24.0, rng="host", layout="planar", channel_order="gbr",
                    device="cpu", text_rgba=ov)
    assert eng.text_route == "fused" and eng.spec.text_box == want_box
    assert set(eng.fused_operands(eng.make_aux(np.arange(b)))) >= (
        {"talpha", "trgb"} if want_box else set())
    x = torch.from_numpy(np.random.default_rng(px).integers(0, 256, (b, 3, h, w), np.uint8))
    kw = eng.fused_operands(eng.make_aux(np.arange(b)))
    got = tfused.fused_pipeline(x, eng.spec, eng.fused_tables, **kw)
    spec = dataclasses.replace(eng.spec, pre=False, text_box=())
    consts = tfused.fused_consts(spec)
    assert torch.equal(got, tfused.fused_pipeline(eng._pre_bloom(x), spec, consts, **kw))
    if want_box:  # outside the box the composite is the identity on the grade's output
        pre = tfused.prologue_ref(x, eng.spec, eng.fused_tables)
        y0, y1, x0, x1 = want_box
        full = ocolor.composite_text(pre, *eng._text)
        outside = torch.ones((h, w), dtype=torch.bool)
        outside[y0:y1, x0:x1] = False
        assert torch.equal(full[..., outside], pre[..., outside])
