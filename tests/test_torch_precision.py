"""``--precision fast`` in the port: the direct-pow triad (the JAX
kernel's ``lut_exact=False`` branch, pythoncrt_tpu/kernels/fused.py:
601-631, and ops/color.py's ``apply_triad(lut_exact=False)``) against the
JAX package on the same operands.

Tolerances: the port rounds each pow site once from double, the JAX
package on the CPU computes them in f32 (``jnp.power``, then
``exp2(e * log2(x))``), so f32 outputs agree to 1e-5 (a few ulp through
pow(1/g)'s slope) and the uint8 emit to 1 LSB. Against the oracle (the
LUT-exact reference) the fast mode is held to the JAX test's documented
deviation (tests/test_engine_vs_oracle.py test_fast_precision_close_not_exact:
max 16 LSB, mean 0.5 LSB: pow(1/g) is steep near black). Against the JAX
engine in fast mode (host rng, the XLA path): 1 LSB on fewer than 1e-3
of values."""

import numpy as np
import pytest
import torch

from pythoncrt_tpu import CRTEngine as JaxEngine
from pythoncrt_tpu.kernels import fused as jfused
from pythoncrt_tpu.ops import color as jcolor
from pythoncrt_tpu_torch import CRTEngine, EffectParams
from pythoncrt_tpu_torch.kernels import fused as tfused
from pythoncrt_tpu_torch.ops import color as tcolor

from conftest import synth_frames
from test_engine_vs_oracle import identity_params, render_oracle
from test_fused import CASES
from test_torch_fused import B, H, W, operands, spec_kwargs

F32_TOL = 1e-5

# the JAX test's fast-mode params (test_engine_vs_oracle.py:127-133)
ORACLE_PARAMS = dict(scanline_strength=0.6, triad_strength=0.4, triad_gamma=2.2,
                     triad_preserve_luma=True, vignette_strength=0.25, gamma=1.2,
                     persistence=0.0, pixel_size=1, aberration_px=0, bloom_strength=0.0,
                     noise_strength=0.0, fast_bloom=False, glitch_amp_px=0,
                     glitch_height_frac=0.0)


def run_fast(p, corder, emit_jax, emit_port, pre=True):
    """The JAX kernel (interpret mode) and the port's twin on one spec
    with lut_exact=False and the same seeded operands."""
    kw = {**spec_kwargs(p, corder), "lut_exact": False, "pre": pre}
    jspec = jfused.build_fused_spec(H, W, **{**kw, "emit": emit_jax})
    tspec = tfused.build_fused_spec(H, W, **{**kw, "emit": emit_port})
    assert not jspec.lut_exact and not tspec.lut_exact
    img, ops = operands(p, corder)
    if not pre:
        img = np.random.default_rng(12).random(img.shape, dtype=np.float32)
    on = dict(grain=jspec.noise, sl=jspec.scanlines, vy2=jspec.vignette, vx2=jspec.vignette,
              tri=jspec.triad, flicker=jspec.flicker)
    jkw = {k: v for k, v in ops.items() if on[k]}
    shape = dict(sl=(B, H, 1), vy2=(H, 1), vx2=(1, W), tri=(3, 1, W), flicker=(B, 1))
    want = np.asarray(jfused.fused_pipeline(
        img, jspec, interpret=True,
        **{k: v.reshape(shape.get(k, v.shape)) for k, v in jkw.items()}))
    consts = tfused.fused_consts(tspec)
    assert consts.lut_fwd is None and consts.plan.direct == tspec.triad
    got = tfused.fused_pipeline(
        torch.from_numpy(img), tspec, consts,
        **{k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in jkw.items()}).numpy()
    return got, want


@pytest.mark.parametrize("name", ["c3_full", "luma_knee", "no_warp", "c4_fast", "c3_full_gbr",
                                  "c3_full_g1.1"])
def test_fast_twin_matches_jax_kernel(name):
    corder = (1, 2, 0) if name.endswith("_gbr") else (0, 1, 2)
    over = dict(CASES[name.replace("_gbr", "").replace("_g1.1", "")][0])
    if name.endswith("_g1.1"):
        over["triad_gamma"] = 1.1
    got, want = run_fast(identity_params(**over), corder, "f32", "f32")
    err = np.abs(got - want).max()
    assert err <= F32_TOL, f"{name}: max |port - jax| = {err:.3g}"


@pytest.mark.parametrize("pre", [True, False], ids=["u8_in", "f32_in"])
def test_fast_u8_emit_matches_jax_kernel(pre):
    p = identity_params(**{**CASES["luma_knee"][0], "warp_strength": 0.0})
    got, want = run_fast(p, (0, 1, 2), "u8_255", "u8", pre=pre)
    assert got.dtype == np.uint8
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert d.max() <= 1 and (d > 0).mean() < 1e-3, (d.max(), (d > 0).mean())


@pytest.mark.parametrize("luma", [False, True])
@pytest.mark.parametrize("gamma", [1.1, 2.2])
def test_apply_triad_direct_pow_matches_jax(gamma, luma):
    rng = np.random.default_rng(7)
    img = rng.random((2, 16, 24, 3), dtype=np.float32) * 1.1 - 0.05  # clips at both ends
    mask = rng.random((24, 3), dtype=np.float32)
    want = np.asarray(jcolor.apply_triad(img, mask, gamma, luma, lut_exact=False))
    got = tcolor.apply_triad(torch.from_numpy(img), torch.from_numpy(mask), gamma, luma,
                             lut_exact=False).numpy()
    assert np.abs(got - want).max() <= F32_TOL
    exact = tcolor.apply_triad(torch.from_numpy(img), torch.from_numpy(mask), gamma, luma).numpy()
    assert not np.array_equal(got, exact)  # the tables are not read


def test_fast_engine_vs_oracle(frames_small):
    """The JAX test's bounds and params: max 16 LSB, mean 0.5 LSB."""
    p = EffectParams(**ORACLE_PARAMS)
    h, w = frames_small.shape[1:3]
    eng = CRTEngine(p, h, w, 24.0, rng="host", precision="fast", device="cpu")
    assert eng.lut_exact is False and eng.spec.lut_exact is False
    got, _ = eng.process(frames_small)
    want = render_oracle(JaxEngine(p, h, w, 24.0, rng="host", pallas="off"), frames_small)
    d = np.abs(got.numpy().astype(np.int32) - want.astype(np.int32))
    assert d.max() <= 16 and d.mean() <= 0.5, (d.max(), d.mean())


@pytest.mark.parametrize("name,over", [
    ("oracle_params", ORACLE_PARAMS),
    ("c3_full", CASES["c3_full"][0]),
    ("c4_fast", CASES["c4_fast"][0]),
    ("angled", {**CASES["c3_full"][0], "scanline_angle": 7.0, "scanline_thickness": 1.5}),
])
def test_fast_engine_vs_jax_engine(name, over):
    """The port's fast engine against the JAX engine's (host rng, XLA
    path) on the same frames: the fused twin, and the staged step's torch
    epilogue for angled scanlines."""
    p = identity_params(**over)
    frames = synth_frames(4, 48, 64, seed=9)
    eng = CRTEngine(p, 48, 64, 24.0, rng="host", precision="fast", device="cpu")
    got = eng.process(frames)[0].numpy()
    jx = JaxEngine(p, 48, 64, 24.0, rng="host", precision="fast", pallas="off")
    assert not jx.lut_exact
    want = np.asarray(jx.process(frames)[0])
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert d.max() <= 1 and (d > 0).mean() < 1e-3, (name, d.max(), (d > 0).mean())
    exact = CRTEngine(p, 48, 64, 24.0, rng="host", device="cpu").process(frames)[0].numpy()
    assert not np.array_equal(got, exact)


def test_medium_precision_raises():
    with pytest.raises(ValueError, match="precision"):
        CRTEngine(EffectParams(), 48, 64, 24.0, precision="medium", device="cpu")


def test_fast_plan_stages_no_tables():
    """The direct-pow triad's plan drops the two 1025-entry tables from a
    block's shared memory for its pow sites' table (csrc/triad_pow.cuh,
    DIRECT_TAB floats, built into the kernel), and its consts carry none;
    the key tells the two plans apart."""
    kw = dict(sigma=1.2, strength=0.25, px=2, ab=1, triad=True, triad_gamma=2.2)
    exact = tfused.build_fused_spec(1080, 1920, **kw)
    fast = tfused.build_fused_spec(1080, 1920, **kw, lut_exact=False)
    ce, cf = tfused.fused_consts(exact), tfused.fused_consts(fast)
    assert tfused.triad_mode(exact) == 2 and tfused.triad_mode(fast) == 3
    assert cf.lut_fwd is None and ce.lut_fwd is not None
    assert ce.plan.smem - cf.plan.smem == (2 * 1028 - tfused.DIRECT_TAB) * 4
    assert cf.plan.key == tfused.plan_key(fast) != tfused.plan_key(exact)
    with pytest.raises(ValueError, match="not made for this spec"):
        tfused.check_plan(fast, ce)
    split = tfused.build_fused_spec(1, 1, sigma=15000 / 3, strength=0.6, px=1, ab=1,
                                    triad=True, lut_exact=False)
    sc = tfused.fused_consts(split)
    assert sc.plan.split  # the three-launch route: its epilogue keeps the mode
    post = sc.split[3]
    assert not post.lut_exact and tfused.triad_mode(post) == 3
