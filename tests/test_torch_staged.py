"""The port's staged step (2-D scanlines: torch ops, the stand-alone bloom
kernel, torch ops) and its text overlays, on the CPU (the kernels' plain
twins), against three references on the same frames, overlay and
host-rng noise fields: the oracle, the JAX engine's XLA path and the JAX
engine with its Pallas kernels in interpret mode.

Contract: <= 1 uint8 LSB against each, and fewer than 1e-3 of values off
against the oracle. Against the JAX XLA path the port is also held to
fewer than 1e-3 of values off where that path agrees with the oracle
(its grain upsample truncates the noise field to bf16, ROADMAP.md queue
3); against the Pallas path (a uint8-rounded warp feed as well) only the
max LSB is asserted, as in test_torch_engine.py. The JAX engine is shown
to take the same routes: bloom3 with its fused kernel refused for 2-D
scanlines, its fused kernel's pre=False mode for text before the bloom.

The JAX engine's bloom opt-ins (PCRT_PALLAS_BLOOM, PCRT_BLOOM2_GAUSS,
PCRT_BLOOM2_FAST) send the step through the staged step with the stripe
bloom or bloom2 as stage 6, in both engines. Measured at 48x256 over 8
frames (NHWC): c3 with bloom2 gaussian and with the stripe 1 LSB off the
oracle on 3.4e-06 of values, defaults with bloom2 fast equal to it, c4
with text before and bloom2 fast 1 LSB on 6.8e-06; against the JAX
engine with the same variable 1 LSB on 12.6% (c3: its uint8 warp feed
and bf16 grain, ROADMAP.md queue 3) and on 2.7e-04 to 4.6e-04 (the
others: its FMA-contracted persistence blend).
"""

import dataclasses

import numpy as np
import pytest
import torch

from pythoncrt_tpu import CRTEngine as JaxEngine
from pythoncrt_tpu import EffectParams as JaxParams
from pythoncrt_tpu import TextParams as JaxText
from pythoncrt_tpu_torch import CRTEngine, EffectParams, TextParams, oracle
from pythoncrt_tpu_torch.kernels import bloom3 as kbloom3

from conftest import synth_frames
from test_engine_vs_oracle import IDENTITY, STAGE_CASES
from test_fused import FULL
from test_torch_engine import C4, lsb

H, W, B, FPS = 48, 256, 4, 24.0

STAGED = {
    "scan_2d": {**IDENTITY, **STAGE_CASES["scan_2d"]},
    "scan_thick": {**IDENTITY, **STAGE_CASES["scan_thick"]},
    "c3_angled": {**IDENTITY, **FULL, "scanline_angle": 5.0, "scanline_thickness": 1.5},
    "defaults_angled": {"scanline_angle": 12.0, "scanline_thickness": 2.0},
}
TEXT = {"c3": {**IDENTITY, **FULL}, "c4": {**IDENTITY, **C4}}


def params(overrides, text=None):
    """The same configuration as the port's and the JAX package's params."""
    t = {} if text is None else dataclasses.asdict(text)
    return (EffectParams(**overrides, text=TextParams(**t)),
            JaxParams(**overrides, text=JaxText(**t)))


def overlay(seed=7):
    """A seeded RGBA overlay: random colour and alpha in a box, clear elsewhere."""
    rng = np.random.default_rng(seed)
    ov = np.zeros((H, W, 4), np.uint8)
    ov[6:30, 20:150] = rng.integers(0, 256, (24, 130, 4), dtype=np.uint8)
    ov[12:20, 40:90, 3] = 255
    return ov


def to_planar(x):
    return np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))[:, [1, 2, 0]])


def from_planar(x):
    return np.transpose(np.asarray(x)[:, [2, 0, 1]], (0, 2, 3, 1))


def run(eng, frames, planar):
    """Two batches through eng.process with the state carried; NHWC RGB out."""
    outs, state = [], None
    for k in range(2):
        idx = np.arange(k * B, (k + 1) * B)
        x = to_planar(frames[idx]) if planar else frames[idx]
        out, state = eng.process(x, idx, state)
        out = out.numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
        outs.append(from_planar(out) if planar else out)
    return np.concatenate(outs)


def oracle_stream(eng, frames, ov):
    aux = eng.make_aux(np.arange(frames.shape[0]))
    p, prev, outs = eng.params, None, []
    for j in range(frames.shape[0]):
        img = oracle.apply_effects(frames[j], p, phase_px=float(aux.phase[j]),
                                   time_sec=j / FPS, text_rgba=ov,
                                   noise_field=None if aux.noise is None else aux.noise[j])
        prev = oracle.persistence_blend(prev, img, p.persistence if p.persistence_on else 0.0)
        outs.append(oracle.ops.to_uint8(prev))
    return np.stack(outs)


def check_three_ways(overrides, layout, text=None, ov=None, route=None):
    planar = layout == "planar_gbr"
    kw = dict(layout="planar", channel_order="gbr") if planar else {}
    tp, jp = params(overrides, text)
    frames = synth_frames(2 * B, H, W, seed=13)
    eng = CRTEngine(tp, H, W, FPS, rng="host", device="cpu", text_rgba=ov, **kw)
    got = run(eng, frames, planar)
    assert got.shape == (2 * B, H, W, 3) and got.dtype == np.uint8

    want = oracle_stream(eng, frames, ov if tp.text.enabled else None)
    mx, frac = lsb(got, want)
    assert mx <= 1 and frac < 1e-3, f"vs oracle: max {mx} LSB, {frac:.2e} off"

    xla = run(JaxEngine(jp, H, W, FPS, rng="host", pallas="off", text_rgba=ov, **kw),
              frames, planar)
    mx, frac = lsb(got, xla)
    own = float(((got != xla) & (xla == want)).mean())
    assert mx <= 1 and own < 1e-3, f"vs XLA: max {mx} LSB, {frac:.2e} off ({own:.2e} own)"

    pk = JaxEngine(jp, H, W, FPS, rng="host", pallas="on", interpret=True, text_rgba=ov, **kw)
    route(pk, tp)
    mx, frac = lsb(got, run(pk, frames, planar))
    assert mx <= 1, f"vs Pallas interpret: max {mx} LSB, {frac:.2e} off"
    return eng


def staged_route(pk, p):
    assert not pk._pallas_fused and pk._pallas_bloom3 == p.bloom_on


@pytest.mark.parametrize("layout", ["nhwc", "planar_gbr"])
@pytest.mark.parametrize("name", sorted(STAGED))
def test_staged_step_matches_oracle_and_jax(name, layout):
    eng = check_three_ways(STAGED[name], layout, route=staged_route)
    assert eng._staged and (eng.bloom3_spec is not None) == eng.params.bloom_on


@pytest.mark.parametrize("after", [False, True], ids=["before", "after"])
@pytest.mark.parametrize("name", sorted(TEXT))
def test_text_overlay_matches_oracle_and_jax(name, after):
    """Text composited before the bloom (in the fused kernel's prologue,
    over the overlay's box; the JAX engine takes its kernel's pre=False)
    and after the warp."""
    def route(pk, p):
        assert pk._pallas_fused and pk._fused_spec.pre is after

    text = TextParams(text="CH 3", size=12, after=after)
    layout = "planar_gbr" if name == "c4" else "nhwc"
    eng = check_three_ways(TEXT[name], layout, text, overlay(), route)
    assert not eng._staged and eng.spec.pre and bool(eng.spec.text_box) is not after
    assert eng.text_route == ("after" if after else "fused")


def test_text_with_2d_scanlines_matches_oracle_and_jax():
    """c3 with angled scanlines and text after the warp: the staged step
    (bloom3 gaussian) with the warp's output kept f32 for the overlay."""
    text = TextParams(text="CH 3", size=12, after=True)
    eng = check_three_ways(STAGED["c3_angled"], "planar_gbr", text, overlay(3), staged_route)
    assert eng._staged and not eng._warp_u8 and eng.spec.emit == "f32"


@pytest.mark.parametrize("name", ["c3", "defaults", "c4"])
def test_staged_step_is_the_fused_step_on_1d_scanlines(name, monkeypatch):
    """Forced onto a 1-D-scanline configuration, the staged step (torch
    prologue, stand-alone bloom, torch epilogue) gives the fused step's
    bits on the CPU, state carried."""
    overrides = {"c3": {**IDENTITY, **FULL}, "defaults": {}, "c4": {**IDENTITY, **C4}}[name]
    p = EffectParams(**overrides)
    frames = synth_frames(2 * B, H, W, seed=21)
    fused = run(CRTEngine(p, H, W, FPS, seed=4, device="cpu"), frames, False)
    calls = []
    for fn in ("bloom3_planar", "bloom3_fast_planar"):
        orig = getattr(kbloom3, fn)
        monkeypatch.setattr(kbloom3, fn, lambda *a, _f=orig, **k: calls.append(1) or _f(*a, **k))
    eng = CRTEngine(p, H, W, FPS, seed=4, device="cpu")
    assert not eng._staged
    eng._staged = True
    staged = run(eng, frames, False)
    assert len(calls) == 2
    np.testing.assert_array_equal(staged, fused)


def test_2d_mask_matches_the_oracle():
    """The per-batch 2-D mask against oracle.scanline_mask_2d: the sin
    and pow differ from NumPy's f32 forms by at most an ulp or so."""
    p = EffectParams(scanline_angle=12.0, scanline_thickness=2.0, scanline_speed_px_s=97.0)
    eng = CRTEngine(p, H, W, FPS, device="cpu")
    phase = eng.make_aux(np.arange(5, 9)).phase
    got = eng._scanline_mask_2d(phase).numpy()
    want = np.stack([oracle.scanline_mask_2d(H, W, p.scanline_strength, p.scanline_period_px,
                                             float(ph), p.scanline_angle,
                                             p.scanline_thickness) for ph in phase])
    assert got.shape == (4, H, W) and got.dtype == np.float32
    assert np.abs(got - want).max() <= 2e-6


# The JAX engine's bloom opt-ins (environment variables read when the
# engine is built): the named kernel becomes the staged step's stage 6.
OPTINS = {  # name -> (variables, overrides, text before the bloom, route)
    "c3_bloom2_gauss": ({"PCRT_BLOOM2_GAUSS": "1"}, {**IDENTITY, **FULL}, False, "bloom2"),
    "c3_stripe": ({"PCRT_PALLAS_BLOOM": "1"}, {**IDENTITY, **FULL}, False, "stripe"),
    "defaults_bloom2_fast": ({"PCRT_BLOOM2_FAST": "1"}, {}, False, "bloom2"),
    "c4_text_bloom2_fast": ({"PCRT_BLOOM2_FAST": "1"}, {**IDENTITY, **C4}, True, "bloom2"),
}


@pytest.mark.parametrize("layout", ["nhwc", "planar_gbr"])
@pytest.mark.parametrize("name", sorted(OPTINS))
def test_bloom_optins_match_oracle_and_jax(name, layout, monkeypatch):
    """Each opt-in against the oracle, the JAX XLA path and the JAX engine
    with the same variable (its bloom2 or stripe kernel in interpret
    mode), two batches with the state carried."""
    env, overrides, text_before, route = OPTINS[name]
    for k, v in env.items():
        monkeypatch.setenv(k, v)

    def jax_route(pk, p):
        assert not pk._pallas_fused
        assert (pk._pallas_bloom2, pk._pallas_bloom) == (route == "bloom2", route == "stripe")

    text = TextParams(text="CH 3", size=12, after=False) if text_before else None
    eng = check_three_ways(overrides, layout, text, overlay(5) if text_before else None,
                           jax_route)
    assert eng.bloom_route == route and eng._staged and eng.bloom_spec is not None


PRECEDENCE = [  # variables, overrides, the port's route, the JAX flags (or None: not read)
    ({"PCRT_BLOOM2_GAUSS": "1"}, {}, "fused", "fused"),  # the fast bloom stays fused
    ({"PCRT_PALLAS_BLOOM": "1"}, {}, "fused", "fused"),  # the stripe is gaussian only
    ({"PCRT_BLOOM2_FAST": "1"}, FULL, "fused", "fused"),
    ({"PCRT_PALLAS_BLOOM": "1", "PCRT_BLOOM2_FAST": "1"}, {}, "bloom2", "bloom2"),
    ({"PCRT_PALLAS_BLOOM": "1", "PCRT_BLOOM2_GAUSS": "1"}, FULL, "stripe", "stripe"),
    ({"PCRT_BLOOM2_GAUSS": "1"}, {**FULL, "scanline_angle": 5.0}, "bloom2", "bloom2"),
    ({"PCRT_PALLAS_BLOOM": "1"}, {**FULL, "bloom_strength": 0.0}, "none", "fused"),
    ({"PCRT_PALLAS_BLOOM": "0", "PCRT_BLOOM2_GAUSS": "yes"}, FULL, "fused", "fused"),
    ({"PCRT_NO_BLOOM3": "1"}, {"scanline_angle": 12.0}, "bloom3", None),
    ({"PCRT_NO_FUSED": "1", "PCRT_FUSED_EPI": "xla"}, {}, "fused", None),
]


@pytest.mark.parametrize("env,overrides,route,jax", PRECEDENCE,
                         ids=[f"{'+'.join(sorted(e))}-{r}-{i}" for i, (e, _, r, _j)
                              in enumerate(PRECEDENCE)])
def test_bloom_route_precedence_matches_jax(env, overrides, route, jax, monkeypatch):
    """The JAX engine's precedence (engine.py:286-356): the stripe for the
    gaussian bloom first, then bloom2 of the params' own variant, then the
    default routes; the A/B variables that pick an XLA form are not read."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    tp, jp = params(overrides)
    eng = CRTEngine(tp, H, W, FPS, device="cpu")
    assert eng.bloom_route == route
    assert eng._staged == (route not in ("fused", "none")
                           or (tp.scanlines_on and not tp.scanlines_1d))
    if jax is not None:
        pk = JaxEngine(jp, H, W, FPS, pallas="on", interpret=True)
        assert pk._pallas_fused == (jax == "fused")
        assert (pk._pallas_bloom2, pk._pallas_bloom) == (jax == "bloom2", jax == "stripe")
