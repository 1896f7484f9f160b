"""Time-addressed engine calls of the port (CRTEngine.make_aux_at and
process_at, the GUI preview's access) against the JAX engine's, on the
CPU (the kernels' plain twins), with seeded frames, times and noise
fields.

Contract: make_aux_at equals the JAX make_aux_at field for field (the
same f64 host math and oracle glitch fields); process_at is within 1
uint8 LSB of the JAX engine's process_at (its XLA path; its bf16 grain
truncation is a known delta, ROADMAP.md queue 3) and within 1 LSB of the
oracle with fewer than 1e-3 of values off; at t = idx / fps it is bit
for bit process(idx), with host rng and with native rng, whose streams
are those of rint(t * fps). make_aux keeps its results."""

import numpy as np
import pytest

from pythoncrt_tpu import CRTEngine as JaxEngine
from pythoncrt_tpu import oracle as joracle
from pythoncrt_tpu_torch import CRTEngine, EffectParams

from conftest import synth_frames
from test_fused import FULL

H, W, FPS = 45, 67, 30.0  # odd sizes, as the preview's fit-downscale gives
C4 = dict(scanline_strength=0.6, triad_strength=0.35, aberration_px=1, bloom_strength=0.25,
          fast_bloom=True, noise_strength=1.5, vignette_strength=0.25, persistence=0.6,
          pixel_size=1, glitch_amp_px=6, glitch_height_frac=0.3, scanline_speed_px_s=120.0)
CONFIGS = {
    "defaults": {},
    "c3": FULL,
    "c4": C4,
    "c4_flicker_grain2": dict(C4, flicker_strength=0.4, flicker_hz=3.0, grain_size=2),
    "defaults_angled": dict(scanline_angle=12.0, scanline_thickness=2.0),
}
TIMES = np.array([0.0, 0.37, 1.2345, 2.5, 7.0 / 3.0])


def lsb(a, b):
    d = np.abs(np.asarray(a).astype(np.int32) - np.asarray(b).astype(np.int32))
    return int(d.max()), float((d > 0).mean())


def fields(p, n, seed):
    """Seeded host noise fields of the engine's grain shape."""
    g = max(1, p.grain_size)
    gh, gw = (max(1, H // g), max(1, W // g)) if g > 1 else (H, W)
    return np.random.default_rng(seed).standard_normal((n, gh, gw), dtype=np.float32)


def as_np(x):
    return None if x is None else np.asarray(x)


@pytest.mark.parametrize("mode", ["preview", "export"])
@pytest.mark.parametrize("cfg", ["c4", "c4_flicker_grain2"])
def test_make_aux_at_matches_jax(cfg, mode):
    p = EffectParams(**CONFIGS[cfg]).clamped()
    noise = fields(p, len(TIMES), seed=7)
    mine = CRTEngine(p, H, W, FPS, engine=mode, rng="host", device="cpu").make_aux_at(
        TIMES, noise)
    theirs = JaxEngine(p, H, W, FPS, engine=mode, rng="host", pallas="off").make_aux_at(
        TIMES, noise)
    assert mine._fields == theirs._fields
    for name in mine._fields:
        a, b = getattr(mine, name), as_np(getattr(theirs, name))
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_array_equal(a, b, err_msg=name)
    assert mine.glitch_base is not None and (mine.glitch_seg is None) == (mode == "preview")
    if p.flicker_on:
        assert not np.all(mine.flicker == 1.0)
    np.testing.assert_array_equal(mine.frame_idx, np.rint(TIMES * FPS))


def test_make_aux_at_needs_the_noise_with_host_rng():
    p = EffectParams(**C4)
    for eng in (CRTEngine(p, H, W, FPS, rng="host", device="cpu"),
                JaxEngine(p, H, W, FPS, rng="host", pallas="off")):
        with pytest.raises(ValueError, match="needs injected noise_fields"):
            eng.make_aux_at(TIMES)
    # no grain, no fields needed; native rng draws its own
    CRTEngine(EffectParams(noise_strength=0.0), H, W, FPS, rng="host",
              device="cpu").make_aux_at(TIMES)
    CRTEngine(p, H, W, FPS, device="cpu").make_aux_at(TIMES)


@pytest.mark.parametrize("mode", ["preview", "export"])
@pytest.mark.parametrize("cfg", sorted(CONFIGS))
def test_process_at_matches_jax_and_oracle(cfg, mode):
    """Three frames at three wall-clock times, the persistence state
    carried from the first: <= 1 LSB against the JAX engine's process_at
    and against the oracle given the same f64 times and noise fields."""
    p = EffectParams(**CONFIGS[cfg]).clamped()
    frames = synth_frames(3, H, W, seed=11)
    times = np.array([0.21, 0.7533, 1.9])
    noise = fields(p, 3, seed=5) if p.noise_on else None
    got, _ = CRTEngine(p, H, W, FPS, engine=mode, rng="host", device="cpu").process_at(
        frames, times, noise)
    got = got.numpy()
    assert got.shape == (3, H, W, 3) and got.dtype == np.uint8
    jx = JaxEngine(p, H, W, FPS, engine=mode, rng="host", pallas="off")
    xla = np.asarray(jx.process_at(frames, times, noise)[0])
    mx, frac = lsb(got, xla)
    assert mx <= 1, f"vs the JAX engine's process_at: max {mx} LSB, {frac:.2e} off"
    prev, want = None, []
    for j, t in enumerate(times):
        img = joracle.apply_effects(frames[j], p, phase_px=t * p.scanline_speed_px_s,
                                    time_sec=t, noise_field=None if noise is None else noise[j],
                                    engine=mode)
        prev = joracle.persistence_blend(prev, img, p.persistence if p.persistence_on else 0.0)
        want.append(joracle.ops.to_uint8(prev))
    mx, frac = lsb(got, np.stack(want))
    assert mx <= 1 and frac < 1e-3, f"vs the oracle: max {mx} LSB, {frac:.2e} off"


@pytest.mark.parametrize("cfg", ["c3", "c4", "c4_flicker_grain2"])
def test_process_at_frame_times_is_process_host_rng(cfg):
    """At t = idx / fps, with the fields make_aux draws for idx,
    process_at gives process(idx)'s bytes and state, over two batches."""
    p = EffectParams(**CONFIGS[cfg]).clamped()
    frames = synth_frames(6, H, W, seed=12)
    eng = CRTEngine(p, H, W, FPS, rng="host", seed=4, device="cpu")
    st_a = st_b = None
    for k in range(2):
        idx = np.arange(3 * k, 3 * k + 3) + 17
        a, st_a = eng.process(frames[3 * k:3 * k + 3], idx, st_a)
        b, st_b = eng.process_at(frames[3 * k:3 * k + 3], idx / FPS, eng.make_aux(idx).noise,
                                 st_b)
        assert np.array_equal(a.numpy(), b.numpy()) and np.array_equal(st_a.numpy(),
                                                                       st_b.numpy())


@pytest.mark.parametrize("mode", ["preview", "export"])
def test_native_streams_follow_rint_of_time(mode):
    """With native rng the grain and glitch streams of time t are those of
    frame rint(t * fps) (two ticks in one frame share them); at
    t = idx / fps process_at is process(idx) bit for bit."""
    p = EffectParams(**C4)
    eng = CRTEngine(p, H, W, FPS, engine=mode, seed=3, device="cpu")
    times = np.array([0.0, 0.49, 0.51, 1.0, 1.49]) / FPS + 2.0
    at, idx = eng.make_aux_at(times), eng.make_aux(np.rint(times * FPS))
    np.testing.assert_array_equal(at.frame_idx, [60, 60, 61, 61, 61])
    assert at.noise is None and at.glitch_base is None
    assert np.array_equal(eng._grain_field(at).numpy(), eng._grain_field(idx).numpy())
    assert np.array_equal(eng.glitch_offsets(at).numpy(), eng.glitch_offsets(idx).numpy())
    frames = synth_frames(4, H, W, seed=13)
    n = np.arange(4) + 9
    a, sa = eng.process(frames, n)
    b, sb = eng.process_at(frames, n / FPS)
    assert np.array_equal(a.numpy(), b.numpy()) and np.array_equal(sa.numpy(), sb.numpy())


@pytest.mark.parametrize("mode", ["preview", "export"])
@pytest.mark.parametrize("cfg", ["c3", "c4_flicker_grain2"])
def test_make_aux_is_unchanged(cfg, mode):
    """make_aux, now sharing its body with make_aux_at, still equals the
    JAX make_aux field for field (index-keyed host noise included)."""
    p = EffectParams(**CONFIGS[cfg]).clamped()
    idx = np.array([0, 1, 5, 29, 30, 1001])
    mine = CRTEngine(p, H, W, FPS, engine=mode, rng="host", seed=2, device="cpu").make_aux(idx)
    theirs = JaxEngine(p, H, W, FPS, engine=mode, rng="host", seed=2, pallas="off").make_aux(idx)
    for name in mine._fields:
        a, b = getattr(mine, name), as_np(getattr(theirs, name))
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_array_equal(a, b, err_msg=name)
    assert mine.frame_idx.dtype == np.int64


def test_process_at_checks_shapes():
    eng = CRTEngine(EffectParams(), H, W, FPS, rng="host", device="cpu")
    with pytest.raises(ValueError, match="frames"):
        eng.process_at(np.zeros((1, H + 1, W, 3), np.uint8), [0.0], fields(eng.params, 1, 0))
    with pytest.raises(ValueError, match="state shape"):
        eng.process_at(np.zeros((1, H, W, 3), np.uint8), [0.0], fields(eng.params, 1, 0),
                       state=np.zeros((3, H, W), np.float32))
