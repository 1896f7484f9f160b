"""The port's c3 slice as a whole (pythoncrt_tpu_torch.CRTEngine on the
CPU, i.e. the kernels' plain twins) against the oracle, the JAX engine's
XLA path and the JAX engine with its Pallas kernels in interpret mode,
on the same frames and the same host-rng noise fields.

Contract: <= 1 uint8 LSB against each, and fewer than 1e-3 of values
off against the oracle. The JAX XLA path itself departs from the oracle
where its grain upsample truncates the noise field to bf16 (ROADMAP.md
queue 3, known reference-side deltas); against it the port is held to
<= 1 LSB and to fewer than 1e-3 of values off where it agrees with the
oracle. The Pallas path also warps a uint8-rounded feed (the TPU's
int-domain trick, <= 1 LSB by construction), so against it only the
max LSB is asserted."""

import numpy as np
import pytest

from pythoncrt_tpu import CRTEngine as JaxEngine
from pythoncrt_tpu_torch import CRTEngine

from conftest import synth_frames
from test_engine_vs_oracle import identity_params, render_oracle
from test_fused import FULL

H, W, B, FPS = 48, 256, 4, 24.0


def lsb(a, b):
    d = np.abs(np.asarray(a).astype(np.int32) - np.asarray(b).astype(np.int32))
    return int(d.max()), float((d > 0).mean())


def to_nhwc(out, layout):
    out = out.numpy()
    if layout == "planar_gbr":  # planes G, B, R -> RGB
        out = np.transpose(out[:, [2, 0, 1]], (0, 2, 3, 1))
    return out


@pytest.mark.parametrize("layout", ["nhwc", "planar_gbr"])
def test_c3_slice_matches_oracle_and_jax(layout):
    p = identity_params(**FULL)
    frames = synth_frames(2 * B, H, W, seed=3)
    kw = dict(layout="planar", channel_order="gbr") if layout == "planar_gbr" else {}
    eng = CRTEngine(p, H, W, FPS, rng="host", device="cpu", **kw)
    outs = []
    for k in range(2):  # two consecutive batches, frame indices continuing
        idx = np.arange(k * B, (k + 1) * B)
        x = frames[idx]
        if layout == "planar_gbr":
            x = np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))[:, [1, 2, 0]])
        out, _ = eng.process(x, idx)
        outs.append(to_nhwc(out, layout))
    got = np.concatenate(outs)
    assert got.shape == (2 * B, H, W, 3) and got.dtype == np.uint8

    jx = JaxEngine(p, H, W, FPS, rng="host", pallas="off")
    want = render_oracle(jx, frames)
    mx, frac = lsb(got, want)
    assert mx <= 1 and frac < 1e-3, f"vs oracle: max {mx} LSB, {frac:.2e} off"

    xla = np.concatenate([np.asarray(jx.process(frames[k * B:(k + 1) * B],
                                                np.arange(k * B, (k + 1) * B))[0])
                          for k in range(2)])
    mx, frac = lsb(got, xla)
    mx_ref, frac_ref = lsb(xla, want)
    own = float(((got != xla) & (xla == want)).mean())
    assert mx <= 1 and own < 1e-3, (
        f"vs XLA: max {mx} LSB, {frac:.2e} off ({own:.2e} where XLA matches the "
        f"oracle; XLA vs oracle: max {mx_ref}, {frac_ref:.2e} off)")

    pk = JaxEngine(p, H, W, FPS, rng="host", pallas="on", interpret=True)
    assert pk._pallas_fused and pk._pallas_warp
    pal = np.asarray(pk.process(frames[:B], np.arange(B))[0])
    mx, frac = lsb(got[:B], pal)
    assert mx <= 1, f"vs Pallas interpret: max {mx} LSB, {frac:.2e} off"


@pytest.mark.parametrize("name,overrides", [
    ("c1_scan_vig", dict(scanline_strength=0.6, vignette_strength=0.25, bloom_strength=0.0)),
    ("c2_retro", dict(scanline_strength=0.6, triad_strength=0.35, triad_softness=0.5,
                      aberration_px=2, noise_strength=4.0, bloom_strength=0.0)),
    ("px3_luma_knee", {**FULL, "pixel_size": 3, "triad_preserve_luma": True,
                       "bloom_threshold": 0.3, "warp_strength": -0.3}),
    ("triad_g1", {**FULL, "triad_gamma": 1.0}),
])
def test_slice_variants_match_oracle(name, overrides):
    """Configs the JAX engine routes around its kernels (bloom off,
    pixel size 3, the triad's multiply-only form) all run the port's
    two kernels and still meet the oracle contract."""
    p = identity_params(**overrides)
    frames = synth_frames(B, H, W, seed=5)
    got = CRTEngine(p, H, W, FPS, rng="host", device="cpu").process(frames)[0].numpy()
    want = render_oracle(JaxEngine(p, H, W, FPS, rng="host", pallas="off"), frames)
    mx, frac = lsb(got, want)
    assert mx <= 1 and frac < 1e-3, f"{name}: vs oracle max {mx} LSB, {frac:.2e} off"


C4 = dict(scanline_strength=0.6, triad_strength=0.35, aberration_px=1, bloom_strength=0.25,
          fast_bloom=True, noise_strength=1.5, vignette_strength=0.25, persistence=0.6,
          pixel_size=1, glitch_amp_px=6, glitch_height_frac=0.3, scanline_speed_px_s=120.0)
TEMPORAL = {"defaults": {}, "c4": C4}


def run_batches(eng, frames, nb, planar=False):
    """nb consecutive batches through eng.process, the state carried."""
    b = frames.shape[0] // nb
    outs, state = [], None
    for k in range(nb):
        idx = np.arange(k * b, (k + 1) * b)
        x = frames[idx]
        if planar:
            x = np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2)))
        out, state = eng.process(x, idx, state)
        out = np.asarray(out)
        outs.append(np.transpose(out, (0, 2, 3, 1)) if planar else out)
    return np.concatenate(outs), state


def oracle_stream(eng, frames):
    """The oracle's chain frame by frame, then persistence_blend in
    sequence, then to_uint8, on the port engine's own host-rng aux."""
    from pythoncrt_tpu_torch import oracle

    aux = eng.make_aux(np.arange(frames.shape[0]))
    p, prev, outs = eng.params, None, []
    for j in range(frames.shape[0]):
        img = oracle.apply_effects(frames[j], p, phase_px=float(aux.phase[j]),
                                   time_sec=j / eng.fps,
                                   noise_field=None if aux.noise is None else aux.noise[j],
                                   engine=eng.engine)
        prev = oracle.persistence_blend(prev, img, p.persistence if p.persistence_on else 0.0)
        outs.append(oracle.ops.to_uint8(prev))
    return np.stack(outs)


@pytest.mark.parametrize("engine_mode", ["export", "preview"])
@pytest.mark.parametrize("name", sorted(TEMPORAL))
def test_temporal_slice_matches_oracle_and_jax(name, engine_mode):
    """The CLI defaults (fast bloom, persistence 0.2) and c4 (fast bloom,
    glitch, persistence 0.6), host rng, two batches with the state
    carried: <= 1 LSB and fewer than 1e-3 of values off against the
    oracle and against the JAX engine's XLA path."""
    from pythoncrt_tpu import EffectParams as JaxParams
    from pythoncrt_tpu_torch import EffectParams

    frames = synth_frames(2 * B, H, W, seed=6)
    eng = CRTEngine(EffectParams(**TEMPORAL[name]), H, W, FPS, rng="host", engine=engine_mode,
                    device="cpu")
    got, _ = run_batches(eng, frames, 2)
    mx, frac = lsb(got, oracle_stream(eng, frames))
    assert mx <= 1 and frac < 1e-3, f"{name}/{engine_mode} vs oracle: {mx} LSB, {frac:.2e}"
    jx = JaxEngine(JaxParams(**TEMPORAL[name]), H, W, FPS, rng="host", engine=engine_mode,
                   pallas="off")
    want, _ = run_batches(jx, frames, 2)
    mx, frac = lsb(got, want)
    assert mx <= 1 and frac < 1e-3, f"{name}/{engine_mode} vs JAX: {mx} LSB, {frac:.2e}"


def test_c4_matches_jax_pallas_kernels():
    """c4 through the JAX engine's kernels in interpret mode (fused fast
    core, planar glitch, persistence scan) on planar gbrp frames."""
    from pythoncrt_tpu import EffectParams as JaxParams
    from pythoncrt_tpu_torch import EffectParams

    frames = synth_frames(B, H, W, seed=8)
    x = np.ascontiguousarray(np.transpose(frames, (0, 3, 1, 2))[:, [1, 2, 0]])
    kw = dict(rng="host", layout="planar", channel_order="gbr")
    got = CRTEngine(EffectParams(**C4), H, W, FPS, device="cpu", **kw).process(x)[0].numpy()
    pk = JaxEngine(JaxParams(**C4), H, W, FPS, pallas="on", interpret=True, **kw)
    assert pk._pallas_fused and pk._pallas_glitch and pk._pallas_persist
    mx, frac = lsb(got, np.asarray(pk.process(x)[0]))
    assert mx <= 1 and frac < 1e-3, f"vs Pallas interpret: max {mx} LSB, {frac:.2e} off"


@pytest.mark.parametrize("first", [True, False])
def test_assoc_scan_matches_jax(first):
    """The O(log B) persistence scan against the JAX engine's
    _assoc_persistence (a lax.associative_scan): <= 1 LSB."""
    from pythoncrt_tpu import EffectParams as JaxParams
    from pythoncrt_tpu_torch import EffectParams

    import jax.numpy as jnp
    import torch

    rng = np.random.default_rng(4)
    imgs = rng.random((7, 3, 8, 16), dtype=np.float32)
    state = rng.random((3, 8, 16), dtype=np.float32)
    p = dict(persistence=0.7)
    eng = CRTEngine(EffectParams(**p), 8, 16, FPS, assoc_scan=True, device="cpu")
    out, ns = eng._assoc_persistence(torch.from_numpy(imgs), torch.from_numpy(state), first)
    jx = JaxEngine(JaxParams(**p), 8, 16, FPS, assoc_scan=True, pallas="off")
    out0 = imgs[0] if first else np.clip(np.float32(0.7) * state + np.float32(0.3) * imgs[0],
                                          0, 1)
    rest = np.asarray(jx._assoc_persistence(jnp.asarray(imgs[1:]), jnp.asarray(out0)))
    want = np.concatenate([out0[None], rest])
    assert np.abs(ns.numpy() - want[-1]).max() <= 2e-6
    mx, _ = lsb(out.numpy(), np.clip(np.rint(want * 255.0), 0, 255))
    assert mx <= 1
    seq, _ = eng.process(np.ascontiguousarray(np.transpose(
        (imgs * 255).astype(np.uint8), (0, 2, 3, 1))))
    kernel_path = CRTEngine(EffectParams(**p), 8, 16, FPS, device="cpu").process(
        np.ascontiguousarray(np.transpose((imgs * 255).astype(np.uint8), (0, 2, 3, 1))))[0]
    assert lsb(seq.numpy(), kernel_path.numpy())[0] <= 1


def test_c3_raw_grain_matches_jax_grain_raw_branch_and_oracle():
    """c3 (grain size 2), host rng: the fused twin's raw-grain mode (the
    raw field upsampled in the epilogue, the port's counterpart of the
    JAX kernel's grain_raw branch) against the JAX engine's kernels in
    interpret mode, which take that branch: <= 1 LSB, and off on no more
    values than the JAX path is off the oracle (its bf16 column dot and
    uint8 warp feed, ROADMAP.md queue 3) plus 1e-3; against the oracle
    <= 1 LSB on fewer than 1e-3 of values."""
    p = identity_params(**FULL)
    frames = synth_frames(B, H, W, seed=9)
    eng = CRTEngine(p, H, W, FPS, rng="host", device="cpu")
    assert eng.spec.grain_size == 2 and eng.fused_tables.grain_taps is not None
    got = eng.process(frames)[0].numpy()
    want = render_oracle(JaxEngine(p, H, W, FPS, rng="host", pallas="off"), frames)
    mx, frac = lsb(got, want)
    assert mx <= 1 and frac < 1e-3, f"vs oracle: max {mx} LSB, {frac:.2e} off"
    pk = JaxEngine(p, H, W, FPS, rng="host", pallas="on", interpret=True)
    assert pk._pallas_fused and pk._fused_spec.grain_g == 2 and pk._fused_spec.grain_raw
    pal = np.asarray(pk.process(frames, np.arange(B))[0])
    mx, frac = lsb(got, pal)
    _, frac_pal = lsb(pal, want)
    assert mx <= 1 and frac <= frac_pal + 1e-3, (
        f"vs Pallas interpret: max {mx} LSB, {frac:.2e} off (the JAX path vs the oracle: "
        f"{frac_pal:.2e})")


TEXT_ROUTES = {  # text_route -> (params overrides, text after or None)
    "fused": (C4, False),
    "torch": ({**C4, "scanline_angle": 12.0, "scanline_thickness": 2.0}, False),
    "after": (C4, True),
    "none": (C4, None),
}


@pytest.mark.parametrize("route", sorted(TEXT_ROUTES))
def test_text_route_names_where_the_text_is_composited(route, monkeypatch):
    """``text_route``: "fused" (text before the bloom in the fused
    kernel's prologue: no torch ops of stages 1-5), "torch" (the staged
    step's ``_pre_bloom``), "after" (stage 13) or "none"; chosen from the
    overlay and the step's kind alone. A clear overlay has no box to
    composite: the fused kernel runs without one."""
    from pythoncrt_tpu_torch import EffectParams, TextParams

    import torch

    over, after = TEXT_ROUTES[route]
    text = TextParams() if after is None else TextParams(text="T", after=after)
    ov = np.zeros((H, W, 4), np.uint8)
    ov[5:20, 30:90] = np.random.default_rng(2).integers(0, 256, (15, 60, 4))
    ov[5, 30, 3] = ov[19, 89, 3] = 200
    eng = CRTEngine(EffectParams(**over, text=text), H, W, FPS, rng="host", device="cpu",
                    text_rgba=ov, layout="planar")
    assert eng.text_route == route and eng.spec.pre
    assert eng.spec.text_box == ((5, 20, 30, 90) if route == "fused" else ())
    calls = []
    orig = eng._pre_bloom
    monkeypatch.setattr(eng, "_pre_bloom", lambda x: calls.append(1) or orig(x))
    x = np.ascontiguousarray(np.transpose(synth_frames(B, H, W, seed=2), (0, 3, 1, 2)))
    out, _ = eng.process(x)
    assert bool(calls) == (route == "torch")
    if route == "fused":
        clear = CRTEngine(EffectParams(**over, text=text), H, W, FPS, rng="host", device="cpu",
                          text_rgba=np.zeros_like(ov), layout="planar")
        plain = CRTEngine(EffectParams(**over), H, W, FPS, rng="host", device="cpu",
                          layout="planar")
        assert clear.text_route == "fused" and clear.spec.text_box == ()
        assert torch.equal(clear.process(x)[0], plain.process(x)[0])
        assert not torch.equal(out, plain.process(x)[0])
