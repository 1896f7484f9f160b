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
