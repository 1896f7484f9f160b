"""Every bloom radius and every frame width through the port's engine on
the CPU (the kernels' plain twins), against the oracle and the JAX
engine's XLA path on the same frames and host-rng noise fields.

- The gaussian bloom at sigma 10.5, 11 and 20 (radius 32, 33, 60, past
  the 63 taps a launch carries) on each of the four stage-6 routes: the
  fused kernel, bloom3 (angled scanlines: the staged step), and the two
  opt-ins, bloom2 (PCRT_BLOOM2_GAUSS=1) and the stripe
  (PCRT_PALLAS_BLOOM=1); at 48x256 and at 16x8, where the radius exceeds
  the frame's height and width. The JAX engine renders these radii
  through XLA (its kernels take radius <= 31).
- The aberration at widths 1-8 with +8 and -8 columns: the roll wraps
  (the JAX engine's maps take % w).

Contract: <= 1 uint8 LSB against each reference and fewer than 1e-3 of
values off against the oracle; against the JAX XLA path, fewer than 1e-3
off where that path agrees with the oracle (its grain upsample truncates
the noise field to bf16, ROADMAP.md queue 3)."""

import numpy as np
import pytest

from pythoncrt_tpu import CRTEngine as JaxEngine
from pythoncrt_tpu import EffectParams as JaxParams
from pythoncrt_tpu_torch import CRTEngine, EffectParams, cli

from conftest import synth_frames
from test_engine_vs_oracle import IDENTITY
from test_fused import FULL
from test_torch_engine import lsb, oracle_stream, run_batches

B, FPS = 4, 24.0
SIGMAS = {"s10.5": 10.5, "s11": 11.0, "s20": 20.0}
ROUTES = {  # route -> (variables, overrides)
    "fused": ({}, {}),
    "bloom3": ({}, {"scanline_angle": 5.0, "scanline_thickness": 1.5}),
    "bloom2": ({"PCRT_BLOOM2_GAUSS": "1"}, {}),
    "stripe": ({"PCRT_PALLAS_BLOOM": "1"}, {}),
}
SHAPES = {"48x256": (48, 256), "16x8": (16, 8)}


def check_both(overrides, h, w, seed):
    """The port against the oracle and the JAX XLA path, two batches of
    B frames with the state carried; returns the port's engine."""
    tp, jp = EffectParams(**overrides), JaxParams(**overrides)
    frames = synth_frames(2 * B, h, w, seed=seed)
    eng = CRTEngine(tp, h, w, FPS, rng="host", device="cpu")
    got, _ = run_batches(eng, frames, 2)
    got = np.asarray(got)
    assert got.shape == (2 * B, h, w, 3) and got.dtype == np.uint8
    want = oracle_stream(eng, frames)
    mx, frac = lsb(got, want)
    assert mx <= 1 and frac < 1e-3, f"vs oracle: max {mx} LSB, {frac:.2e} off"
    xla, _ = run_batches(JaxEngine(jp, h, w, FPS, rng="host", pallas="off"), frames, 2)
    mx, frac = lsb(got, xla)
    own = float(((got != xla) & (xla == want)).mean())
    assert mx <= 1 and own < 1e-3, f"vs XLA: max {mx} LSB, {frac:.2e} off ({own:.2e} own)"
    return eng


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("sigma", sorted(SIGMAS))
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_every_radius_renders_on_every_route(route, sigma, shape, monkeypatch):
    env, extra = ROUTES[route]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    h, w = SHAPES[shape]
    s = SIGMAS[sigma]
    overrides = {**IDENTITY, **FULL, **extra, "bloom_sigma": s}
    eng = check_both(overrides, h, w, seed=int(2 * s) + h)
    r = int(round(3 * s))
    assert eng.bloom_route == route
    assert eng.spec.r == r and eng.bloom3_spec.r == r
    if route == "fused":
        assert not eng._staged and eng.fused_tables.tapdev is not None
    if shape == "16x8":
        assert r > h and r > w


@pytest.mark.parametrize("w", range(1, 9))
@pytest.mark.parametrize("ab", [8, -8])
def test_aberration_wider_than_the_frame(w, ab):
    """The CLI defaults with the aberration at its clamp, on frames 1-8
    columns wide: the fused kernel's maps roll mod W."""
    eng = check_both({"aberration_px": ab}, 16, w, seed=w)
    assert eng.bloom_route == "fused" and abs(eng.spec.ab) < w


def test_cli_renders_a_large_sigma(tmp_path, capsys):
    """--no-fast-bloom --bloom-sigma 11 (radius 33), once exit 2, renders."""
    from test_torch_cli import count_frames, write_clip

    inp, out = tmp_path / "in.mp4", tmp_path / "out.mp4"
    write_clip(inp, n=4)
    rc = cli.main(["--input", str(inp), "--output", str(out), "--no-fast-bloom",
                   "--bloom-sigma", "11", "--batch-size", "2", "--device", "cpu"])
    assert rc == 0, capsys.readouterr()
    assert count_frames(out) == 4
