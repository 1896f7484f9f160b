"""Carrying the JAX engine's tables and state over to the port
(pythoncrt_tpu_torch.convert), and the port's native-rng contract."""

import numpy as np
import pytest
import torch

from pythoncrt_tpu import CRTEngine as JaxEngine
from pythoncrt_tpu_torch import CRTEngine
from pythoncrt_tpu_torch.convert import consts_from_jax, state_from_numpy

from conftest import synth_frames
from test_engine_vs_oracle import identity_params
from test_fused import FULL

H, W, FPS = 48, 256, 24.0


def numpy_consts(c: dict) -> dict:
    return {k: tuple(np.asarray(a) for a in v) if isinstance(v, tuple) else np.asarray(v)
            for k, v in c.items()}


@pytest.mark.parametrize("overrides", [FULL, {**FULL, "aberration_px": 0},
                                       {**FULL, "pixel_size": 3, "warp_strength": -0.4}])
def test_consts_from_jax_equal_the_port_tables(overrides):
    p = identity_params(**overrides)
    jc = consts_from_jax(numpy_consts(JaxEngine(p, H, W, FPS, pallas="off")._c))
    own = CRTEngine(p, H, W, FPS, device="cpu").consts
    assert set(jc) == {"pix_y", "pix_x", "triad", "vig_ny2", "vig_nx2", "warp"}
    for k, v in jc.items():
        mine = own[k]
        for a, b in zip(v if isinstance(v, tuple) else (v,),
                        mine if isinstance(mine, tuple) else (mine,)):
            assert a.dtype == b.dtype and torch.equal(a, b), k


def test_engine_from_converted_consts_is_byte_identical():
    p = identity_params(**FULL)
    frames = synth_frames(4, H, W, seed=9)
    jc = consts_from_jax(numpy_consts(JaxEngine(p, H, W, FPS, pallas="off")._c))
    a, _ = CRTEngine(p, H, W, FPS, rng="host", device="cpu").process(frames)
    b, _ = CRTEngine(p, H, W, FPS, rng="host", device="cpu", consts=jc).process(frames)
    assert torch.equal(a, b)


@pytest.mark.parametrize("after", [False, True])
def test_consts_from_jax_carry_text_and_2d_scanlines(after):
    """The overlay's alpha and colour and the 2-D scanline slant come over
    equal to the port's own, and an engine built on them renders the
    same bytes."""
    from pythoncrt_tpu import TextParams

    p = identity_params(**{**FULL, "scanline_angle": 8.0, "scanline_thickness": 1.4,
                           "text": TextParams(text="HI", after=after)})
    ov = np.random.default_rng(2).integers(0, 256, (H, W, 4), dtype=np.uint8)
    jc = consts_from_jax(numpy_consts(JaxEngine(p, H, W, FPS, pallas="off", text_rgba=ov)._c))
    eng = CRTEngine(p, H, W, FPS, rng="host", device="cpu", text_rgba=ov)
    assert {"sl_slant", "text_alpha", "text_rgb"} <= set(jc)
    for k in ("sl_slant", "text_alpha", "text_rgb"):
        assert jc[k].dtype == eng.consts[k].dtype and torch.equal(jc[k], eng.consts[k]), k
    frames = synth_frames(4, H, W, seed=9)
    a, _ = eng.process(frames)
    b, _ = CRTEngine(p, H, W, FPS, rng="host", device="cpu", text_rgba=ov,
                     consts=jc).process(frames)
    assert torch.equal(a, b)


def test_native_rng_is_invariant_to_batch_split():
    """Native draws are a pure function of (seed, frame index): frames
    0-7 as one batch of 8 equal two batches of 4 through fresh engines
    (the draw kernel's twin keyed by the uploaded frame indices; grain
    size 2: the raw field, upsampled in the fused twin)."""
    p = identity_params(**{**FULL, "noise_strength": 12.0})
    frames = synth_frames(8, H, W, seed=1)
    whole, _ = CRTEngine(p, H, W, FPS, seed=7, device="cpu").process(frames, np.arange(8))
    head, _ = CRTEngine(p, H, W, FPS, seed=7, device="cpu").process(frames[:4], np.arange(4))
    tail, _ = CRTEngine(p, H, W, FPS, seed=7, device="cpu").process(frames[4:], np.arange(4, 8))
    assert torch.equal(torch.cat([head, tail]), whole)
    other, _ = CRTEngine(p, H, W, FPS, seed=8, device="cpu").process(frames, np.arange(8))
    assert not torch.equal(other, whole)


def test_state_from_numpy_layouts():
    s = np.random.default_rng(0).random((H, W, 3), dtype=np.float32)
    t = state_from_numpy(s, "nhwc")
    assert t.shape == (H, W, 3) and np.array_equal(t.numpy(), s)
    sp = np.ascontiguousarray(np.transpose(s, (2, 0, 1)))
    assert state_from_numpy(sp, "planar", "gbr").shape == (3, H, W)
    with pytest.raises(ValueError):
        state_from_numpy(s, "planar")
    with pytest.raises(ValueError):
        state_from_numpy(s, "nhwc", "gbr")


C4 = dict(scanline_strength=0.6, triad_strength=0.35, aberration_px=1, bloom_strength=0.25,
          fast_bloom=True, noise_strength=1.5, vignette_strength=0.25, persistence=0.6,
          pixel_size=1, glitch_amp_px=6, glitch_height_frac=0.3, scanline_speed_px_s=120.0)


@pytest.mark.parametrize("engine_mode", ["export", "preview"])
def test_consts_from_jax_carry_the_glitch_tables(engine_mode):
    """The JAX engine's glitch amplitudes (and the export segment index)
    are the port's, and an engine fed them renders c4 byte for byte as
    with its own tables."""
    p = identity_params(**C4)
    jc = consts_from_jax(numpy_consts(
        JaxEngine(p, H, W, FPS, engine=engine_mode, pallas="off")._c))
    eng = CRTEngine(p, H, W, FPS, engine=engine_mode, device="cpu")
    assert {"glitch_amp"} <= set(jc) and ("glitch_seg_index" in jc) == (engine_mode == "export")
    for k in ("glitch_amp", "glitch_seg_index"):
        if k in jc:
            assert torch.equal(jc[k], eng.consts[k]), k
    frames = synth_frames(4, H, W, seed=2)
    a, _ = eng.process(frames)
    b, _ = CRTEngine(p, H, W, FPS, engine=engine_mode, device="cpu", consts=jc).process(frames)
    assert torch.equal(a, b)


@pytest.mark.parametrize("layout", ["nhwc", "planar"])
def test_state_from_jax_carries_the_persistence_stream(layout):
    """A stream whose first batch ran on the JAX engine continues on the
    port from the converted state within 1 LSB of the port alone."""
    p = identity_params(**C4)
    frames = synth_frames(8, H, W, seed=4)
    if layout == "planar":
        frames = np.ascontiguousarray(np.transpose(frames, (0, 3, 1, 2)))
    kw = dict(rng="host", layout=layout)
    _, js = JaxEngine(p, H, W, FPS, pallas="off", **kw).process(frames[:4], np.arange(4))
    eng = CRTEngine(p, H, W, FPS, device="cpu", **kw)
    got, _ = eng.process(frames[4:], np.arange(4, 8), state_from_numpy(js, layout))
    _, st = eng.process(frames[:4], np.arange(4))
    want, _ = eng.process(frames[4:], np.arange(4, 8), st)
    d = (got.int() - want.int()).abs()
    assert d.max().item() <= 1 and (d > 0).float().mean().item() < 1e-3
