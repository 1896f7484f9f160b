"""The frozen reference against the port's plain twins, at tiny sizes on the CPU.

    python -m pytest portbench/tests
"""

import json
import os

import numpy as np
import pytest
import torch

from portbench.reference import chain as rchain
from portbench.reference import draws

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def config(name: str) -> dict:
    with open(os.path.join(ROOT, "portbench", "configs", f"{name}.json")) as f:
        return json.load(f)


SEEDS = (0, 7, 2**31 + 12345, 2**64 - 1)
FRAMES = torch.tensor([0, 1, 37, 2**32 + 5, 3 * 2**40 + 11], dtype=torch.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_grain_draws_bit_for_bit_the_twin(seed):
    from pythoncrt_tpu_torch.kernels import rng as krng

    assert torch.equal(draws.grain(seed, FRAMES, 5, 7), krng.grain_normals_ref(seed, FRAMES, 5, 7))


@pytest.mark.parametrize("seed", SEEDS)
def test_export_glitch_draws_bit_for_bit_the_twin(seed):
    from pythoncrt_tpu_torch.kernels import rng as krng

    amp = torch.linspace(6.0, 0.5, 9, dtype=torch.float32)
    assert torch.equal(draws.glitch_export(seed, FRAMES, 5, amp),
                       krng.glitch_export_offsets_ref(seed, FRAMES, 5, amp))


C3 = dict(scanline_strength=0.6, triad_strength=0.35, triad_softness=0.5, aberration_px=1,
          bloom_sigma=1.2, bloom_strength=0.25, fast_bloom=False, noise_strength=1.5,
          vignette_strength=0.25, persistence=0.0, pixel_size=2, grain_size=2,
          warp_strength=0.15, flicker_strength=0.2, flicker_hz=2.0, brightness=0.02,
          contrast=1.05, gamma=1.1, saturation=0.9, temperature=0.1)
# name -> (configuration file, parameter changes, text, widest gap allowed in uint8 steps)
CASES = {
    "defaults": ("defaults_1080p", {}, None, 0),
    "c4": ("c4_temporal_1080p", {}, None, 0),
    "c4-caption": ("c4_temporal_1080p", {}, dict(text="PLAY", size=48, after=False), 0),
    # stages no cell runs yet: the oracle's gaussian border sums and warp order
    # differ from the port's in rounding, within its 1 LSB
    "c3": ("defaults_1080p", C3, None, 1),
    "angled-text-after": ("defaults_1080p", dict(scanline_angle=12.0, scanline_thickness=2.0,
                                                 persistence=0.5),
                          dict(text="HI", size=12, after=True), 1),
    "luma-knee": ("c4_temporal_1080p", dict(triad_preserve_luma=True, bloom_threshold=0.3,
                                            grain_size=3), None, 1),
}


def overlay(h, w, seed):
    ov = np.zeros((h, w, 4), np.uint8)
    ov[3:13, 5:40] = np.random.default_rng(seed).integers(0, 256, (10, 35, 4), dtype=np.uint8)
    return ov


@pytest.mark.parametrize("case", sorted(CASES))
def test_chain_against_the_engine_on_the_cpu(case):
    from pythoncrt_tpu_torch import CRTEngine, EffectParams, TextParams

    name, changes, text, allowed = CASES[case]
    cfg = config(name)
    h, w, b, seed = 30, 64, 4, 2**31 + 99
    params = dict(cfg["params"], **changes)
    ov = overlay(h, w, seed) if text else None
    eng = CRTEngine(EffectParams(**params, text=TextParams(**(text or {}))), h, w, cfg["fps"],
                    seed=seed, text_rgba=ov, layout="planar", channel_order="rgb", device="cpu")
    ref = rchain.Chain(dict(cfg, height=h, width=w, params=dict(params, text=text or {})), seed,
                       "cpu", overlay=ov)
    x = torch.from_numpy(np.random.default_rng(5).integers(0, 256, (3 * b, 3, h, w),
                                                           dtype=np.uint8))
    idx = np.arange(1000, 1000 + 3 * b)
    got, state = [], None
    for i in range(3):
        out, state = eng.process(x[i * b:(i + 1) * b], idx[i * b:(i + 1) * b], state)
        got.append(out)
    want, _ = ref.render(x, idx, None, block=5)
    gap = (torch.cat(got).to(torch.int16) - want.to(torch.int16)).abs().max().item()
    assert gap <= allowed


def test_bfloat16_chain_departs_from_float32():
    cfg = dict(config("c4_temporal_1080p"), height=30, width=64)
    cfg["params"] = dict(cfg["params"], text={})
    x = torch.from_numpy(np.random.default_rng(3).integers(0, 256, (6, 3, 30, 64), dtype=np.uint8))
    a, _ = rchain.Chain(cfg, 5, "cpu").render(x, np.arange(6), None)
    b, _ = rchain.Chain(cfg, 5, "cpu", torch.bfloat16).render(x, np.arange(6), None)
    assert (a != b).float().mean().item() > 0.1


@pytest.mark.parametrize("p,lead", [(0.0, 0), (0.2, 18), (0.6, 55), (0.95, 541)])
def test_lead_frames(p, lead):
    assert rchain.lead_frames(p) == lead
    if p:
        assert p ** lead < 2.0 ** -40 <= p ** (lead - 1)


def test_reference_imports_nothing_of_the_program():
    src_dir = os.path.join(ROOT, "portbench", "reference")
    for fn in os.listdir(src_dir):
        if fn.endswith(".py"):
            with open(os.path.join(src_dir, fn)) as f:
                src = f.read()
            for banned in ("pythoncrt_tpu", "jax", "flax"):
                assert f"import {banned}" not in src and f"from {banned}" not in src, fn
