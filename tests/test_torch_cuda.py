"""The port's CUDA kernels against their plain PyTorch twins on a card.

Marked ``cuda``; they skip on hosts without a CUDA device. The file
imports no JAX, so on a machine without it run

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Operands are the ones the engine's step hands each kernel (c3 and
variants), at a small shape and at 1080p. Both sides keep one f32 op
order (the kernels build with -fmad=false and round pow once from
double, as the twins do), so f32 outputs agree to 2e-6 and uint8
outputs to 1 LSB."""

import numpy as np
import pytest
import torch

from pythoncrt_tpu.params import EffectParams
from pythoncrt_tpu_torch import CRTEngine
from pythoncrt_tpu_torch.kernels import fused as kfused
from pythoncrt_tpu_torch.kernels import warp as kwarp

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
}
SHAPES = [(2, 48, 200), (8, 1080, 1920)]


@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: run on the card (README)")
    return torch.device("cuda")


def engine(name, h, w, dev):
    kw = dict(layout="planar", channel_order="gbr") if name.endswith("_gbr") else {}
    return CRTEngine(EffectParams(**VARIANTS[name]), h, w, 24.0, rng="host",
                     device=dev, **kw)


def frames(b, h, w, dev):
    g = torch.Generator(device=dev).manual_seed(5)
    return torch.randint(0, 256, (b, 3, h, w), generator=g, device=dev, dtype=torch.uint8)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES, ids=["small", "1080p"])
@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_fused_kernel_matches_twin(cuda_dev, name, shape):
    b, h, w = shape
    eng = engine(name, h, w, cuda_dev)
    x = frames(b, h, w, cuda_dev)
    kw = eng.fused_operands(eng.make_aux(np.arange(b)))
    n0 = kfused.launches
    got = kfused.fused_pipeline(x, eng.spec, eng.fused_tables, **kw)
    want = kfused.fused_pipeline_ref(x, eng.spec, eng.fused_tables, **kw)
    torch.cuda.synchronize()
    assert kfused.launches == n0 + 1
    if eng.spec.emit == "u8":
        d = (got.int() - want.int()).abs()
        assert d.max().item() <= 1 and (d > 0).float().mean().item() < 1e-3
    else:
        assert (got - want).abs().max().item() <= 2e-6


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES, ids=["small", "1080p"])
@pytest.mark.parametrize("strength", [0.15, -0.5])
def test_warp_kernel_matches_twin(cuda_dev, shape, strength):
    b, h, w = shape
    g = torch.Generator(device=cuda_dev).manual_seed(3)
    img = torch.rand((b, 3, h, w), generator=g, device=cuda_dev)
    tables = kwarp.build_warp_tables(h, w, strength, cuda_dev)
    got = kwarp.warp_planar(img, tables)
    want = kwarp.warp_planar_ref(img, tables)
    got8 = kwarp.warp_planar(img, tables, emit_u8=True)
    want8 = kwarp.warp_planar_ref(img, tables, emit_u8=True)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 1e-6
    assert (got8.int() - want8.int()).abs().max().item() <= 1


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
