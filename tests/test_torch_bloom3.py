"""The port's stand-alone bloom (pythoncrt_tpu_torch.kernels.bloom3)
against the JAX kernels it replaces, run in interpret mode, and against
the JAX package's XLA forms on shapes the TPU kernels do not take.

On the CPU the port runs the kernels' plain twins. Both sides keep the
reference's f32 op order, so they agree to 1.5e-7 (the JAX suite's own
bound: XLA on the CPU may contract a multiply-add into an FMA). The
CUDA kernels against their twins on a card are in test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pythoncrt_tpu.kernels import bloom3 as jb3
from pythoncrt_tpu.ops import blur as jblur
from pythoncrt_tpu.ops import resize as jresize
from pythoncrt_tpu.oracle import ops as joops
from pythoncrt_tpu_torch.kernels import bloom3 as tb3
from pythoncrt_tpu_torch.kernels import fused as tfused

STRENGTH = 0.25


def planar(imgs):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(imgs, (0, 3, 1, 2))))


def nhwc(t):
    return np.transpose(t.numpy(), (0, 2, 3, 1))


def imgs_for(h, w, seed):
    return np.random.default_rng(seed).random((2, h, w, 3), dtype=np.float32)


@pytest.mark.parametrize("sigma,thr,h", [
    (1.2, 0.0, 24), (2.0, 0.4, 24), (0.5, 0.0, 24), (1.2, 0.0, 48)])
def test_gaussian_twin_matches_jax_kernel(sigma, thr, h):
    imgs = imgs_for(h, 128, seed=h + int(10 * sigma))
    want = np.asarray(jb3.bloom3_nhwc(jnp.asarray(imgs),
                                      jb3.build_bloom3_spec(h, 128, sigma, STRENGTH, thr),
                                      interpret=True))
    got = tb3.bloom3_planar(planar(imgs), tb3.build_bloom3_spec(h, 128, sigma, STRENGTH, thr))
    np.testing.assert_allclose(nhwc(got), want, atol=1.5e-7, rtol=0)


@pytest.mark.parametrize("thr,h", [(0.0, 24), (0.4, 24), (0.0, 48), (0.0, 32)])
def test_fast_twin_matches_jax_kernel(thr, h):
    imgs = imgs_for(h, 256, seed=h)
    want = np.asarray(jb3.bloom3_fast_nhwc(jnp.asarray(imgs),
                                           jb3.build_bloom3_fast_spec(h, 256, STRENGTH, thr),
                                           interpret=True))
    got = tb3.bloom3_fast_planar(planar(imgs), tb3.build_bloom3_fast_spec(h, 256, STRENGTH, thr))
    np.testing.assert_allclose(nhwc(got), want, atol=1.5e-7, rtol=0)


def xla_bloom(img, thr, blur):
    """The JAX engine's XLA stage 6 (_frame_bloom_xla) on one (H, W, 3) frame."""
    src = jnp.asarray(img)
    if thr > 0.0:
        thrf = np.float32(min(0.99, max(0.0, thr)))
        src = jnp.clip((src - thrf) / np.float32(max(1e-6, 1.0 - float(thrf))), 0.0, 1.0)
    return np.asarray(jnp.clip(jnp.asarray(img) + np.float32(STRENGTH) * blur(src), 0.0, 1.0))


@pytest.mark.parametrize("shape", [(45, 250), (7, 9), (1, 5)])
@pytest.mark.parametrize("thr", [0.0, 0.4])
@pytest.mark.parametrize("variant", ["gaussian", "fast"])
def test_twins_match_jax_xla_on_any_shape(shape, thr, variant):
    """Odd and tiny frames (radius 4 on a 1x5 frame; the last half-res
    row and column clamped), which the TPU kernels refuse."""
    h, w = shape
    imgs = imgs_for(h, w, seed=h * w)
    if variant == "gaussian":
        taps = tuple(float(t) for t in joops.gaussian_kernel_1d(9, 1.2))
        spec = tb3.build_bloom3_spec(h, w, 1.2, STRENGTH, thr)
        assert spec.taps == taps
        got = tb3.bloom3_planar(planar(imgs), spec)

        def blur(src):
            return jblur.gaussian_blur_replicate(src, taps, taps)
    else:
        h2, w2 = max(1, h // 2), max(1, w // 2)
        down = [jnp.asarray(a) for a in (*joops.bilinear_taps(h, h2), *joops.bilinear_taps(w, w2))]
        up = [jnp.asarray(a) for a in (*joops.bilinear_taps(h2, h), *joops.bilinear_taps(w2, w))]
        got = tb3.bloom3_fast_planar(planar(imgs), tb3.build_bloom3_fast_spec(h, w, STRENGTH, thr))

        def blur(src):
            return jresize.resize_bilinear(jresize.resize_bilinear(src, *down), *up)
    want = np.stack([xla_bloom(im, thr, blur) for im in imgs])
    np.testing.assert_allclose(nhwc(got), want, atol=1.5e-7, rtol=0)


@pytest.mark.parametrize("fast", [False, True])
def test_twins_are_the_fused_bloom_core(fast):
    """The stand-alone bloom is the fused kernel's stage 6 bit for bit,
    so the staged and fused steps agree up to the triad."""
    h, w = 40, 72
    x = planar(imgs_for(h, w, seed=9))
    fspec = tfused.build_fused_spec(h, w, sigma=1.7, strength=0.3, threshold=0.2, fast=fast)
    bspec = (tb3.build_bloom3_fast_spec(h, w, 0.3, 0.2) if fast
             else tb3.build_bloom3_spec(h, w, 1.7, 0.3, 0.2))
    want = tfused.bloom_ref(x, fspec, tfused.fused_consts(fspec))
    got = tb3.bloom3_fast_planar(x, bspec) if fast else tb3.bloom3_planar(x, bspec)
    assert torch.equal(got, want)


@pytest.mark.parametrize("sigma,thr", [(12.0, 0.0), (12.0, 0.4)])
def test_specs_and_wrappers_refuse_what_they_do_not_take(sigma, thr):
    """Radius 36 (sigma 12), once refused, builds: its taps are the
    oracle's, and its twin matches the JAX XLA fold and the oracle's
    pad-then-sum bloom on a frame smaller than the band. The wrappers
    still refuse the other variant's spec and a device they do not take."""
    spec = tb3.build_bloom3_spec(48, 64, sigma, STRENGTH, thr)
    taps = tuple(float(t) for t in joops.gaussian_kernel_1d(73, sigma))
    assert spec.r == 36 and spec.taps == taps
    imgs = imgs_for(48, 64, seed=36)
    got = nhwc(tb3.bloom3_planar(planar(imgs), spec))
    want = np.stack([xla_bloom(im, thr, lambda src: jblur.gaussian_blur_replicate(
        src, taps, taps)) for im in imgs])
    np.testing.assert_allclose(got, want, atol=1.5e-7, rtol=0)
    oracle = np.stack([xla_bloom(im, thr, lambda src: joops.gaussian_blur_replicate(
        np.asarray(src), 73, 73, sigma, sigma)) for im in imgs])
    assert np.abs(got - oracle).max() <= 1e-6
    x = torch.zeros((1, 3, 8, 8))
    with pytest.raises(ValueError):
        tb3.bloom3_planar(x, tb3.build_bloom3_fast_spec(8, 8, STRENGTH, 0.0))
    with pytest.raises(ValueError):
        tb3.bloom3_fast_planar(x, tb3.build_bloom3_spec(8, 8, 1.2, STRENGTH, 0.0))
    with pytest.raises(ValueError, match="unsupported device"):
        tb3.bloom3_planar(x.to("meta"), tb3.build_bloom3_spec(8, 8, 1.2, STRENGTH, 0.0))
