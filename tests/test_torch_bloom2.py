"""The port's opt-in blooms on the CPU (the kernels' plain twins): bloom2
(kernels/bloom2.py, the banded separable map, and its pipelined entry's
``limbs`` settings) and the stripe gaussian bloom (kernels/bloom.py),
against the JAX kernels they replace, run in interpret mode, and against
the NumPy oracle.

Tolerances, each with its reason:
- bloom2 against JAX ``bloom2_nhwc``: 2e-5. The JAX horizontal pass is
  three bf16 products (hi*hi + hi*lo + lo*hi), about 2^-17 relative from
  the f32 product the port forms.
- The pipelined twin against JAX ``bloom2_nhwc_pipelined``: 2e-6 for
  ``limbs`` 1 and 2 (the same roundings of value and weight, summed in
  another order), 2e-5 for 3 (as above).
- bloom2 against the oracle (``gaussian_blur_replicate``;
  ``resize_bilinear`` down and up): 1e-5. bloom2 folds the border taps
  and composes the two resizes in f64, a few f32 reassociations away from
  the oracle's passes.
- The stripe bloom against JAX ``bloom_nhwc``: 2e-6 (XLA on the CPU may
  contract a multiply-add into an FMA). Against the oracle it is the
  same op order: equal bit for bit without the knee; with the knee, the
  port multiplies by the rounded reciprocal where the oracle divides,
  within 1e-6 (measured at 32x128, threshold 0.4: 5.96e-08, one ulp, on
  5.7% of values).
- The stripe bloom against bloom2's twin with constant-tap tables: bit
  for bit (the same products summed in the same order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pythoncrt_tpu.kernels import bloom as jbloom
from pythoncrt_tpu.kernels import bloom2 as jbloom2
from pythoncrt_tpu_torch.kernels import bloom as tbloom
from pythoncrt_tpu_torch.kernels import bloom2 as tbloom2
from pythoncrt_tpu_torch.oracle import ops as oops

STRENGTH = 0.3


def planar(imgs):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(imgs, (0, 3, 1, 2))))


def nhwc(t):
    return np.transpose(t.numpy(), (0, 2, 3, 1))


def imgs_for(h, w, seed, b=2):
    return np.random.default_rng(seed).random((b, h, w, 3), dtype=np.float32)


def oracle_bloom(imgs, thr, blur):
    """clip(x + strength * blur(knee(x))) per frame, the oracle's way."""
    out = []
    for im in imgs:
        src = im
        if thr > 0:
            t = np.float32(min(0.99, max(0.0, thr)))
            src = np.clip((im - t) / max(1e-6, 1.0 - float(t)), 0, 1).astype(np.float32)
        out.append(np.clip(im + np.float32(STRENGTH) * blur(src), 0, 1))
    return np.stack(out)


def gauss_blur(sigma):
    k = max(1, int(round(sigma * 3)) * 2 + 1)
    return lambda src: oops.gaussian_blur_replicate(src, k, k, sigma, sigma)


def fast_blur(h, w):
    return lambda src: oops.resize_bilinear(oops.resize_bilinear(src, max(1, h // 2),
                                                                 max(1, w // 2)), h, w)


VARIANTS = [("gaussian", 0.5, 0.0), ("gaussian", 1.2, 0.0), ("gaussian", 1.2, 0.4),
            ("gaussian", 2.0, 0.0), ("gaussian", 2.0, 0.4), ("fast", 0.0, 0.0),
            ("fast", 0.0, 0.2)]
VIDS = [f"{v}_s{s}_t{t}" for v, s, t in VARIANTS]


def specs(h, w, variant, sigma, thr):
    kw = dict(variant=variant, sigma=sigma, strength=STRENGTH, threshold=thr)
    return tbloom2.build_bloom2_spec(h, w, **kw), jbloom2.build_bloom2_spec(h, w, **kw)


@pytest.mark.parametrize("h", [32, 48])
@pytest.mark.parametrize("variant,sigma,thr", VARIANTS, ids=VIDS)
def test_bloom2_twin_matches_jax_kernel_and_oracle(variant, sigma, thr, h):
    w = 256
    imgs = imgs_for(h, w, seed=h + int(10 * sigma) + int(10 * thr))
    mine, theirs = specs(h, w, variant, sigma, thr)
    got = nhwc(tbloom2.bloom2_planar(planar(imgs), mine))
    want = np.asarray(jbloom2.bloom2_nhwc(jnp.asarray(imgs), theirs, interpret=True))
    assert np.abs(got - want).max() <= 2e-5
    blur = gauss_blur(sigma) if variant == "gaussian" else fast_blur(h, w)
    assert np.abs(got - oracle_bloom(imgs, thr, blur)).max() <= 1e-5


@pytest.mark.parametrize("limbs", [1, 2, 3])
@pytest.mark.parametrize("variant,sigma,thr", [VARIANTS[1], VARIANTS[4], VARIANTS[6]],
                         ids=[VIDS[1], VIDS[4], VIDS[6]])
def test_bloom2_pipelined_twin_matches_jax_kernel(variant, sigma, thr, limbs):
    h, w = 32, 256
    imgs = imgs_for(h, w, seed=7 + limbs)
    mine, theirs = specs(h, w, variant, sigma, thr)
    got = nhwc(tbloom2.bloom2_planar_pipelined(planar(imgs), mine, limbs))
    want = np.asarray(jbloom2.bloom2_nhwc_pipelined(jnp.asarray(imgs), theirs, interpret=True,
                                                    limbs=limbs))
    assert np.abs(got - want).max() <= (2e-5 if limbs == 3 else 2e-6)
    if limbs == 3:
        assert np.array_equal(got, nhwc(tbloom2.bloom2_planar(planar(imgs), mine)))


@pytest.mark.parametrize("variant,sigma", [("gaussian", 0.5), ("gaussian", 1.2),
                                           ("gaussian", 2.0), ("fast", 0.0)])
@pytest.mark.parametrize("n", [256, 48, 45, 9, 1])
def test_bloom2_bands_are_jax_bits(variant, sigma, n):
    """The spec's band weights are bloom2's ``_band`` of its matrices, bit
    for bit, on both axes (the horizontal by the same ``_band``)."""
    mat = (jbloom2._gaussian_matrix(n, sigma) if variant == "gaussian"
           else jbloom2._fast_matrix(n))
    d0, d1, wts = jbloom2._band(mat)
    spec = tbloom2.build_bloom2_spec(n, n, variant=variant, sigma=sigma)
    for got in ((spec.hd0, spec.hd1, spec.hw), (spec.vd0, spec.vd1, spec.vw)):
        assert got[:2] == (d0, d1)
        np.testing.assert_array_equal(got[2], wts)
    if n >= 48:  # the JAX spec's own vertical band (it gates smaller shapes)
        j = jbloom2.build_bloom2_spec(n, 256, variant=variant, sigma=sigma)
        assert (j.d0, j.d1) == (d0, d1)
        np.testing.assert_array_equal(j.vwts, wts)


@pytest.mark.parametrize("h", [32, 48])
@pytest.mark.parametrize("sigma,thr", [(0.5, 0.0), (1.2, 0.0), (1.2, 0.4), (2.0, 0.0)])
def test_stripe_twin_matches_jax_kernel_and_oracle(sigma, thr, h):
    w = 128
    imgs = imgs_for(h, w, seed=h + int(10 * sigma))
    mine = tbloom.build_bloom_spec(h, w, sigma, STRENGTH, thr)
    theirs = jbloom.build_bloom_spec(h, w, sigma, STRENGTH, thr)
    assert (mine.taps, mine.threshold) == (theirs.taps, theirs.threshold)
    got = nhwc(tbloom.bloom_planar(planar(imgs), mine))
    want = np.asarray(jbloom.bloom_nhwc(jnp.asarray(imgs), theirs, interpret=True))
    assert np.abs(got - want).max() <= 2e-6
    ref = oracle_bloom(imgs, thr, gauss_blur(sigma))
    if thr == 0.0:
        np.testing.assert_array_equal(got, ref)
    else:
        assert np.abs(got - ref).max() <= 1e-6


@pytest.mark.parametrize("shape", [(45, 250), (7, 9), (1, 5)])
@pytest.mark.parametrize("kind", ["stripe", "bloom2_gaussian", "bloom2_fast"])
def test_twins_match_oracle_on_any_shape(kind, shape):
    """Odd and tiny frames the TPU kernels refuse (radius 4 on a 1x5
    frame, the last half-res row and column clamped)."""
    h, w = shape
    imgs = imgs_for(h, w, seed=h * w)
    x = planar(imgs)
    if kind == "stripe":
        got = tbloom.bloom_planar(x, tbloom.build_bloom_spec(h, w, 1.2, STRENGTH, 0.0))
        np.testing.assert_array_equal(nhwc(got), oracle_bloom(imgs, 0.0, gauss_blur(1.2)))
        return
    variant = kind.split("_")[1]
    spec = tbloom2.build_bloom2_spec(h, w, variant=variant, sigma=1.2, strength=STRENGTH,
                                     threshold=0.3)
    blur = gauss_blur(1.2) if variant == "gaussian" else fast_blur(h, w)
    assert np.abs(nhwc(tbloom2.bloom2_planar(x, spec)) - oracle_bloom(imgs, 0.3, blur)).max() \
        <= 1e-5


def test_stripe_border_differs_from_the_fold():
    """At 7x9 with radius 4 almost every pixel is a border pixel: the
    stripe bloom keeps the oracle's pad-then-sum there, which the border
    fold of bloom3 (ops/blur.py) does not reproduce bit for bit."""
    from pythoncrt_tpu_torch.kernels import bloom3 as tbloom3

    imgs = imgs_for(7, 9, seed=5, b=4)
    x = planar(imgs)
    stripe = tbloom.bloom_planar(x, tbloom.build_bloom_spec(7, 9, 1.3, STRENGTH, 0.0))
    fold = tbloom3.bloom3_planar(x, tbloom3.build_bloom3_spec(7, 9, 1.3, STRENGTH, 0.0))
    np.testing.assert_array_equal(nhwc(stripe), oracle_bloom(imgs, 0.0, gauss_blur(1.3)))
    assert not torch.equal(stripe, fold) and (stripe - fold).abs().max().item() < 1e-6


@pytest.mark.parametrize("shape", [(32, 128), (7, 9), (1, 5)])
@pytest.mark.parametrize("thr", [0.0, 0.4])
def test_stripe_is_the_tile_with_constant_taps(shape, thr):
    """The stripe bloom is bloom2's tile function with the taps as every
    position's weights on both axes and no zeroed border weight (the
    clamped index is the replicate padding), bit for bit: that is why the
    two share one CUDA kernel (csrc/bloom2.cu), whose constant-tap
    instance the stripe launches."""
    h, w = shape
    x = planar(imgs_for(h, w, seed=h + w))
    spec = tbloom.build_bloom_spec(h, w, 1.2, STRENGTH, thr)
    r = spec.radius
    taps = np.asarray(spec.taps, np.float32)[:, None]
    tile = tbloom2.Bloom2Spec(h=h, w=w, variant="gaussian", strength=STRENGTH,
                              threshold=spec.threshold, hd0=-r, hd1=r, vd0=-r, vd1=r,
                              hw=np.repeat(taps, w, 1), vw=np.repeat(taps, h, 1))
    assert torch.equal(tbloom2.bloom2_planar_ref(x, tile), tbloom.bloom_planar_ref(x, spec))


@pytest.mark.parametrize("thr", [0.0, 0.4])
def test_specs_and_wrappers_refuse_what_they_do_not_take(thr):
    """The stripe at radius 36 and bloom2 at reach 33, once refused, build:
    the stripe's taps are the oracle's and its twin the oracle's bloom,
    bloom2's bands are the JAX package's bits and its twin within 1e-5 of
    the oracle's, on frames smaller than the band. The specs and wrappers
    still refuse an unknown variant, a bad limbs setting and a device they
    do not take."""
    imgs = imgs_for(48, 64, seed=33)
    stripe = tbloom.build_bloom_spec(48, 64, 12.0, STRENGTH, thr)  # radius 36
    assert stripe.radius == 36
    assert stripe.taps == tuple(float(t) for t in oops.gaussian_kernel_1d(73, 12.0))
    got = nhwc(tbloom.bloom_planar(planar(imgs), stripe))
    ref = oracle_bloom(imgs, thr, gauss_blur(12.0))
    if thr == 0.0:
        np.testing.assert_array_equal(got, ref)
    else:
        assert np.abs(got - ref).max() <= 1e-6
    spec = tbloom2.build_bloom2_spec(48, 64, variant="gaussian", sigma=11.0,
                                     strength=STRENGTH, threshold=thr)  # reach 33
    for n, d0, d1, wts in ((64, spec.hd0, spec.hd1, spec.hw), (48, spec.vd0, spec.vd1, spec.vw)):
        jd0, jd1, jw = jbloom2._band(jbloom2._gaussian_matrix(n, 11.0))
        assert (d0, d1) == (jd0, jd1) and max(-d0, d1) == min(33, n - 1)
        np.testing.assert_array_equal(wts, jw)
    got = nhwc(tbloom2.bloom2_planar(planar(imgs), spec))
    assert np.abs(got - oracle_bloom(imgs, thr, gauss_blur(11.0))).max() <= 1e-5
    with pytest.raises(ValueError):
        tbloom2.build_bloom2_spec(8, 8, variant="box")
    x = torch.zeros((1, 3, 8, 8))
    spec = tbloom2.build_bloom2_spec(8, 8, variant="fast")
    with pytest.raises(ValueError):
        tbloom2.bloom2_planar_pipelined(x, spec, limbs=4)
    for fn, sp in ((tbloom.bloom_planar, tbloom.build_bloom_spec(8, 8, 1.2, STRENGTH, 0.0)),
                   (tbloom2.bloom2_planar, spec)):
        with pytest.raises(ValueError, match="unsupported device"):
            fn(x.to("meta"), sp)


def test_cpu_path_makes_no_launch():
    x = torch.rand((1, 3, 8, 8))
    n0 = (tbloom.launches, tbloom2.launches)
    tbloom.bloom_planar(x, tbloom.build_bloom_spec(8, 8, 1.2, STRENGTH, 0.0))
    tbloom2.bloom2_planar(x, tbloom2.build_bloom2_spec(8, 8, variant="fast"))
    assert (tbloom.launches, tbloom2.launches) == n0
