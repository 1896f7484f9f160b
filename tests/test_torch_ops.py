"""The port's plain PyTorch ops (pythoncrt_tpu_torch.ops) against the
JAX package's ops and the NumPy oracle on the CPU.

Where the formula and op order are the same the results are bitwise
(resize, warp gather). The grade's pow is rounded once from double in
the port, which differs from a single-precision pow by at most one ulp
(<= 1.2e-7 on [0, 1]); the blur's border fold reassociates a few f32
additions against the oracle (the same fold as the JAX op)."""

import numpy as np
import pytest
import torch

from pythoncrt_tpu import oracle
from pythoncrt_tpu.ops import blur as jblur
from pythoncrt_tpu.ops import color as jcolor
from pythoncrt_tpu_torch.ops import blur, color, resize, warp

H, W = 24, 40


@pytest.mark.parametrize("grade", [
    dict(brightness=0.1, contrast=1.3, gamma=1.8, saturation=0.5, temperature=0.4),
    dict(brightness=0.0, contrast=1.0, gamma=1.0, saturation=0.0, temperature=-0.6),
])
def test_color_adjust_matches_oracle_and_jax(grade, rng):
    img = rng.random((H, W, 3), dtype=np.float32)
    got = color.color_adjust(torch.from_numpy(img), **grade).numpy()
    want = oracle.apply_color_adjustments(img, **grade)
    assert np.abs(got - want).max() <= 2.4e-7
    jax_out = np.asarray(jcolor.color_adjust(img, **grade))
    assert np.abs(got - jax_out).max() <= 2.4e-7


@pytest.mark.parametrize("luma", [False, True])
def test_apply_triad_matches_jax(luma, rng):
    img = rng.random((2, H, W, 3), dtype=np.float32)
    mask = oracle.triad_mask(1, W, 0.4, 0.6)[0]
    got = color.apply_triad(torch.from_numpy(img), torch.from_numpy(mask), 2.2, luma).numpy()
    want = np.asarray(jcolor.apply_triad(img, mask, 2.2, luma))
    assert np.abs(got - want).max() <= 2e-6
    wo = np.stack([oracle.apply_triad(im, mask[None], 2.2, luma) for im in img])
    assert np.abs(oracle.ops.to_uint8(got).astype(int)
                  - oracle.ops.to_uint8(wo).astype(int)).max() <= 1


def test_gaussian_blur_matches_jax_and_oracle(rng):
    img = rng.random((H, W, 3), dtype=np.float32)
    taps = blur.gaussian_taps(1.7)
    k = len(taps)
    got = blur.gaussian_blur_replicate(torch.from_numpy(img), taps, h_axis=0, w_axis=1).numpy()
    np.testing.assert_array_equal(got, np.asarray(jblur.gaussian_blur_replicate(img, taps, taps)))
    want = oracle.ops.gaussian_blur_replicate(img, k, k, 1.7, 1.7)
    assert np.abs(got - want).max() <= 1e-6


def test_resize_bilinear_is_the_oracle(rng):
    field = rng.standard_normal((3, H // 2, W // 2), dtype=np.float32)
    ylo, yf = oracle.ops.bilinear_taps(H // 2, H)
    xlo, xf = oracle.ops.bilinear_taps(W // 2, W)
    got = resize.resize_bilinear(torch.from_numpy(field), torch.from_numpy(ylo).long(),
                                 torch.from_numpy(yf), torch.from_numpy(xlo).long(),
                                 torch.from_numpy(xf)).numpy()
    for i in range(3):
        np.testing.assert_array_equal(got[i], oracle.ops.resize_bilinear(field[i], H, W))


def test_plane_index_maps_gather_like_the_oracle(rng):
    frame = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
    ym, xm = resize.plane_index_maps(H, W, 3, 2, corder=(1, 2, 0))
    planes = torch.from_numpy(np.ascontiguousarray(frame.transpose(2, 0, 1)[[1, 2, 0]]))[None]
    got = resize.remap_planes(planes, torch.from_numpy(ym), torch.from_numpy(xm))[0].numpy()
    img = np.stack([np.roll(frame[..., 0], 2, 1), frame[..., 1], np.roll(frame[..., 2], -2, 1)], -1)
    y_map, x_map = oracle.pixelate_index_maps(H, W, 3)
    want = img[y_map][:, x_map].transpose(2, 0, 1)[[1, 2, 0]]
    np.testing.assert_array_equal(got, want)


def test_bilinear_gather_is_the_oracle(rng):
    img = rng.random((H, W, 3), dtype=np.float32)
    map_x, map_y = oracle.barrel_warp_maps(H, W, 0.4)
    x0, fx = oracle.ops.split_map(map_x)
    y0, fy = oracle.ops.split_map(map_y)
    got = warp.bilinear_gather_const0(torch.from_numpy(np.ascontiguousarray(img.transpose(2, 0, 1))),
                                      *(torch.from_numpy(a) for a in (y0, x0, fy, fx))).numpy()
    np.testing.assert_array_equal(got.transpose(1, 2, 0),
                                  oracle.ops.remap_bilinear_const0(img, map_x, map_y))


def test_to_uint8_rounds_half_to_even():
    x = torch.tensor([0.5 / 255, 1.5 / 255, 2.5 / 255, -0.1, 1.2], dtype=torch.float32)
    np.testing.assert_array_equal(color.to_uint8(x).numpy(), oracle.ops.to_uint8(x.numpy()))


def sequential_edge_coefs(taps):
    """The border coefficients one f32 add at a time, tap by tap and
    distance by distance: the form that ops/blur.py edge_coefs sums side
    by side."""
    r = len(taps) // 2
    left = np.zeros(max(r, 1), np.float32)
    right = np.zeros(max(r, 1), np.float32)
    for d in range(r):
        for i, t in enumerate(taps):
            if d + i - r < 0:
                left[d] += np.float32(t)
            if i - r > d:
                right[d] += np.float32(t)
    return left, right


@pytest.mark.parametrize("sigma", [0.2, 0.5, 1.2, 4.0, 10.3, 10.5, 11.0, 20.0])
def test_edge_coefs_are_the_sequential_sums(sigma):
    """The border fold's coefficients, summed side by side over the
    distances, are bit for bit the sequential f32 sums, at radii up to 60
    (a radius in the thousands then costs O(r) vector adds)."""
    taps = blur.gaussian_taps(sigma)
    for got, want in zip(blur.edge_coefs(taps), sequential_edge_coefs(taps)):
        assert got.dtype == np.float32 and got.tobytes() == want.tobytes()


def test_edge_coefs_at_every_radius_to_60():
    """The same at every radius the card tests and the smoke reach (0-60,
    sigma r / 3), so that the fold's coefficients are the parent's bits."""
    for r in range(61):
        taps = blur.gaussian_taps(r / 3)
        assert len(taps) == 2 * r + 1
        for got, want in zip(blur.edge_coefs(taps), sequential_edge_coefs(taps)):
            assert got.tobytes() == want.tobytes(), r
