"""The port's barrel warp (pythoncrt_tpu_torch.kernels.warp) against the
JAX Pallas kernel in interpret mode and against the oracle's
remap_bilinear_const0. The CUDA kernel against its twin on a card is in
test_torch_cuda.py.

Tolerances: 2e-5 against the JAX kernel (its 3-pass bf16 split bound,
tests/test_kernels.py) and 1e-6 against the oracle, whose op order the
port follows."""

import numpy as np
import pytest
import torch

from pythoncrt_tpu import oracle
from pythoncrt_tpu.kernels import warp as jwarp
from pythoncrt_tpu_torch.kernels import warp as twarp

H, W = 32, 256


@pytest.mark.parametrize("strength", [0.15, 0.5, -0.5])
def test_warp_twin_matches_jax_kernel_and_oracle(strength, rng):
    imgs = rng.random((2, H, W, 3), dtype=np.float32)
    planar = np.ascontiguousarray(np.transpose(imgs, (0, 3, 1, 2)))
    tables = twarp.build_warp_tables(H, W, strength)
    got = twarp.warp_planar(torch.from_numpy(planar), tables).numpy()
    jax_out = np.asarray(jwarp.warp_nhwc(imgs, jwarp.build_warp_tables(H, W, strength),
                                         interpret=True))
    err_jax = np.abs(got - np.transpose(jax_out, (0, 3, 1, 2))).max()
    assert err_jax < 2e-5, f"strength={strength}: vs JAX kernel {err_jax:.3g}"
    map_x, map_y = oracle.barrel_warp_maps(H, W, strength)
    for b in range(2):
        want = oracle.ops.remap_bilinear_const0(imgs[b], map_x, map_y)
        err = np.abs(got[b] - np.transpose(want, (2, 0, 1))).max()
        assert err <= 1e-6, f"strength={strength}: vs oracle {err:.3g}"


def test_warp_u8_emit_is_the_oracle_cast(rng):
    imgs = rng.random((1, 3, H, W), dtype=np.float32)
    tables = twarp.build_warp_tables(H, W, 0.15)
    t = torch.from_numpy(imgs)
    got = twarp.warp_planar(t, tables, emit_u8=True).numpy()
    want = oracle.ops.to_uint8(twarp.warp_planar(t, tables).numpy())
    np.testing.assert_array_equal(got, want)


def test_warp_tables_are_the_oracle_split():
    tables = twarp.build_warp_tables(H, W, 0.3)
    map_x, map_y = oracle.barrel_warp_maps(H, W, 0.3)
    x0, fx = oracle.ops.split_map(map_x)
    y0, fy = oracle.ops.split_map(map_y)
    for got, want in zip(tables, (y0, x0, fy, fx)):
        np.testing.assert_array_equal(got.numpy(), want)
