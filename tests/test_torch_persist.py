"""The port's persistence scan (pythoncrt_tpu_torch.kernels.persist)
against the JAX Pallas kernel it replaces, run in interpret mode, and
against the oracle's sequential persistence_blend. The CUDA kernel
against its twin on a card is in test_torch_cuda.py.

Tolerances. Against the oracle: bitwise. The port computes
clip(p * s + (1 - p) * x, 0, 1) frame by frame with p and 1 - p rounded
once to f32 and each product rounded, as NumPy does, and casts with
clip(rint(s * 255)). Against the JAX kernel on the CPU: XLA contracts
p * s + (1 - p) * x into a fused multiply-add, one rounding fewer per
frame, so f32 values differ by up to one ulp per frame (1e-6 over six
frames, the bound tests/test_kernels.py uses for the same kernel) and the
uint8 cast by at most 1 LSB where that ulp crosses a rounding edge."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pythoncrt_tpu import oracle
from pythoncrt_tpu.kernels import persist as jpersist
from pythoncrt_tpu_torch.kernels import persist as tpersist

B, H, W = 6, 16, 128


def inputs(seed=0, shape=(B, H, W, 3)):
    rng = np.random.default_rng(seed)
    return (rng.random(shape, dtype=np.float32),
            rng.random(shape[1:], dtype=np.float32))


@pytest.mark.parametrize("emit_u8", [False, True])
@pytest.mark.parametrize("first", [True, False])
def test_twin_matches_jax_kernel(first, emit_u8):
    imgs, state = inputs(1)
    want, want_s = jpersist.persistence_scan(
        jnp.asarray(imgs), jnp.asarray(state), jnp.full((1,), first, jnp.bool_), 0.6,
        interpret=True, emit_u8=emit_u8)
    got, got_s = tpersist.persistence_scan(torch.from_numpy(imgs), torch.from_numpy(state),
                                           first, 0.6, emit_u8=emit_u8)
    assert got.dtype == (torch.uint8 if emit_u8 else torch.float32)
    d = np.abs(got.numpy().astype(np.float64) - np.asarray(want).astype(np.float64))
    if emit_u8:
        assert d.max() <= 1 and (d > 0).mean() < 1e-3
    else:
        assert d.max() <= 1e-6
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=0, atol=1e-6)


@pytest.mark.parametrize("persistence", [0.2, 0.6, 0.95])
def test_twin_is_the_oracle_blend(persistence):
    """Chained over two batches (the state carried, the stream head
    unblended), on an odd planar shape the TPU kernel's tiling refuses."""
    imgs, _ = inputs(2, (2 * 3, 3, 45, 250))
    state, outs = None, []
    for k in range(2):
        x = torch.from_numpy(imgs[3 * k:3 * k + 3])
        first = state is None
        o, state = tpersist.persistence_scan(
            x, torch.zeros_like(x[0]) if first else state, first, persistence, emit_u8=True)
        outs.append(o.numpy())
    prev, want = None, []
    for j in range(imgs.shape[0]):
        prev = oracle.persistence_blend(prev, imgs[j], persistence)
        want.append(oracle.ops.to_uint8(prev))
    np.testing.assert_array_equal(np.concatenate(outs), np.stack(want))
    np.testing.assert_array_equal(state.numpy(), prev)


def test_multiclip_mode_names_its_roadmap_item():
    """The multi-clip mode is ported (tests/test_torch_multiclip.py); what
    it refuses is a batch that does not split into whole clips, as the
    JAX kernel does."""
    imgs, state = (torch.from_numpy(a) for a in inputs(3))
    out, states = tpersist.persistence_scan(imgs, None, False, 0.5,
                                            clip_states=torch.stack([state] * 3))
    assert out.shape == imgs.shape and states.shape == (3, *state.shape)
    with pytest.raises(ValueError, match="4 clips"):
        tpersist.persistence_scan(imgs, None, False, 0.5, clip_states=torch.stack([state] * 4))


def test_cpu_path_makes_no_launch():
    imgs, state = (torch.from_numpy(a) for a in inputs(4))
    n0 = tpersist.launches
    tpersist.persistence_scan(imgs, state, True, 0.5)
    assert tpersist.launches == n0
