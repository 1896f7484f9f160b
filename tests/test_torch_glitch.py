"""The port's glitch shear (pythoncrt_tpu_torch.kernels.glitch) and
native glitch draws (the draw kernel's twin, pythoncrt_tpu_torch.kernels.
rng) against the oracle and the JAX package. The CUDA kernel against its twin on a card is in
test_torch_cuda.py.

Tolerances: the shear is a copy, so bitwise against the oracle's
apply_glitch_gather and the JAX XLA shear_band; 1e-5 against the JAX
Pallas kernels in interpret mode, whose one-hot matmuls carry values in
a two-term bf16 split (the bound tests/test_kernels.py uses). The native
draws promise the reference's distributions, not its bits: their mean and
spread are held to stated bounds over many frames."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pythoncrt_tpu import oracle
from pythoncrt_tpu.kernels import glitch as jglitch
from pythoncrt_tpu.ops import glitch as jops
from pythoncrt_tpu_torch import CRTEngine, EffectParams
from pythoncrt_tpu_torch.kernels import glitch as tglitch
from pythoncrt_tpu_torch.kernels import rng as krng
from pythoncrt_tpu_torch.ops import glitch as tops

B, H, W, L = 2, 48, 256, 16


def band_case(seed, h=H, w=W, y0=21, seg_len=L, scale=5.0):
    rng = np.random.default_rng(seed)
    imgs = rng.random((B, 3, h, w), dtype=np.float32)
    nseg = -(-w // seg_len)
    offs = rng.normal(0, scale, (B, h - y0, nseg)).astype(np.float32)
    seg = (np.arange(w) // seg_len).astype(np.int32)
    return imgs, offs, seg


def oracle_shear(imgs, y0, offs, seg):
    return np.stack([np.transpose(oracle.apply_glitch_gather(
        np.transpose(imgs[b], (1, 2, 0)), y0, offs[b][:, seg]), (2, 0, 1))
        for b in range(imgs.shape[0])])


@pytest.mark.parametrize("shape", [(H, W, 21, L), (45, 250, 31, 8), (32, 128, 8, 128)],
                         ids=["48x256", "odd", "per_row"])
def test_shear_twin_is_the_oracle_gather(shape):
    h, w, y0, seg_len = shape
    imgs, offs, seg = band_case(1, h, w, y0, seg_len, scale=200.0)  # big: wraps
    off = tglitch.round_offsets(torch.from_numpy(offs))
    si = torch.from_numpy(seg)
    got = tglitch.shear_planar_inplace(torch.from_numpy(imgs.copy()), y0, off, si).numpy()
    want = oracle_shear(imgs, y0, offs, seg)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:, :, :y0], imgs[:, :, :y0])
    band = tglitch.shear_planar(torch.from_numpy(imgs[:, :, y0:].copy()), off, si).numpy()
    np.testing.assert_array_equal(band, want[:, :, y0:])


def test_shear_rounds_half_to_even_like_the_oracle():
    imgs, _, seg = band_case(2)
    offs = np.tile(np.array([0.5, 1.5, -0.5, -2.5], np.float32), (B, H - 21, 4))
    off = tglitch.round_offsets(torch.from_numpy(offs))
    got = tglitch.shear_planar_inplace(torch.from_numpy(imgs.copy()), 21, off,
                                       torch.from_numpy(seg)).numpy()
    np.testing.assert_array_equal(got, oracle_shear(imgs, 21, offs, seg))


def test_shear_matches_jax_kernels():
    """Both JAX entries: the NHWC band wrapper and the planar in-place
    kernel, in interpret mode."""
    imgs, offs, seg = band_case(3)
    y0 = 21
    off = tglitch.round_offsets(torch.from_numpy(offs))
    got = tglitch.shear_planar_inplace(torch.from_numpy(imgs.copy()), y0, off,
                                       torch.from_numpy(seg)).numpy()
    planar = np.asarray(jglitch.shear_band_batched_planar(imgs, y0, offs, L, interpret=True))
    assert np.abs(got - planar).max() <= 1e-5
    nhwc = np.asarray(jglitch.shear_band_batched(
        np.ascontiguousarray(np.transpose(imgs, (0, 2, 3, 1))), y0, offs, L, interpret=True))
    assert np.abs(got - np.transpose(nhwc, (0, 3, 1, 2))).max() <= 1e-5


@pytest.mark.parametrize("per_row", [False, True])
def test_plain_shear_band_matches_jax(per_row):
    rng = np.random.default_rng(4)
    img = rng.random((H, W, 3), dtype=np.float32)
    y0 = 30
    offs = rng.normal(0, 7, (H - y0,) if per_row else (H - y0, W)).astype(np.float32)
    want = np.asarray(jops.shear_band(jnp.asarray(img), y0, jnp.asarray(offs)))
    got = tops.shear_band(torch.from_numpy(np.ascontiguousarray(img.transpose(2, 0, 1))),
                          y0, torch.from_numpy(offs)).numpy()
    np.testing.assert_array_equal(got.transpose(1, 2, 0), want)


def replay_plan(imgs, y0, off, seg, plan):
    """csrc/glitch.cu's walk replayed at index level, in place on ``imgs``
    (B, 3, H, W) f32 as the engine's entry runs: each block of the plan's
    grid (band row, plane, frame) with its tx threads; the load turns
    (16-byte chunks or scalars) into a shared row filled with NaN, the
    offsets reduced once per segment with C's truncating %, then the store
    turns, each output x + o[seg[x]] less W at most once. Returns the
    frames and how often each value was written."""
    b, _, hs, w = imgs.shape
    rows, nseg = hs - y0, off.shape[2]
    unit = 4 if plan.vec else 1
    wp = -(-w // 4) * 4
    assert plan.tx % 32 == 0 and plan.tx <= 1024
    assert plan.grid == (rows, 3, b)
    assert plan.smem == 4 * (wp + nseg)
    t = np.arange(plan.tx)
    writes = np.zeros(imgs.shape, np.int32)
    for r, p, bi in np.ndindex(*plan.grid):
        shared = np.full(wp, np.nan, np.float32)
        o = np.full(nseg, -1, np.int64)
        for k in range(-(-nseg // plan.tx)):  # before the barrier: offsets, then the row
            s = t + k * plan.tx
            s = s[s < nseg]
            m = np.fmod(off[bi, r, s].astype(np.int64), w)
            o[s] = np.where(m < 0, m + w, m)
        for k in range(-(-(w // unit) // plan.tx)):
            q = t + k * plan.tx
            cols = (q[q < w // unit][:, None] * unit + np.arange(unit)).ravel()
            shared[cols] = imgs[bi, p, y0 + r, cols]
        assert (o >= 0).all() and (o < w).all()
        for k in range(-(-(w // unit) // plan.tx)):  # after it: the stores
            q = t + k * plan.tx
            x = (q[q < w // unit][:, None] * unit + np.arange(unit)).ravel()
            sx = x + o[seg[x]]
            sx = np.where(sx >= w, sx - w, sx)
            imgs[bi, p, y0 + r, x] = shared[sx]
            writes[bi, p, y0 + r, x] += 1
    return imgs, writes


# (B, H, W, y0, segment length or None for one offset per row or "col" for
# one segment per column, offsets: normal scale or "3w" for integers in
# [-3W, 3W], 16-byte aligned buffers)
PLAN_CASES = {
    "48x256": (2, 48, 256, 21, 16, 200.0, True),       # one turn of 64 threads
    "odd": (2, 45, 250, 31, 8, 200.0, True),            # scalar: W % 4 != 0
    "preview": (1, 540, 960, 378, None, 6.0, True),     # the GUI's B = 1, one offset per row
    "wrap_3w": (2, 32, 128, 9, 8, "3w", True),           # wraps both ways
    "nseg_1": (2, 20, 64, 5, None, "3w", True),
    "nseg_w": (1, 24, 200, 13, "col", "3w", True),
    "y0_37": (2, 50, 128, 37, 32, 40.0, True),
    "unaligned": (2, 30, 256, 11, 16, 40.0, False),     # W % 4 == 0, a base off 16 bytes
    "c5_width": (1, 10, 3840, 4, 32, 200.0, True),      # 120 segments, four turns a thread
    "scalar_turns": (1, 9, 1001, 2, 7, "3w", True),     # scalar, four turns a thread
}


@pytest.mark.parametrize("case", list(PLAN_CASES), ids=list(PLAN_CASES))
def test_kernel_plan_replay_is_the_oracle_gather(case):
    """The kernel's walk under glitch_plan, replayed at index level, is
    bit for bit shear_planar_ref and the oracle's apply_glitch_gather;
    each band value is written once, the rows above y0 not at all."""
    b, h, w, y0, seg_len, scale, aligned = PLAN_CASES[case]
    rng = np.random.default_rng(w + h)
    imgs = rng.random((b, 3, h, w), dtype=np.float32)
    if seg_len is None:
        seg = np.zeros(w, np.int32)
    elif seg_len == "col":
        seg = np.arange(w, dtype=np.int32)
    else:
        seg = (np.arange(w) // seg_len).astype(np.int32)
    nseg = int(seg.max()) + 1
    if scale == "3w":
        offs = rng.integers(-3 * w, 3 * w + 1, (b, h - y0, nseg)).astype(np.float32)
    else:
        offs = rng.normal(0, scale, (b, h - y0, nseg)).astype(np.float32)
    off = tglitch.round_offsets(torch.from_numpy(offs))
    plan = tglitch.glitch_plan(b, h - y0, w, nseg, aligned)
    assert plan.vec == (aligned and w % 4 == 0)
    got, writes = replay_plan(imgs.copy(), y0, off.numpy(), seg, plan)
    np.testing.assert_array_equal(writes[:, :, y0:], 1)
    np.testing.assert_array_equal(writes[:, :, :y0], 0)
    want = oracle_shear(imgs, y0, offs, seg)
    np.testing.assert_array_equal(got, want)
    ref = tglitch.shear_planar_ref(torch.from_numpy(imgs[:, :, y0:].copy()), off,
                                   torch.from_numpy(seg)).numpy()
    np.testing.assert_array_equal(got[:, :, y0:], ref)


def c4(**kw):
    d = dict(scanline_strength=0.0, triad_strength=0.0, aberration_px=0, bloom_strength=0.0,
             noise_strength=1.5, vignette_strength=0.0, persistence=0.0, pixel_size=1,
             glitch_amp_px=6, glitch_height_frac=0.3, scanline_speed_px_s=120.0)
    d.update(kw)
    return EffectParams(**d)


@pytest.mark.parametrize("engine_mode", ["export", "preview"])
def test_native_draws_are_invariant_to_batch_split(engine_mode):
    """Draws are a pure function of (seed, frame index): the offsets of
    frames 0-7 as one batch equal two batches of 4, and the glitch's
    stream leaves the grain's as it was."""
    e = CRTEngine(c4(), 60, 256, 24.0, seed=3, engine=engine_mode, device="cpu")
    whole = e.glitch_offsets(e.make_aux(np.arange(8)))
    parts = torch.cat([e.glitch_offsets(e.make_aux(np.arange(4))),
                       e.glitch_offsets(e.make_aux(np.arange(4, 8)))])
    assert torch.equal(whole, parts) and whole.dtype == torch.int32
    assert not torch.equal(whole[0], whole[1])
    aux = e.make_aux(np.arange(4))
    no_glitch = CRTEngine(c4(glitch_amp_px=0), 60, 256, 24.0, seed=3, device="cpu")
    assert torch.equal(e._grain_field(aux), no_glitch._grain_field(aux))


def test_native_export_draws_follow_the_reference_distribution():
    """Over 400 frames of 324 rows: the per-segment offsets are
    N(0, 0.7 * amp) per row (normalized: mean within 0.02, std within
    2%), and the random-walk base stays inside +-0.4 * amp."""
    rows, nseg = 324, 60
    amp = torch.from_numpy((6.0 * (1.0 - np.arange(rows, dtype=np.float32) / rows))
                           .astype(np.float32))
    base, seg = krng.export_fields_ref(1000, torch.arange(400), nseg, amp)
    z = seg / (0.7 * amp)[None, :, None]
    assert abs(z.mean().item()) < 0.02 and abs(z.std().item() - 1.0) < 0.02
    assert (base.abs() <= 0.4 * amp[None] + 1e-6).all()
    host = np.stack([oracle.glitch_fields_export(1080, 1920, 120.0 * i / 24, 6, 0.3)[1]
                     for i in range(40)])
    zh = host / (0.7 * amp.numpy())[None, :, None]
    assert abs(zh.std() - z.std().item()) < 0.02


def test_native_preview_draws_follow_the_reference_distribution():
    """Per-row offsets: clip(N(0, 0.5), +-1) plus +-1 jumps at rate 0.03,
    times the amplitude, clipped to +-amp. Over 2000 frames of 324 rows
    the normalized offsets have mean within 0.01, the share at exactly
    +-amp within 0.005 of the host draws', and none beyond."""
    rows = 324
    amp = torch.from_numpy((6.0 * np.exp(-3.0 * (np.arange(rows, dtype=np.float32) / rows)))
                           .astype(np.float32))
    offs = krng.preview_fields_ref(0, torch.arange(2000), amp)
    z = offs / amp[None]
    assert abs(z.mean().item()) < 0.01
    assert (z.abs() <= 1.0 + 1e-6).all()
    host = np.stack([oracle.glitch_offsets_preview(1080, 1920, 20.0 * i + 0.5, 6, 0.3)
                     for i in range(2000)]) / amp.numpy()[None]
    at_edge = (z.abs() > 1 - 1e-6).float().mean().item()
    assert abs(at_edge - float((np.abs(host) > 1 - 1e-6).mean())) < 0.005
