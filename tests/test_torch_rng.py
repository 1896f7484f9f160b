"""The native rng's draws (pythoncrt_tpu_torch.kernels.rng: Philox4x32-10,
one launch per batch and stream on the card) through their plain twin on
the CPU, against Random123's known answers, against themselves under
another batch split, and against the JAX package's jax.random draws in
distribution (the streams differ by design: threefry there, Philox here;
PARITY.md promises the reference's distributions, not its bits). And the
fused kernel's raw-grain twin: the raw field upsampled in the epilogue,
bit for bit the upsample followed by the grain-size-1 epilogue. The
kernel against its twin on a card is in test_torch_cuda.py.

Moments: N(0, 1) draws over about 1e5 values, |mean| and |std - 1| within
0.02 (six standard errors); the glitch offsets normalized by their
amplitude over 400 (export) and 1000 (preview) frames of 324 rows."""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pythoncrt_tpu.engine import _draw_normal
from pythoncrt_tpu.ops import glitch as jops
from pythoncrt_tpu_torch import CRTEngine, EffectParams
from pythoncrt_tpu_torch import engine as tengine
from pythoncrt_tpu_torch.kernels import fused as tfused
from pythoncrt_tpu_torch.kernels import rng as krng
from pythoncrt_tpu_torch.ops import resize as oresize

from test_engine_vs_oracle import identity_params
from test_fused import FULL

# Random123's known-answer vectors for philox4x32_10: (counter, key) -> words
KNOWN = {
    "zeros": ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    "ones": ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
             (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    "pi": ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
           (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
}
ROWS = 324  # c4's band at 1080p
AMP_EXPORT = (6.0 * (1.0 - np.arange(ROWS, dtype=np.float32) / ROWS)).astype(np.float32)
AMP_PREVIEW = (6.0 * np.exp(-3.0 * (np.arange(ROWS, dtype=np.float32) / ROWS))).astype(np.float32)


@pytest.mark.parametrize("case", sorted(KNOWN))
def test_philox_twin_gives_the_known_answers(case):
    ctr, key, want = KNOWN[case]
    got = krng.philox4x32(*ctr, *key)
    assert tuple(int(v) for v in got) == want


ENTRIES = {
    "grain": lambda f: krng.grain_normals(9, f, 13, 21),
    "export": lambda f: krng.glitch_export_offsets(9, f, 7, torch.from_numpy(AMP_EXPORT[:40])),
    "preview": lambda f: krng.glitch_preview_offsets(9, f, torch.from_numpy(AMP_PREVIEW[:40])),
}


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_draws_are_invariant_to_the_batch_split(entry):
    """Frames {3, 5} drawn alone equal rows 3 and 5 of a batch of 0-7, and
    another seed draws other values."""
    draw = ENTRIES[entry]
    whole = draw(torch.arange(8))
    assert torch.equal(draw(torch.tensor([3, 5])), whole[[3, 5]])
    assert not torch.equal(whole[0], whole[1])
    assert not torch.equal(draw(torch.arange(8) + (1 << 32)), whole)  # the high word counts


def jax_keys(seed, n, stream):
    base = jax.random.key(seed)
    return jax.vmap(lambda f: jax.random.fold_in(jax.random.fold_in(base, f), stream))(
        jnp.arange(n))


def test_grain_moments_match_the_jax_draws():
    """16 fields of 64x96 from each package: N(0, 1) within 0.02 in mean
    and spread, and the two within 0.02 of each other."""
    gh, gw, n = 64, 96, 16
    port = krng.grain_normals(0, torch.arange(n), gh, gw).numpy()
    jx = np.asarray(jax.vmap(lambda k: _draw_normal(k, gh, gw, jnp.float32))(
        jax_keys(0, n, 11)))
    assert port.shape == jx.shape == (n, gh, gw) and port.dtype == np.float32
    for z in (port, jx):
        assert abs(z.mean()) < 0.02 and abs(z.std() - 1.0) < 0.02
    assert abs(port.std() - jx.std()) < 0.02 and abs(port.mean() - jx.mean()) < 0.02


def test_export_offset_moments_match_the_jax_draws():
    """400 frames of 324 rows x 60 segments: the segment offsets over
    0.7 * amp are N(0, 1) within 0.01 in mean and spread for both
    packages, the base stays inside +-0.4 * amp and its mean over amp
    within 0.05 of 0."""
    n, nseg = 400, 60
    amp = torch.from_numpy(AMP_EXPORT)
    pbase, pseg = krng.export_fields_ref(0, torch.arange(n), nseg, amp)
    jbase, jseg = jax.vmap(lambda k: jops.native_export_fields(k, ROWS, nseg, AMP_EXPORT))(
        jax_keys(0, n, 14))
    for base, seg in ((pbase.numpy(), pseg.numpy()), (np.asarray(jbase), np.asarray(jseg))):
        z = seg / (0.7 * AMP_EXPORT)[None, :, None]
        assert abs(z.mean()) < 0.01 and abs(z.std() - 1.0) < 0.01
        assert (np.abs(base) <= 0.4 * AMP_EXPORT[None] + 1e-6).all()
        assert abs((base / AMP_EXPORT[None]).mean()) < 0.05
    off = krng.glitch_export_offsets(0, torch.arange(4), nseg, amp)
    assert off.dtype == torch.int32 and torch.equal(
        off, torch.round(pbase[:4, :, None] + pseg[:4]).to(torch.int32))


def test_preview_offset_moments_match_the_jax_draws():
    """1000 frames of 324 rows: the offsets over amp have mean within
    0.01 of 0 and none beyond +-1 for both packages, and the share at
    exactly +-amp within 0.005 of each other."""
    n = 1000
    amp = torch.from_numpy(AMP_PREVIEW)
    port = krng.preview_fields_ref(0, torch.arange(n), amp).numpy() / AMP_PREVIEW[None]
    jx = np.asarray(jax.vmap(lambda k: jops.native_preview_offsets(k, ROWS, AMP_PREVIEW))(
        jax_keys(0, n, 14))) / AMP_PREVIEW[None]
    edge = []
    for z in (port, jx):
        assert abs(z.mean()) < 0.01 and (np.abs(z) <= 1.0 + 1e-6).all()
        edge.append(float((np.abs(z) > 1 - 1e-6).mean()))
    assert abs(edge[0] - edge[1]) < 0.005
    off = krng.glitch_preview_offsets(0, torch.arange(4), amp)
    assert off.dtype == torch.int32 and torch.equal(
        off[:, :, 0], torch.round(torch.from_numpy(port[:4] * AMP_PREVIEW)).to(torch.int32))


def test_draw_wrappers_refuse_other_frame_tensors():
    with pytest.raises(ValueError, match="int64"):
        krng.grain_normals(0, torch.arange(4, dtype=torch.int32), 4, 4)
    with pytest.raises(ValueError, match="int64"):
        krng.glitch_preview_offsets(0, torch.zeros((2, 2), dtype=torch.int64),
                                    torch.ones(3))


def test_engine_draws_with_the_kernel_alone():
    """The engine keeps no generator or seed sequence: its native grain is
    the draw kernel's twin on the uploaded frame indices, at the raw
    field's size, and its glitch offsets the export entry's."""
    src = inspect.getsource(tengine)
    assert "torch.Generator" not in src and "SeedSequence" not in src
    p = EffectParams(glitch_amp_px=6, glitch_height_frac=0.3, grain_size=3, noise_strength=4.0)
    eng = CRTEngine(p, 40, 64, 24.0, seed=11, device="cpu")
    aux = eng.upload(eng.make_aux(np.arange(5, 9)))
    assert aux.frame_idx.dtype == torch.int64 and aux.frame_idx.tolist() == [5, 6, 7, 8]
    assert torch.equal(eng._grain_field(aux),
                       krng.grain_normals_ref(11, torch.arange(5, 9), 13, 21))
    assert torch.equal(eng.glitch_offsets(aux), krng.glitch_export_offsets_ref(
        11, torch.arange(5, 9), eng._glitch_nseg, eng.consts["glitch_amp"]))
    host = CRTEngine(p, 40, 64, 24.0, seed=11, rng="host", device="cpu")
    assert host.upload(host.make_aux(np.arange(4))).frame_idx is None


@pytest.mark.parametrize("grain_size", [2, 3])
@pytest.mark.parametrize("shape", [(2, 48, 256), (1, 45, 67), (1, 3, 5)],
                         ids=["c3", "odd", "tiny"])
def test_raw_grain_twin_is_the_upsample_then_the_epilogue(shape, grain_size):
    """The raw-grain epilogue (grain size above 1) equals, bit for bit,
    ops/resize.resize_bilinear of the field with the oracle's taps
    followed by the grain-size-1 epilogue, through the whole twin."""
    b, h, w = shape
    p = identity_params(**{**FULL, "noise_strength": 24.0, "grain_size": grain_size})
    eng = CRTEngine(p, h, w, 24.0, rng="host", device="cpu")
    flat = CRTEngine(identity_params(**{**FULL, "noise_strength": 24.0, "grain_size": 1}), h, w,
                     24.0, rng="host", device="cpu")
    assert eng.spec.grain_size == grain_size and flat.spec.grain_size == 1
    x = torch.from_numpy(np.random.default_rng(2).integers(0, 256, (b, 3, h, w), dtype=np.uint8))
    kw = eng.fused_operands(eng.make_aux(np.arange(b)))
    gh, gw = eng.spec.grain_hw
    assert tuple(kw["grain"].shape) == (b, gh, gw) == (b, max(1, h // grain_size),
                                                       max(1, w // grain_size))
    ylo, yf = (torch.from_numpy(np.asarray(a)) for a in tfused.oracle.ops.bilinear_taps(gh, h))
    xlo, xf = (torch.from_numpy(np.asarray(a)) for a in tfused.oracle.ops.bilinear_taps(gw, w))
    field = oresize.resize_bilinear(kw["grain"], ylo.long(), yf, xlo.long(), xf)
    got = tfused.fused_pipeline(x, eng.spec, eng.fused_tables, **kw)
    want = tfused.fused_pipeline(x, flat.spec, flat.fused_tables, **{**kw, "grain": field})
    assert torch.equal(got, want)
