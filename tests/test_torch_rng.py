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

import hashlib
import inspect
import math
import re
from fractions import Fraction
from pathlib import Path

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


# --- the kernel's Box-Muller fast path (csrc/box_muller.cuh), modelled ----
# Its tables and constants recomputed in decimal against the header's
# literals; the NumPy model (kernels/rng.py bm_model: the fast path
# operation for operation, FMAs rounded once) against the FP64 twin on
# edge and seeded words: every value the rounding test accepts is the
# twin's f32, and the fast factors stay inside the bounds the test assumes
# (the card sweeps all 2^32 words of each factor: chip_smoke.py [3]).
BM_HEADER = Path(krng.__file__).resolve().parent.parent / "csrc" / "box_muller.cuh"


def header_table(name):
    body = re.search(name + r"\[\d+\] = \{(.*?)\n\};", BM_HEADER.read_text(), re.S).group(1)
    return np.array([[float.fromhex(x) for x in pair]
                     for pair in re.findall(r"\{(\S+), (\S+)\}", body)])


def header_consts():
    src = BM_HEADER.read_text()
    return {k: float.fromhex(v) for k, v in re.findall(r"\b(\w+) = (-?0x[0-9a-f.]+p[+-]\d+)", src)}


def test_bm_tables_are_the_headers():
    ang, lg = krng.bm_tables()
    assert ang.shape == (1024, 2) and lg.shape == (256, 2)
    # the whole circle: the quadrants' points exact, every entry on the circle
    assert [tuple(ang[k]) for k in (0, 256, 512, 768)] == [(0, 1), (1, 0), (0, -1), (-1, 0)]
    assert np.abs(ang[:, 0] ** 2 + ang[:, 1] ** 2 - 1).max() <= 2.0 ** -52
    assert np.array_equal(header_table("kAngle"), ang)
    assert np.array_equal(header_table("kLog"), lg)
    c = header_consts()
    assert [c[f"P{k}"] for k in range(5, -1, -1)] == list(krng.BM_P)
    assert (c["S3"], c["S5"], c["C2"], c["C4"]) == (krng.BM_S3, krng.BM_S5, krng.BM_C2, krng.BM_C4)
    # the coefficients kept to 20 bits (immediates) are within 2^-20 of theirs
    assert abs(krng.BM_P[0] * 3 - 1) < 2.0 ** -20 and abs(krng.BM_S5 * 120 - 1) < 2.0 ** -20
    assert (c["STEP"], c["LN2X2"], c["RAD_REL"], c["ANG_ABS"]) == (
        krng.BM_STEP, krng.BM_LN2X2, krng.BM_RAD_REL, krng.BM_ANG_ABS)
    assert (c["ER"], c["EA"], c["RSQ2"]) == (krng.BM_ER, krng.BM_EA, 0.375)
    # the rounding test's error terms cover the factors' bounds and both
    # products' roundings at least 3.5 times over
    assert krng.BM_ER >= 3.9 * (krng.BM_RAD_REL + 2.0 ** -52)
    assert krng.BM_EA >= 3.9 * krng.BM_ANG_ABS
    # the log table: 1/c to 21 bits (f * (1/c) exact in a double), the
    # intervals' centres, the last one 1
    inv = lg[:, 0]
    assert inv[-1] == 1.0 and lg[-1, 1] == 0.0
    assert np.all(inv * 2 ** 20 == np.round(inv * 2 ** 20))
    centres = 0.5 + (np.arange(255) + 0.5) / 512
    assert np.abs(inv[:-1] * centres - 1).max() < 2.0 ** -20


def test_bm_fma_rounds_once():
    """The model's FMA against the exact value rounded once (fractions), on
    seeded triples and on ones whose exact value sits on or next to a
    rounding midpoint."""
    rng = np.random.default_rng(3)
    a = rng.standard_normal(4000) * 2.0 ** rng.integers(-30, 30, 4000)
    b = rng.standard_normal(4000) * 2.0 ** rng.integers(-30, 30, 4000)
    c = -(a * b) * (1 + rng.standard_normal(4000) * 2.0 ** -rng.integers(1, 60, 4000))
    x = 1.0 + 2.0 ** -27  # (1 + 2^-27)^2 = 1 + 2^-26 + 2^-54: a midpoint after -1 ...
    a = np.concatenate([a, [x, x, x, 1.0 + 2.0 ** -52]])
    b = np.concatenate([b, [x, x, -x, 1.0 - 2.0 ** -53]])
    c = np.concatenate([c, [-1.0, 0.0, 1.0, -1.0]])
    got = krng.bm_fma(a, b, c)
    want = [float(Fraction(p) * Fraction(q) + Fraction(r)) for p, q, r in zip(a, b, c)]
    assert np.array_equal(got, np.array(want))


def edge_words():
    """u: 0, 1, 2^31, 2^32 - 1 and the log table's interval edges +-1 at
    several leading-zero counts; v: every table boundary +-1 (the
    quadrants' among them)."""
    us = {0, 1, 1 << 31, (1 << 32) - 1, (1 << 32) - 2}
    for lz in (0, 1, 8, 23, 24):
        for i in range(256):
            m = ((1 << 31) + (i << 23)) >> lz
            us.update(m - 1 + d for d in (-1, 0, 1) if 0 <= m - 1 + d < 1 << 32)
    vs = {(k << 22) + d for k in range(1024) for d in (-1, 0, 1)}
    vs = {v % (1 << 32) for v in vs} | {(1 << 32) - 1}
    return np.array(sorted(us), np.uint32), np.array(sorted(vs), np.uint32)


def check_model(u, v):
    """The model's pairs against the twin: bit for bit; returns the mask of
    pairs the rounding test accepted."""
    z0, z1, fast = krng.bm_model(u, v)
    t = (torch.from_numpy(x.astype(np.int64)) for x in (u, v))
    w0, w1 = (x.numpy() for x in krng.box_muller(*t))
    assert np.array_equal(z0.view(np.uint32), w0.view(np.uint32))
    assert np.array_equal(z1.view(np.uint32), w1.view(np.uint32))
    return fast


def factor_deviations(u, v):
    keep = u != (1 << 32) - 1
    rp = torch.sqrt(-2.0 * torch.log((torch.from_numpy(u[keep].astype(np.float64)) + 1.0)
                                     * 2.0 ** -32)).numpy()
    th = (2.0 * math.pi) * (torch.from_numpy(v.astype(np.float64)) * 2.0 ** -32)
    c, s = krng.bm_angle_model(v)
    rad = np.abs(krng.bm_radius_model(u[keep]) - rp) / rp
    return rad.max(), max(np.abs(c - torch.cos(th).numpy()).max(),
                          np.abs(s - torch.sin(th).numpy()).max())


def test_bm_model_is_the_twin_on_edge_words():
    """Each edge u with 64 seeded v, each edge v with 64 seeded u, and the
    four named u with every edge v."""
    eu, ev = edge_words()
    rng = np.random.default_rng(11)
    seeded = lambda n: rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)  # noqa
    u = np.concatenate([np.repeat(eu, 64), seeded(ev.size * 64),
                        np.repeat(np.array([0, 1, 1 << 31, (1 << 32) - 1], np.uint32), ev.size)])
    v = np.concatenate([seeded(eu.size * 64), np.repeat(ev, 64), np.tile(ev, 4)])
    fast = check_model(u, v)
    # by design the fallback takes u = 2^32 - 1 (the FP64 expression's r is
    # -0) and v within 1 of a quadrant's start (a factor below 2^-20)
    near = (u == (1 << 32) - 1) | (((v.astype(np.int64) + 1) & ((1 << 30) - 1)) <= 2)
    print(f"edge words: {u.size} pairs, fallback share {1 - fast.mean():.3e}, "
          f"{(~fast & ~near).mean():.3e} away from those words")
    assert not fast[near].any() and (~fast & ~near).mean() < 1e-4
    rad, ang = factor_deviations(eu, ev)
    assert rad < krng.BM_RAD_REL and ang < krng.BM_ANG_ABS


def test_bm_model_is_the_twin_on_seeded_words():
    """2^18 seeded pairs: bit for bit, a fallback share below 1e-4, and the
    fast factors inside the rounding test's bounds by a margin."""
    rng = np.random.default_rng(12)
    u, v = (rng.integers(0, 1 << 32, 1 << 18, dtype=np.uint64).astype(np.uint32)
            for _ in range(2))
    share = float(1 - check_model(u, v).mean())
    rad, ang = factor_deviations(u, v)
    print(f"seeded words: fallback share {share:.3e}; largest deviations from the twin's "
          f"factors: radius 2^{np.log2(rad):.2f} (relative), cos and sin 2^{np.log2(ang):.2f}")
    assert share < 1e-4
    assert rad < krng.BM_RAD_REL / 16 and ang < krng.BM_ANG_ABS / 2


# the export twin's offsets (seed 5; frames 3, 2^32 + 4, ...; amp 6.25 down to
# 0.25) as the parent of the redesigned draw kernel gave them: sha256[:16]
EXPORT_DIGESTS = {
    (1, 1, 1): "9d9f290527a6be62", (1, 1, 9): "ec72d3f8e79c233c",
    (1, 120, 1): "f597db575a3c18e2", (1, 120, 9): "00e6bc882f0ea1dd",
    (15, 1, 1): "bce0ed0c08e2c028", (15, 1, 9): "f6c4b578ebd38215",
    (15, 120, 1): "20d5d32010f769cd", (15, 120, 9): "e7dce97a400fdda9",
    (16, 1, 1): "155d3fc39dc3f4b9", (16, 1, 9): "a38bb2a577d9e4c7",
    (16, 120, 1): "9c3fad43b4d10dcd", (16, 120, 9): "48793d0674c7125c",
    (17, 1, 1): "f75bcc33039e1118", (17, 1, 9): "95bd6771e691d785",
    (17, 120, 1): "83db795464a8b8ed", (17, 120, 9): "e5ff0d435d75048d",
    (324, 1, 1): "231a9e66cf1d630d", (324, 1, 9): "ca1150a8c1c0875f",
    (324, 120, 1): "341af589181847b5", (324, 120, 9): "ca5c8b0e57f31702",
    (648, 1, 1): "ae2e74e908c8a9b2", (648, 1, 9): "1559d882db9789f0",
    (648, 120, 1): "faed20795f367c77", (648, 120, 9): "99774a497256dee6",
}


def edge_amp(rows):
    return torch.from_numpy((6.0 * (1.0 - np.arange(rows, dtype=np.float32) / rows))
                            .astype(np.float32) + np.float32(0.25))


def edge_frames(b):
    return torch.arange(b, dtype=torch.int64) * ((1 << 32) + 1) + 3


@pytest.mark.parametrize("batch", [1, 9])
@pytest.mark.parametrize("nseg", [1, 120])
@pytest.mark.parametrize("rows", [1, 15, 16, 17, 324, 648])
def test_export_twin_unchanged_and_the_model_gives_it(rows, nseg, batch):
    """The export twin's offsets at the edge shapes have the parent's
    digests, and the offsets built from the fast path's model (its walk
    summed in the same order) are the twin's, bit for bit."""
    amp, fr = edge_amp(rows), edge_frames(batch)
    got = krng.glitch_export_offsets_ref(5, fr, nseg, amp)
    assert got.shape == (batch, rows, nseg) and got.dtype == torch.int32
    assert hashlib.sha256(got.numpy().tobytes()).hexdigest()[:16] == EXPORT_DIGESTS[
        (rows, nseg, batch)]

    def normals(n, part=0):
        groups = part + torch.arange(-(-n // 4), dtype=torch.int64)
        w = [x.numpy().astype(np.uint32).reshape(-1)
             for x in krng._words(5, fr, krng.GLITCH_STREAM, groups)]
        z0, z1, _ = krng.bm_model(w[0], w[1])
        z2, z3, _ = krng.bm_model(w[2], w[3])
        return np.stack([z0, z1, z2, z3], -1).reshape(batch, -1)[:, :n]
    a = amp.numpy()
    seg = normals(rows * nseg).reshape(batch, rows, nseg) * (a * np.float32(0.7))[:, None]
    walk = normals(rows, krng.WALK_PART)
    s = np.zeros(batch, np.float32)
    base = np.empty_like(walk)
    for r in range(rows):
        s = s + walk[:, r]
        base[:, r] = np.clip(s * np.float32(0.1), -a[r] * np.float32(0.4), a[r] * np.float32(0.4))
    want = np.rint(base[:, :, None] + seg).astype(np.int32)
    assert np.array_equal(got.numpy(), want)
