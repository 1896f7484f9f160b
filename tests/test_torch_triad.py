"""The direct-pow triad's pow sites (csrc/triad_pow.cuh) on the CPU.

The header's tables and constants are recomputed here in 60-digit decimal
arithmetic; its fast paths run in NumPy f32 arithmetic (kernels/triad.py
``emulate``, the sweep kernel's plain version) against the FP64
expressions they replace: on seeded inputs of each site's domain every
value is the FP64 expression's, each fast value lies within the rounding
test's margin of it, and the crafted inputs next to f32 rounding
midpoints and the subnormal boundaries take the fallback. The card runs
the same sweeps through the kernel (tests/test_torch_cuda.py,
chip_smoke.py [3]). The sweep domains are held to the inputs the clamped
parameters can give the kernel."""

from decimal import Decimal, getcontext

import numpy as np
import pytest
import torch

from pythoncrt_tpu_torch import CRTEngine, EffectParams
from pythoncrt_tpu_torch.kernels import fused as kfused
from pythoncrt_tpu_torch.kernels import triad

getcontext().prec = 60
LN2 = Decimal(2).ln()
CENTRAL = (37, 38)  # the bins either side of 1.0: invc = 1, lc = 0


def f32(v) -> np.float32:
    return np.float32(float(v))


def bits(v) -> int:
    return int(np.array([v], np.float32).view(np.uint32)[0])


def bin_edges(i: int) -> tuple:
    _, k = triad.header()
    lo = k["LG_OFF"] + (i << 17)
    return tuple(float(np.array([b], np.uint32).view(np.float32)[0]) for b in (lo, lo + (1 << 17)))


def test_log2_table_is_gal_accurate():
    """invc_i near 1 / (bin centre); lh_i the multiple of 2^-16 nearest
    -log2(invc_i), so that k + lh_i is exact for |k| <= 127; ll_i the f32
    of the rest, below 2^-28; |z invc_i - 1| within the header's bound, and
    |lh_i| above every |w| of its bin (the fast two-sum's order)."""
    tab, k = triad.header()
    nb = k["NB"]
    kmax = max(abs(float(k["KH"])) * 0.00764 * 1.01, 0)
    for i in range(nb):
        invc, lh, ll = tab[i], tab[nb + i], tab[2 * nb + i]
        lo, hi = bin_edges(i)
        if i in CENTRAL:
            assert (invc, lh, ll) == (1.0, 0.0, 0.0)
            assert lo == 1.0 or hi == 1.0
        lc = -(Decimal(float(invc)).ln() / LN2)
        want_lh = (lc * 65536).to_integral_value() / 65536
        assert Decimal(float(lh)) == want_lh
        assert ll == f32(lc - want_lh) and abs(float(ll)) < 2.0 ** -28
        r = max(abs(lo * float(invc) - 1), abs(hi * float(invc) - 1))
        assert r <= (2.0 ** -6 if i == 38 else 2.0 ** -6.9)
        if i not in CENTRAL and hi <= 1.0:  # reached with k = 0
            assert abs(float(lh)) > kmax
    assert nb == 64 and bin_edges(0)[0] == 0.703125 and bin_edges(nb - 1)[1] == 1.40625


def test_exp2_table_and_constants():
    tab, k = triad.header()
    nb, ne = k["NB"], k["NE"]
    for j in range(ne):
        v = (LN2 * j / ne).exp()
        assert tab[3 * nb + j] == f32(v)
        assert tab[3 * nb + ne + j] == f32(v - Decimal(float(f32(v))))
    inv_ln2, a1 = 1 / LN2, LN2 / 64
    assert k["KH"] == f32(inv_ln2) and k["KL"] == f32(inv_ln2 - Decimal(float(k["KH"])))
    assert k["A1H"] == f32(a1) and k["A1L"] == f32(a1 - Decimal(float(k["A1H"])))
    assert (k["A2"], k["A3"], k["A4"]) == (f32(a1 ** 2 / 2), f32(a1 ** 3 / 6), f32(a1 ** 4 / 24))
    assert (k["C3"], k["C4"], k["C5"], k["C6"]) == (f32(Decimal(1) / 3), f32(-0.25),
                                                    f32(Decimal(1) / 5), f32(Decimal(-1) / 6))
    assert k["ZIV"] == np.float32(1 + 2.0 ** -11) and k["MAGIC"] == np.float32(1.5 * 2 ** 23)
    assert kfused.DIRECT_TAB == tab.size == 3 * nb + 2 * ne


def test_sweep_domains_cover_the_clamped_inputs():
    """triad_gamma is clamped to >= 0.1, so the final exp2 site's argument
    t * e (t = log2 x >= -149 for a subnormal x, e = f32(1 / gamma) <= 10)
    is >= -1500: the swept domains hold every input the kernel can give
    each site (-inf aside, swept on its own), and the sweep's gammas hold
    the clamp and the CLI default."""
    eng = CRTEngine(EffectParams(triad_gamma=0.01), 8, 8, 24.0, precision="fast", device="cpu")
    assert kfused.triad_mode(eng.spec) == 3 and eng.spec.triad_gamma == triad.GAMMA_MIN
    e_max = np.float32(1.0 / float(eng.spec.triad_gamma))  # as _static_args rounds it
    t_min = np.float32(np.log2(np.float64(np.float32(2.0 ** -149))))
    y_min = t_min * e_max
    start, count = triad.DOMAINS["exp2"]
    assert (start, start + count - 1) == (bits(-0.0), bits(-1500.0))
    assert -1500.0 <= y_min < -1400.0 and triad.EXP2_EXTRA == (float("-inf"),)
    for site in ("forward", "log2"):
        assert triad.DOMAINS[site] == (bits(0.0), bits(1.0) + 1)
    assert {triad.GAMMA_MIN, EffectParams().triad_gamma} <= set(triad.SWEEP_GAMMAS)


CASES = [("log2", 1.0), ("exp2", 1.0)] + [("forward", g) for g in triad.SWEEP_GAMMAS]
IDS = [f"{s}-{g:g}" if s == "forward" else s for s, g in CASES]


@pytest.mark.parametrize("site, gamma", CASES, ids=IDS)
def test_emulated_sites_are_the_fp64_expressions(site, gamma):
    """2^16 seeded bit patterns of the domain and 2^16 values of the pixel
    range: every value is the FP64 expression's; fast values within 2^-36.5
    of it; under 2^-9 of the pixel range falls back."""
    n = 1 << 16
    rng = np.random.default_rng(7 + triad.SITES.index(site) + int(10 * gamma))
    start, count = triad.DOMAINS[site]
    x = (start + rng.integers(0, count, n, dtype=np.int64)).astype(np.uint32).view(np.float32)
    r = triad.sweep(site, gamma, xs=torch.from_numpy(x))
    assert r["mismatches"] == 0 and r["max_distance"] < 2.0 ** -36.5, r
    u = rng.random(n)
    px = (-8.0 * u if site == "exp2" else np.exp2(-8.0 * u)).astype(np.float32)
    r = triad.sweep(site, gamma, xs=torch.from_numpy(px))
    assert r["mismatches"] == 0 and r["fallbacks"] < n / 512, r


@pytest.mark.parametrize("site, gamma", [("log2", 1.0), ("exp2", 1.0), ("forward", 0.1),
                                         ("forward", 2.2), ("forward", 10.0)])
def test_crafted_inputs_take_the_fallback(site, gamma):
    c = triad.crafted_inputs(site, gamma)
    em = triad.emulate(site, c["fallback"], gamma)
    assert c["fallback"].size > 40 and not em["ok"].any()
    em = triad.emulate(site, c["exact"], gamma)
    assert em["ok"].all() and em["exact"].all()
    want = triad.expr(site, c["exact"], gamma).astype(np.float32)
    assert np.array_equal(em["v"].view(np.int32), want.view(np.int32))


def test_sweep_on_the_cpu_fills_values_and_fallbacks():
    xs = torch.tensor([0.0, 2.0 ** -130, 0.25, 0.5, 1.0], dtype=torch.float32)
    out = torch.empty_like(xs)
    fell = torch.empty(5, dtype=torch.uint8)
    r = triad.sweep("forward", 2.2, xs=xs, out=out, fell=fell)
    assert r["n"] == 5 and r["mismatches"] == 0 and r["exact"] == 1  # x = 0; 2^-130 falls back
    assert fell.tolist() == [0, 1, 0, 0, 0]
    want = triad.expr("forward", xs.numpy(), 2.2).astype(np.float32)
    assert np.array_equal(out.numpy(), want)
    r = triad.sweep("log2", start=bits(0.5), count=1000, device="cpu")
    assert r["n"] == 1000 and r["mismatches"] == 0
    with pytest.raises(ValueError, match="site"):
        triad.sweep("pow", xs=xs)
    with pytest.raises(ValueError, match="count"):
        triad.sweep("log2", start=bits(0.5), device="cpu")
    with pytest.raises(ValueError, match="float32"):
        triad.sweep("log2", xs=xs.double())
    with pytest.raises(ValueError, match="fell"):
        triad.sweep("log2", xs=xs, fell=torch.empty(4, dtype=torch.uint8))
