"""The direct-pow triad's pow sites (csrc/triad_pow.cuh), swept against
the FP64 expressions they replace.

The fused kernel's ``--precision fast`` triad (triad_mode 3) computes, per
value, three sites, each f32 of an FP64 expression:

- ``forward``: ``f32(exp2(double(g) * log2(double(x))))``, x in [0, 1];
- ``log2`` (final): ``f32(log2(double(x)))``, x in [0, 1];
- ``exp2`` (final): ``f32(exp2(double(y)))``, y = t * e <= 0.

``triad_pow.cuh`` answers each from an f32 fast path when a rounding test
says its f32 rounding is certain, else from the FP64 expression itself.
``sweep`` runs those sites on inputs (a range of f32 bit patterns, or a
tensor) on the card (csrc/triad_sweep.cu) and counts the values that
differ from the FP64 expression (there must be none), the fallbacks, the
exact answers and the largest relative distance from a fast value to the
FP64 expression's double. On the CPU its plain version is ``emulate``:
the header's fast paths in NumPy f32 arithmetic (its table and constants
read from the header), against the FP64 expressions in NumPy float64.
"""

from __future__ import annotations

import ctypes
import re
from functools import lru_cache

import numpy as np
import torch

from . import _build

launches = 0  # CUDA launches made by sweep

SITES = ("forward", "log2", "exp2")
HEADER = _build.CSRC / "triad_pow.cuh"
GAMMA_MIN = 0.1  # params.py clamps triad_gamma to at least this
# the inputs each site can be given: [0, 1] for both sites on x (clip01),
# and for the final exp2 t * e with t = log2(x) >= -149 (x subnormal) and
# e = f32(1 / triad_gamma) <= f32(10): [-1500, 0], and -inf (x = 0).
# (first bits, count): f32 bit patterns in increasing order of magnitude
DOMAINS = {"forward": (0x00000000, 0x3F800001), "log2": (0x00000000, 0x3F800001),
           "exp2": (0x80000000, 0x44BB8001)}
EXP2_EXTRA = (float("-inf"),)
SWEEP_GAMMAS = (0.1, 1.0, 1.1, 2.2, 4.0, 10.0)


@lru_cache(maxsize=1)
def header() -> tuple:
    """(table, constants) of triad_pow.cuh: kTab as f32 and each named
    float constant."""
    src = HEADER.read_text()
    at = src.index("kTab[TAB] = {")
    body = re.sub(r"//[^\n]*", "", src[at + len("kTab[TAB] = {"):src.index("};", at)])
    tab = np.array([float.fromhex(t.strip().rstrip("f")) for t in body.split(",") if t.strip()],
                   np.float32)
    consts = {}
    for name, lit in re.findall(r"\b([A-Z][A-Z0-9]*) = (-?0x[0-9a-fA-F.]+p[+-]?\d+|-?\d+\.\d+)f\b",
                                src):
        consts[name] = np.float32(float.fromhex(lit) if "0x" in lit else float(lit))
    ints = dict(re.findall(r"constexpr int (\w+) = (\d+|0x[0-9a-f]+);", src))
    consts["NB"], consts["NE"] = int(ints["NB"]), int(ints["NE"])
    consts["LG_OFF"] = int(ints["LG_OFF"], 16)
    if tab.size != 3 * consts["NB"] + 2 * consts["NE"]:
        raise RuntimeError(f"{HEADER.name}: kTab has {tab.size} values")
    return tab, consts


# ---- the plain version: the header's arithmetic in NumPy ---------------------

_F, _I, _LD = np.float32, np.int32, np.longdouble


def _fma(a, b, c):
    """fmaf: the product is exact in the 64-bit long double, the sum rounds
    there then to f32 (a double rounding only when c is below 2^-64 of the
    product and the product lies on an f32 midpoint)."""
    return (np.asarray(a, _F).astype(_LD) * np.asarray(b, _F).astype(_LD)
            + np.asarray(c, _F).astype(_LD)).astype(_F)


def _bits(x):
    return np.asarray(x, _F).view(_I)


def _flt(i):
    return np.asarray(i, _I).view(_F)


def _log2_df(x):
    t, k_ = header()
    nb = k_["NB"]
    ix = _bits(x)
    tmp = ix - _I(k_["LG_OFF"])
    i = (tmp >> 17) & (nb - 1)
    k = tmp >> 23
    z = _flt(ix - (tmp & _I(-8388608)))
    invc, lh, ll = t[i], t[nb + i], t[2 * nb + i]
    ph = z * invc
    e = _fma(z, invc, -ph)
    r = ph - _F(1)
    s = r * r
    se = _fma(r, r, -s)
    a = _fma(_F(-0.5), s, r)
    ae = _fma(_F(-0.5), s, r - a)
    q = _fma(_fma(_fma(k_["C6"], r, k_["C5"]), r, _F(-0.25)), r, k_["C3"])
    r3 = _fma(s, r, se * r)
    lo = _fma(_F(-0.5), se, ae)
    lo = _fma(e, s - r, lo + e)
    lo = _fma(r3, q, lo)
    wh = a * k_["KH"]
    wl = _fma(a, k_["KH"], -wh)
    wl = _fma(a, k_["KL"], wl)
    wl = _fma(lo, k_["KH"], wl)
    sh = (_flt(_I(0x4B400000) + k) - k_["MAGIC"]) + lh
    hi = sh + wh
    return hi, ((wh - (hi - sh)) + wl) + ll


def _exp2_df(yh, yl=None):
    t, k_ = header()
    nb, ne = k_["NB"], k_["NE"]
    m = k_["MAGIC"]
    tt = _fma(yh, _F(64), m)
    u = _fma(yh, _F(64), -(tt - m))
    nbits = _bits(tt)
    j = nbits & (ne - 1)
    sc = (nbits << 17) & _I(-8388608)
    uf = u
    if yl is not None:
        ul = yl * _F(64)
        uf = u + ul
    q = _fma(_fma(uf, k_["A4"], k_["A3"]), uf, k_["A2"]) * uf
    ph = k_["A1H"] * u
    pl = _fma(k_["A1H"], u, -ph)
    if yl is not None:
        pl = _fma(k_["A1H"], ul, pl)
    pl = _fma(uf, q + k_["A1L"], pl)
    eh, el = t[3 * nb + j], t[3 * nb + ne + j]
    hi = _fma(eh, ph, eh)
    lo = _fma(eh, ph, eh - hi)
    lo = _fma(eh, pl, lo)
    return hi, _fma(el, ph, lo + el), sc


def _decided(hi, lo):
    c = hi + lo
    cl = lo - (c - hi)
    return c, cl, _fma(cl, header()[1]["ZIV"], c) == c


def emulate(site: str, x: np.ndarray, gamma: float = 1.0) -> dict:
    """The header's fast path of ``site`` on f32 inputs ``x``, in NumPy:
    ``v`` (the answer where ``ok``), ``ok``, ``exact`` and the tested value
    (``c`` + ``cl``) * 2^``e2``. The kernel's plain version."""
    x = np.asarray(x, _F)
    with np.errstate(all="ignore"):
        if site == "forward":
            g = _F(gamma)
            lh, ll = _log2_df(x)
            yh = g * lh
            yl = _fma(g, ll, _fma(g, lh, -yh))
            hi, lo, sc = _exp2_df(yh, yl)
            c, cl, ziv = _decided(hi, lo)
            normal = x >= _F(2.0 ** -126)
            exact = (x == 0) | (normal & (yh < _F(-151.5)))
            ok = exact | (normal & (yh >= _F(-124)) & ziv)
            v = np.where(exact, _F(0), _flt(_bits(c) + sc))
        elif site == "log2":
            hi, lo = _log2_df(x)
            c, cl, ziv = _decided(hi, lo)
            sc = np.zeros_like(_bits(c))
            exact = x == 0
            ok = exact | ((x >= _F(2.0 ** -126)) & ziv)
            v = np.where(exact, _F(-np.inf), c)
        elif site == "exp2":
            hi, lo, sc = _exp2_df(x)
            c, cl, ziv = _decided(hi, lo)
            exact = x <= _F(-151)
            ok = exact | ((x >= _F(-124)) & ziv)
            v = np.where(exact, _F(0), _flt(_bits(c) + sc))
        else:
            raise ValueError(f"site must be one of {SITES}, got {site!r}")
    return dict(v=v, ok=ok, exact=exact, c=c, cl=cl, e2=sc >> 23)


def expr(site: str, x: np.ndarray, gamma: float = 1.0) -> np.ndarray:
    """The FP64 expression a site replaces, in float64 (before its f32
    rounding)."""
    xd = np.asarray(x, _F).astype(np.float64)
    with np.errstate(all="ignore"):
        if site == "forward":
            return np.exp2(np.float64(_F(gamma)) * np.log2(xd))
        if site == "log2":
            return np.log2(xd)
        if site == "exp2":
            return np.exp2(xd)
    raise ValueError(f"site must be one of {SITES}, got {site!r}")


def _sweep_ref(site, x, gamma, out, fell) -> dict:
    em = emulate(site, x, gamma)
    ref_d = expr(site, x, gamma)
    ref = ref_d.astype(_F)
    v = np.where(em["ok"], em["v"], ref)
    bad = v.view(_I) != ref.view(_I)
    tested = em["ok"] & ~em["exact"]
    with np.errstate(all="ignore"):
        fv = np.ldexp(em["c"].astype(np.float64) + em["cl"].astype(np.float64), em["e2"])
        d = np.where(fv == ref_d, 0.0, np.abs(fv - ref_d) / np.abs(ref_d))
    if out is not None:
        out.copy_(torch.from_numpy(v))
    if fell is not None:
        fell.copy_(torch.from_numpy((~em["ok"]).astype(np.uint8)))
    return dict(n=int(x.size), mismatches=int(bad.sum()), fallbacks=int((~em["ok"]).sum()),
                exact=int(em["exact"].sum()),
                first=int(np.argmax(bad)) if bad.any() else None,
                max_distance=float(d[tested].max()) if tested.any() else 0.0)


class _SweepArgs(ctypes.Structure):
    """Mirror of TriadSweepArgs in csrc/triad_sweep.cu (checked by size)."""
    _fields_ = [
        ("xs", ctypes.c_void_p), ("out", ctypes.c_void_p), ("fell", ctypes.c_void_p),
        ("counts", ctypes.c_void_p), ("n", ctypes.c_int64), ("start", ctypes.c_uint32),
        ("site", ctypes.c_int32), ("g", ctypes.c_float),
    ]


def sweep(site: str, gamma: float = 1.0, *, xs: torch.Tensor = None, start: int = 0,
          count: int = None, out: torch.Tensor = None, fell: torch.Tensor = None,
          device="cuda") -> dict:
    """``site`` on ``xs`` (an f32 tensor; its device decides) or on the
    ``count`` f32 values with bits ``start``, ``start + 1``, ... (on
    ``device``): counts of values that differ from the FP64 expression
    (``mismatches``, index of the ``first``), of ``fallbacks`` and
    ``exact`` answers, and the largest relative distance from a fast value
    to the FP64 expression (``max_distance``). ``out`` (f32) and ``fell``
    (uint8), when given, receive each value and whether the fallback ran."""
    global launches
    if site not in SITES:
        raise ValueError(f"site must be one of {SITES}, got {site!r}")
    if xs is not None:
        if xs.dtype != torch.float32 or xs.dim() != 1 or not xs.is_contiguous():
            raise ValueError("xs must be a contiguous 1-D float32 tensor")
        n, dev = xs.numel(), xs.device
    else:
        if count is None or count < 1 or start < 0 or start + count > 1 << 32:
            raise ValueError("a range sweep needs 1 <= count and start + count <= 2^32")
        n, dev = int(count), torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    for name, t, dt in (("out", out, torch.float32), ("fell", fell, torch.uint8)):
        if t is not None and (t.dtype != dt or t.numel() != n or t.device != dev
                              or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous {dt} tensor of {n} values on {dev}")
    if dev.type == "cpu":
        x = (xs.numpy() if xs is not None else
             (np.arange(n, dtype=np.uint64) + np.uint64(start)).astype(np.uint32).view(_F))
        return _sweep_ref(site, x, gamma, out, fell)
    if dev.type != "cuda":
        raise ValueError(f"sweep runs on the CPU or a CUDA device, not {dev}")
    counts = torch.zeros(5, dtype=torch.int64, device=dev)
    counts[2] = -1  # the first mismatch: the largest unsigned value until one is found
    a = _SweepArgs(xs=xs.data_ptr() if xs is not None else 0,
                   out=out.data_ptr() if out is not None else 0,
                   fell=fell.data_ptr() if fell is not None else 0,
                   counts=counts.data_ptr(), n=n, start=start & 0xFFFFFFFF,
                   site=SITES.index(site), g=np.float32(gamma))
    _build.launch("crt_triad_sweep_launch", a, dev)
    launches += 1
    c = counts.cpu().numpy()
    return dict(n=n, mismatches=int(c[0]), fallbacks=int(c[1]), exact=int(c[4]),
                first=None if c[2] == -1 else int(c[2]),
                max_distance=float(np.array([c[3]], np.int64).view(np.float64)[0]))


def crafted_inputs(site: str, gamma: float = 2.2, n: int = 1 << 22, seed: int = 0) -> dict:
    """Inputs that must take the FP64 fallback and inputs with an exact
    answer, for the card's tests. ``fallback``: the seeded inputs of the
    pixel range (x in [2^-8, 1], the exp2 argument in [-8, 0]) whose FP64
    expression lies within 2^-40 of an f32 rounding midpoint (no fast value
    within 2^-36 of it can decide their rounding), then the subnormal
    boundaries: subnormal inputs, and arguments whose result falls below
    2^-124 (subnormal or near it). ``exact``: x = 0, and arguments whose
    result rounds to 0 (the exp2 argument at -151 and below, -inf)."""
    rng = np.random.default_rng(seed)
    if site == "exp2":
        x = (-8.0 * rng.random(n)).astype(_F)
    else:
        x = np.exp2(-8.0 * rng.random(n)).astype(_F)
    ref = expr(site, x, gamma)
    f = ref.astype(_F)
    mids = [(f.astype(np.float64) + np.nextafter(f, np.float32(s) * _F(np.inf)).astype(np.float64))
            / 2 for s in (1, -1)]
    with np.errstate(all="ignore"):
        dist = np.minimum(*[np.abs(ref - m) for m in mids]) / np.abs(ref)
    near = x[(dist < 2.0 ** -40) & (ref != 0)]
    sub = np.array([0x00000001, 0x00000400, 0x00400000, 0x007FFFFF], np.uint32).view(_F)
    if site == "exp2":
        edge = np.array([-124.0001, -125.0, -126.0, -140.0, -149.0, -150.0, -150.99], _F)
        exact = np.array([-151.0, -151.5, -1500.0, -np.inf], _F)
    elif site == "log2":
        edge = sub
        exact = np.zeros(1, _F)
    else:  # results from 2^-124 down to 2^-151: g log2 x in [-151, -124.01]
        band = np.exp2(-np.array([124.01, 126.0, 140.0, 150.9]) / float(_F(gamma))).astype(_F)
        edge = np.concatenate([sub, band[band >= 2.0 ** -126]])  # none when gamma < 126/124
        exact = np.array([0.0] + ([np.exp2(-152.0 / float(_F(gamma)))] if gamma > 1.02 else []),
                         _F)
    return dict(fallback=np.concatenate([near, edge]).astype(_F), exact=exact.astype(_F))
