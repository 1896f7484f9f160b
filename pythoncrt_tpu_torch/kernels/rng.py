"""The native rng's draws: the CUDA kernel and its plain twin.

One launch per batch and stream draws, from the (B,) int64 frame indices
on the device, what the JAX package draws with jax.random inside its step
(pythoncrt_tpu/engine.py _grain_field and _glitch_seg_offsets, ops/
glitch.py native_export_fields and native_preview_offsets): the grain's
standard-normal field (stream 11) and the glitch's offsets (stream 14,
export or preview). The generator is Philox4x32-10, keyed by the seed
mod 2^64, its counter (element group, stream tag, frame index low word,
high word): every value is a pure function of (seed, frame, stream,
element), so the draws do not depend on how frames are split into
batches, shards or segments. It is not the JAX package's threefry stream:
the two agree in distribution, not in bits.

csrc/rng.cu is the kernel (one launcher, three entries); the twin repeats
its arithmetic in torch ops: Philox on int64 tensors (each 32-bit
multiplier split into 16-bit halves, so that no product leaves int64),
Box-Muller in FP64 rounded once to f32, uniforms ``(x >> 8) * 2^-24``,
and the export glitch's random walk summed row by row in f32. CPU tensors
run the twin; CUDA tensors launch the kernel (a failed build or launch
raises). The twin runs on the card too, as the smoke's reference.

The kernel reaches the twin's FP64 Box-Muller bits by a table-driven
fast path with a rounding test and the FP64 expression as its fallback
(csrc/box_muller.cuh). ``bm_tables`` recomputes its tables in decimal,
``bm_model`` models it in NumPy, operation for operation but for the
square root's seed (``bm_sqrt_model``); neither is on any engine path.
``sweep`` runs csrc/rng_sweep.cu, which holds the fast factors to the
bounds the rounding test assumes over whole domains.
"""

from __future__ import annotations

import ctypes
import functools
import math
from decimal import Decimal, localcontext
from fractions import Fraction

import numpy as np
import torch

from . import _build, on_card

# CUDA launches made by grain_normals, glitch_export_offsets, glitch_preview_offsets
grain_launches = export_launches = preview_launches = 0

NATIVE_STREAM = "philox4x32-10"  # the generator's name, in segment journals' signatures
GRAIN_STREAM, GLITCH_STREAM = 11, 14  # the JAX engine's fold_in tags
WALK_PART = 1 << 31  # the export glitch's walk normals: groups WALK_PART + row // 4
SMEM_MAX = 232448  # bytes of shared memory a block may use: the export entry's walk, 4 per row
M0, M1 = 0xD2511F53, 0xCD9E8D57  # Philox4x32 multipliers
W0, W1 = 0x9E3779B9, 0xBB67AE85  # its key schedule's increments
MASK32 = 0xFFFFFFFF
MODES = {"grain": 0, "export": 1, "preview": 2}


def key_words(seed: int) -> tuple[int, int]:
    """The Philox key: the seed mod 2^64 as (low, high) 32-bit words."""
    s = int(seed) % (1 << 64)
    return s & MASK32, s >> 32


def round_keys(seed: int) -> list[int]:
    """Philox4x32-10's ten round keys under the seed's key, (low, high)
    word of each round in order: the key bumped by the schedule's
    increments, as the kernel reads them from its launch arguments."""
    k0, k1 = key_words(seed)
    return [w for i in range(10) for w in ((k0 + i * W0) & MASK32, (k1 + i * W1) & MASK32)]


def _mulhilo(m: int, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(high, low) 32-bit words of m * x for x in [0, 2^32) (int64): m
    taken in 16-bit halves, so every partial product fits in int64."""
    a = x * (m & 0xFFFF)  # < 2^48
    b = x * (m >> 16)     # < 2^48
    t = a + ((b & 0xFFFF) << 16)  # < 2^49
    return (b >> 16) + (t >> 32), t & MASK32


def philox4x32(c0, c1, c2, c3, k0: int, k1: int) -> tuple:
    """Philox4x32-10 of the counter words (int64 tensors or ints in [0,
    2^32), broadcast together) under the key (k0, k1): four int64 tensors
    of 32-bit words (Random123's philox4x32_10)."""
    dev = next((v.device for v in (c0, c1, c2, c3) if isinstance(v, torch.Tensor)), None)
    c = list(torch.broadcast_tensors(*(torch.as_tensor(v, dtype=torch.int64, device=dev)
                                       for v in (c0, c1, c2, c3))))
    for i in range(10):
        if i:
            k0, k1 = (k0 + W0) & MASK32, (k1 + W1) & MASK32
        hi0, lo0 = _mulhilo(M0, c[0])
        hi1, lo1 = _mulhilo(M1, c[2])
        c = [hi1 ^ c[1] ^ k0, lo1, hi0 ^ c[3] ^ k1, lo0]
    return tuple(c)


def _words(seed: int, frames: torch.Tensor, stream: int, groups: torch.Tensor) -> tuple:
    """(B, G) Philox words of ``groups`` (G,) for each frame of ``frames``."""
    f = frames.to(torch.int64)[:, None]
    return philox4x32(groups.to(torch.int64)[None], stream, f & MASK32, (f >> 32) & MASK32,
                      *key_words(seed))


def box_muller(u: torch.Tensor, v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Two f32 normals from two words, in FP64 rounded once (csrc/rng.cu)."""
    u1 = (u.double() + 1.0) * 2.0 ** -32
    u2 = v.double() * 2.0 ** -32
    r = torch.sqrt(-2.0 * torch.log(u1))
    th = (2.0 * math.pi) * u2
    return (r * torch.cos(th)).float(), (r * torch.sin(th)).float()


# --- the kernel's Box-Muller fast path (csrc/box_muller.cuh) ---------------
# The constants as the header writes them; bm_tables recomputes its tables.
BM_RAD_REL, BM_ANG_ABS = 2.0 ** -46, 2.0 ** -48  # the fast factors' deviation bounds
BM_ER, BM_EA = 2.0 ** -44, 2.0 ** -46  # the rounding test's error terms: e = r' (EA + ER)
BM_STEP = float.fromhex("0x1.921fb54442d18p-30")  # pi 2^-31
BM_LN2X2 = float.fromhex("0x1.62e42fefa39efp+0")  # 2 ln 2
BM_ANGLES, BM_LOGS = 1024, 256  # the tables' entries: the whole circle; f's intervals
# -2 log1p(r) = r P(r): P's coefficients from r^5 down (the r^5 one kept to 20
# bits, an immediate operand on the card: 2^-21 of a term below 2^-54)
BM_P = (float.fromhex("0x1.55555p-2"),) + tuple(
    float(Fraction(n, d)) for n, d in ((-2, 5), (1, 2), (-2, 3), (1, 1), (-2, 1)))
# sin d = d + d^3 (S3 + d^2 S5), cos d = 1 + d^2 (C2 + d^2 C4); S5 to 20 bits
# (2^-21 of a term below 2^-43)
BM_S3, BM_S5 = float(Fraction(-1, 6)), float.fromhex("0x1.11111p-7")
BM_C2, BM_C4 = -0.5, float(Fraction(1, 24))


def _dsin(x: Decimal) -> Decimal:
    term = s = x
    n = 1
    while abs(term) > Decimal(10) ** -60:
        term = -term * x * x / ((2 * n) * (2 * n + 1))
        s += term
        n += 1
    return s


@functools.lru_cache(maxsize=1)
def bm_tables() -> tuple[np.ndarray, np.ndarray]:
    """The fast path's tables, from 70-digit decimals rounded once:
    (BM_ANGLES, 2) (sin a, cos a) at a = k 2 pi / BM_ANGLES (the first
    quadrant's sines, the others by symmetry, so that the table's zeros and
    ones are exact); (BM_LOGS, 2) (1/c, 2 ln(1/c)) of the intervals of f in
    [0.5, 1), BM_LOGS of them, c the interval's centre (the last one's: 1),
    1/c rounded to 21 significant bits."""
    with localcontext() as ctx:
        ctx.prec = 70
        pi = Decimal("3.14159265358979323846264338327950288419716939937510582097494459230781")
        n4 = BM_ANGLES // 4
        q = [float(_dsin(pi * k / (2 * n4))) for k in range(n4 + 1)]  # the first quadrant
        ang = []
        for k in range(BM_ANGLES):
            i = k % n4
            sin, cos = [(q[i], q[n4 - i]), (q[n4 - i], -q[i]), (-q[i], -q[n4 - i]),
                        (-q[n4 - i], q[i])][k // n4]
            ang.append((sin + 0.0, cos + 0.0))  # + 0.0: no negative zeros
        lg = []
        for i in range(BM_LOGS):
            c = (Decimal(1) if i == BM_LOGS - 1
                 else Decimal(0.5) + (Decimal(i) + Decimal(0.5)) / (2 * BM_LOGS))
            inv = float(Fraction(int((Decimal(1 << 20) / c).to_integral_value()), 1 << 20))
            lg.append((inv, float(2 * Decimal(inv).ln())))
    return np.array(ang), np.array(lg)


def _split(a):
    t = a * 134217729.0  # 2^27 + 1: Veltkamp's split
    hi = t - (t - a)
    return hi, a - hi


def _two_sum(a, b):
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def bm_fma(a, b, c) -> np.ndarray:
    """fma(a, b, c) on float64 arrays, rounded once to nearest: the exact
    product (Dekker), an exact sum, the tail added rounding to odd, then
    one rounding to nearest (Boldo and Melquiond, IEEE TC 57(4), 2008).
    Exact for the fast path's operands (no underflow or overflow)."""
    a, b, c = np.broadcast_arrays(*(np.asarray(x, np.float64) for x in (a, b, c)))
    p = a * b
    (ah, al), (bh, bl) = _split(a), _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    th, tl = _two_sum(c, p)
    v, w = _two_sum(tl, e)
    odd = (w != 0) & ((v.view(np.int64) & 1) == 0)
    v = np.where(odd, np.nextafter(v, np.where(w > 0, np.inf, -np.inf)), v)
    return th + v


def bm_sqrt_model(x: np.ndarray) -> np.ndarray:
    """sqrt_fast: a reciprocal square root refined once to second order,
    then times x. The card seeds it with MUFU's approximation
    (rsqrt.approx.f64); the model seeds it with the CPU's 1/sqrt(x), so the
    two may differ in the last bit: the model's one step that is not the
    kernel's operation."""
    y = 1.0 / np.sqrt(x)
    e = bm_fma(-x, y * y, 1.0)
    y = bm_fma(y * e, bm_fma(e, 0.375, 0.5), y)
    return x * y


def bm_radius_model(u: np.ndarray) -> np.ndarray:
    """The fast radius of uint32 words u (radius_fast; u = 2^32 - 1 gives a
    value the fast path does not use)."""
    _, lg = bm_tables()
    m = (u.astype(np.uint64) + 1) & MASK32
    bits = m.astype(np.float64).view(np.uint64)
    hi = (bits >> 32).astype(np.int64)
    e = (hi >> 20) - 1023  # m in [2^e, 2^(e + 1))
    t = lg[(hi >> 12) & 0xFF]
    f = (((bits & 0x800FFFFFFFFFFFFF) | 0x3FE0000000000000).view(np.float64))  # in [0.5, 1)
    r = bm_fma(f, t[:, 0], -1.0)
    p = bm_fma(r, BM_P[0], BM_P[1])
    for c in BM_P[2:]:
        p = bm_fma(r, p, c)
    return bm_sqrt_model(bm_fma((31 - e).astype(np.float64), BM_LN2X2, t[:, 1] + r * p))


def bm_angle_model(v: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The fast cos and sin of 2 pi v 2^-32 for uint32 words v (angle_fast)."""
    ang, _ = bm_tables()
    v = v.astype(np.uint64)
    t = ang[(v >> 22).astype(np.int64)]
    d = (v & 0x3FFFFF).astype(np.float64) * BM_STEP
    d2 = d * d
    sd = bm_fma(d * d2, bm_fma(d2, BM_S5, BM_S3), d)
    cd = bm_fma(d2, bm_fma(d2, BM_C4, BM_C2), 1.0)
    return bm_fma(t[:, 1], cd, -(t[:, 0] * sd)), bm_fma(t[:, 0], cd, t[:, 1] * sd)


def bm_round_checked(e: np.ndarray, d: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The rounding test (round_checked): d = r' c' rounded to f32, and
    whether d - e and d + e, e = r' (EA + ER), round to the same f32."""
    lo, hi = (d - e).astype(np.float32), (d + e).astype(np.float32)
    return lo, lo.view(np.uint32) == hi.view(np.uint32)


def bm_model(u: np.ndarray, v: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """A model of the kernel's Box-Muller (box_muller), on the CPU and on
    no engine path: (z0, z1, fast) for uint32 word arrays u and v, where
    ``fast`` marks the pairs the rounding test accepted; the others take
    the twin's FP64 expression (box_muller), as the kernel's fallback
    takes that expression."""
    u = np.asarray(u, np.uint32)
    v = np.asarray(v, np.uint32)
    r = bm_radius_model(u)
    c, s = bm_angle_model(v)
    e = r * (BM_EA + BM_ER)
    (z0, ok0), (z1, ok1) = bm_round_checked(e, r * c), bm_round_checked(e, r * s)
    fast = (u != MASK32) & ok0 & ok1
    if not fast.all():
        w = torch.from_numpy(u[~fast].astype(np.int64)), torch.from_numpy(v[~fast].astype(np.int64))
        f0, f1 = box_muller(*w)
        z0[~fast], z1[~fast] = f0.numpy(), f1.numpy()
    return z0, z1, fast


def uniform24(x: torch.Tensor) -> torch.Tensor:
    """f32 uniforms in [0, 1) from words: (x >> 8) * 2^-24, exact."""
    return (x >> 8).float() * np.float32(2.0 ** -24)


def _normals(seed: int, frames: torch.Tensor, stream: int, n: int, part: int = 0) -> torch.Tensor:
    """(B, n) f32 normals: element e is word e % 4 of group part + e // 4."""
    groups = part + torch.arange(-(-n // 4), device=frames.device, dtype=torch.int64)
    w = _words(seed, frames, stream, groups)
    z0, z1 = box_muller(w[0], w[1])
    z2, z3 = box_muller(w[2], w[3])
    return torch.stack([z0, z1, z2, z3], -1).reshape(frames.shape[0], -1)[:, :n]


def grain_normals_ref(seed: int, frames: torch.Tensor, gh: int, gw: int) -> torch.Tensor:
    """The grain entry's twin: (B, gh, gw) f32 N(0, 1) of stream 11."""
    return _normals(seed, frames, GRAIN_STREAM, gh * gw).reshape(-1, gh, gw)


def export_fields_ref(seed: int, frames: torch.Tensor, nseg: int,
                      amp: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The export glitch's f32 fields of stream 14, (base (B, rows), seg
    (B, rows, nseg)), in the reference's distribution (crt_filter.py:
    846-850): per-segment N(0, 1) * 0.7 * amp and a random-walk base, its
    normals summed down the rows in f32 one row at a time, times 0.1,
    clipped to +-0.4 * amp."""
    rows = amp.shape[0]
    seg = (_normals(seed, frames, GLITCH_STREAM, rows * nseg).reshape(-1, rows, nseg)
           * (amp * np.float32(0.7))[:, None])
    walk = _normals(seed, frames, GLITCH_STREAM, rows, WALK_PART)
    lim = amp * np.float32(0.4)
    s = torch.zeros(frames.shape[0], dtype=torch.float32, device=frames.device)
    base = torch.empty_like(walk)
    for r in range(rows):  # the kernel's order; a cumsum's is not specified
        s = s + walk[:, r]
        base[:, r] = torch.clamp(s * np.float32(0.1), -lim[r], lim[r])
    return base, seg


def glitch_export_offsets_ref(seed: int, frames: torch.Tensor, nseg: int,
                              amp: torch.Tensor) -> torch.Tensor:
    """The export entry's twin: (B, rows, nseg) int32 rint(base + seg)."""
    base, seg = export_fields_ref(seed, frames, nseg, amp)
    return torch.round(base[:, :, None] + seg).to(torch.int32)


def preview_fields_ref(seed: int, frames: torch.Tensor, amp: torch.Tensor) -> torch.Tensor:
    """The preview glitch's (B, rows) f32 offsets of stream 14, in the
    reference's distribution (crt_filter.py:670-679): clip(N(0, 0.5),
    +-1) plus +-1 jumps at rate 0.03, times the amplitude, clipped to
    +-amp. Row r is group r: words 0-1 its normal, 2 the jump, 3 the sign."""
    rows = amp.shape[0]
    w = _words(seed, frames, GLITCH_STREAM, torch.arange(rows, device=frames.device))
    z, _ = box_muller(w[0], w[1])
    base = torch.clamp(z * np.float32(0.5), -1.0, 1.0)
    jump = (uniform24(w[2]) < np.float32(0.03)).float()
    sign = torch.where(uniform24(w[3]) < np.float32(0.5), 1.0, -1.0)
    return torch.clamp((base + jump * sign) * amp, -amp, amp)


def glitch_preview_offsets_ref(seed: int, frames: torch.Tensor, amp: torch.Tensor) -> torch.Tensor:
    """The preview entry's twin: (B, rows, 1) int32 rint of the offsets."""
    return torch.round(preview_fields_ref(seed, frames, amp)).to(torch.int32)[:, :, None]


class _RngArgs(ctypes.Structure):
    """Mirror of RngArgs in csrc/rng.cu (checked by size at launch)."""
    _fields_ = [
        ("out", ctypes.c_void_p), ("frames", ctypes.c_void_p), ("amp", ctypes.c_void_p),
        ("mode", ctypes.c_int32), ("b", ctypes.c_int32), ("n0", ctypes.c_int32),
        ("n1", ctypes.c_int32), ("stream", ctypes.c_uint32), ("keys", ctypes.c_uint32 * 20),
    ]


def _on_card(frames: torch.Tensor, name: str) -> bool:
    """``on_card``, and the frame indices must be a (B,) int64 tensor."""
    if frames.dtype != torch.int64 or frames.ndim != 1:
        raise ValueError(f"{name}: frames must be a (B,) int64 tensor, got {frames.dtype} "
                         f"{tuple(frames.shape)}")
    return on_card(frames, name)


def _launch(mode: str, out: torch.Tensor, seed: int, frames: torch.Tensor, stream: int,
            n0: int, n1: int, amp=None) -> torch.Tensor:
    global grain_launches, export_launches, preview_launches
    if frames.shape[0] == 0:
        return out
    if not frames.is_contiguous():
        frames = frames.contiguous()
    a = _RngArgs()
    a.out, a.frames = out.data_ptr(), frames.data_ptr()
    if amp is not None:
        if amp.device != frames.device or amp.dtype != torch.float32 or amp.ndim != 1 \
                or not amp.is_contiguous():
            raise ValueError(f"{mode} offsets: amp must be a contiguous (rows,) f32 tensor on "
                             f"{frames.device}")
        a.amp = amp.data_ptr()
    a.mode, a.b, a.n0, a.n1 = MODES[mode], frames.shape[0], n0, n1
    a.keys[:] = round_keys(seed)
    a.stream = stream
    _build.launch("crt_rng_launch", a, frames.device)
    if mode == "grain":
        grain_launches += 1
    elif mode == "export":
        export_launches += 1
    else:
        preview_launches += 1
    return out


def grain_normals(seed: int, frames: torch.Tensor, gh: int, gw: int) -> torch.Tensor:
    """(B, gh, gw) f32 N(0, 1) grain fields of the frames (stream 11), on
    the device of ``frames``: one launch for the batch."""
    if not _on_card(frames, "grain_normals"):
        return grain_normals_ref(seed, frames, gh, gw)
    if -(-gh * gw // 4) >= 1 << 32:
        raise ValueError(f"grain_normals: a {gh}x{gw} field has more than 2^32 groups")
    out = torch.empty((frames.shape[0], gh, gw), dtype=torch.float32, device=frames.device)
    return _launch("grain", out, seed, frames, GRAIN_STREAM, gh, gw)


def glitch_export_offsets(seed: int, frames: torch.Tensor, nseg: int,
                          amp: torch.Tensor) -> torch.Tensor:
    """(B, rows, nseg) int32 export glitch offsets of the frames (stream
    14; ``amp`` the (rows,) amplitudes): one launch for the batch."""
    if not _on_card(frames, "glitch_export_offsets"):
        return glitch_export_offsets_ref(seed, frames, nseg, amp)
    rows = amp.shape[0]
    if -(-rows * nseg // 4) >= WALK_PART or rows * 4 > SMEM_MAX:
        raise ValueError(f"glitch_export_offsets: a band of {rows} rows x {nseg} segments "
                         "does not fit the kernel")
    out = torch.empty((frames.shape[0], rows, nseg), dtype=torch.int32, device=frames.device)
    return _launch("export", out, seed, frames, GLITCH_STREAM, rows, nseg, amp)


def glitch_preview_offsets(seed: int, frames: torch.Tensor, amp: torch.Tensor) -> torch.Tensor:
    """(B, rows, 1) int32 preview glitch offsets of the frames (stream
    14): one launch for the batch."""
    if not _on_card(frames, "glitch_preview_offsets"):
        return glitch_preview_offsets_ref(seed, frames, amp)
    rows = amp.shape[0]
    out = torch.empty((frames.shape[0], rows, 1), dtype=torch.int32, device=frames.device)
    return _launch("preview", out, seed, frames, GLITCH_STREAM, rows, 1, amp)


class _SweepArgs(ctypes.Structure):
    """Mirror of RngSweepArgs in csrc/rng_sweep.cu."""
    _fields_ = [
        ("counts", ctypes.c_void_p), ("n", ctypes.c_int64), ("start", ctypes.c_uint32),
        ("mode", ctypes.c_int32), ("key0", ctypes.c_uint32), ("key1", ctypes.c_uint32),
        ("stream", ctypes.c_uint32),
    ]


SWEEP_MODES = ("radius", "angle", "pairs")


def sweep(mode: str, start: int = 0, count: int = 1 << 32, device="cuda", seed: int = 0,
          stream: int = GRAIN_STREAM) -> dict:
    """The fast path against the FP64 expression on the card
    (csrc/rng_sweep.cu, one launch), over the words start, start + 1, ...
    (``count`` of them, mod 2^32): ``radius`` (the words as u), ``angle``
    (as v) or ``pairs`` (the Philox words of those groups of frame 0 under
    ``seed`` and ``stream``, two pairs a group). Returns ``over`` (words
    whose fast factor reaches its bound; for pairs, groups with an accepted
    value that is not the FP64 expression's) and the ``first`` of them,
    ``fallbacks`` (pairs left to the fallback; for radius, u = 2^32 - 1),
    and the largest deviations ``max_dev`` (radius: relative; angle:
    absolute, cos and sin)."""
    if mode not in SWEEP_MODES:
        raise ValueError(f"mode must be one of {SWEEP_MODES}, got {mode!r}")
    if not 1 <= count <= 1 << 32 or not 0 <= start < 1 << 32:
        raise ValueError("a sweep needs 1 <= count <= 2^32 words from a start in [0, 2^32)")
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"the sweep runs on a CUDA device, not {dev}")
    counts = torch.zeros(5, dtype=torch.int64, device=dev)
    counts[2] = -1  # the first word over its bound: the largest unsigned value until one is found
    k0, k1 = key_words(seed)
    a = _SweepArgs(counts=counts.data_ptr(), n=count, start=start, mode=SWEEP_MODES.index(mode),
                   key0=k0, key1=k1, stream=stream)
    _build.launch("crt_rng_sweep_launch", a, dev)
    c = counts.cpu().numpy()
    dev_max = np.array(c[3:5], np.int64).view(np.float64)
    return dict(n=count, over=int(c[0]), fallbacks=int(c[1]),
                first=None if c[2] == -1 else int(c[2]),
                max_dev=tuple(float(x) for x in dev_max[:1 if mode == "radius" else 2]))
