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
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from . import _build

# CUDA launches made by grain_normals, glitch_export_offsets, glitch_preview_offsets
grain_launches = export_launches = preview_launches = 0

NATIVE_STREAM = "philox4x32-10"  # the generator's name, in segment journals' signatures
GRAIN_STREAM, GLITCH_STREAM = 11, 14  # the JAX engine's fold_in tags
WALK_PART = 1 << 31  # the export glitch's walk normals: groups WALK_PART + row // 4
EXPORT_TILE = 16  # band rows per block of the export entry
M0, M1 = 0xD2511F53, 0xCD9E8D57  # Philox4x32 multipliers
W0, W1 = 0x9E3779B9, 0xBB67AE85  # its key schedule's increments
MASK32 = 0xFFFFFFFF
MODES = {"grain": 0, "export": 1, "preview": 2}


def key_words(seed: int) -> tuple[int, int]:
    """The Philox key: the seed mod 2^64 as (low, high) 32-bit words."""
    s = int(seed) % (1 << 64)
    return s & MASK32, s >> 32


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
        ("n1", ctypes.c_int32), ("key0", ctypes.c_uint32), ("key1", ctypes.c_uint32),
        ("stream", ctypes.c_uint32), ("tile", ctypes.c_int32),
    ]


def _on_card(frames: torch.Tensor, name: str) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU one (the
    twin); the frame indices must be a (B,) int64 tensor."""
    if frames.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {frames.device}")
    if frames.dtype != torch.int64 or frames.ndim != 1:
        raise ValueError(f"{name}: frames must be a (B,) int64 tensor, got {frames.dtype} "
                         f"{tuple(frames.shape)}")
    return frames.device.type == "cuda"


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
    a.key0, a.key1 = key_words(seed)
    a.stream, a.tile = stream, EXPORT_TILE
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
    if -(-rows * nseg // 4) >= WALK_PART or (rows + EXPORT_TILE) * 4 > 232448:
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
