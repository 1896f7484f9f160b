"""The native draws, frozen: Philox4x32-10 and an FP64 Box-Muller in plain torch.

What the port draws on the card for each frame, worked out again from the
seed and the frame indices alone: the grain's standard-normal field
(stream 11) and the export glitch's offsets (stream 14). The generator is
Philox4x32-10 (Salmon et al., SC 2011; Random123's philox4x32_10) keyed by
the seed mod 2^64, its counter (element group, stream tag, frame index low
word, high word). Each group of four 32-bit words gives two normal pairs
by the Box-Muller transform in FP64, rounded once to f32:

    u1 = (u + 1) 2^-32,  u2 = v 2^-32,  r = sqrt(-2 ln u1),
    z0 = r cos(2 pi u2),  z1 = r sin(2 pi u2).

The export glitch follows the upstream export algorithm's distribution
(crt_filter.py:846-850): per (row, segment) N(0, 1) * 0.7 * amp[row], and a
random walk of per-row normals summed down the rows in f32, times 0.1 and
clipped to +-0.4 * amp[row]; the walk's normals are the groups from 2^31 on.

Plain torch on any device; imports nothing of the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch

GRAIN_STREAM, GLITCH_STREAM = 11, 14
WALK_PART = 1 << 31
M0, M1 = 0xD2511F53, 0xCD9E8D57  # Philox4x32 multipliers
W0, W1 = 0x9E3779B9, 0xBB67AE85  # the key schedule's increments
MASK32 = 0xFFFFFFFF


def _mulhilo(m: int, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(high, low) 32-bit words of m * x, x in [0, 2^32) as int64: m in
    16-bit halves so that no partial product leaves int64."""
    a = x * (m & 0xFFFF)
    b = x * (m >> 16)
    t = a + ((b & 0xFFFF) << 16)
    return (b >> 16) + (t >> 32), t & MASK32


def philox4x32_10(c0, c1, c2, c3, seed: int) -> tuple:
    """Philox4x32-10 of four counter words (int64 tensors, broadcast) under
    the seed's key: four int64 tensors of 32-bit words."""
    s = int(seed) % (1 << 64)
    k0, k1 = s & MASK32, s >> 32
    c = list(torch.broadcast_tensors(c0, c1, c2, c3))
    for i in range(10):
        if i:
            k0, k1 = (k0 + W0) & MASK32, (k1 + W1) & MASK32
        hi0, lo0 = _mulhilo(M0, c[0])
        hi1, lo1 = _mulhilo(M1, c[2])
        c = [hi1 ^ c[1] ^ k0, lo1, hi0 ^ c[3] ^ k1, lo0]
    return tuple(c)


def box_muller(u: torch.Tensor, v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    u1 = (u.double() + 1.0) * 2.0 ** -32
    u2 = v.double() * 2.0 ** -32
    r = torch.sqrt(-2.0 * torch.log(u1))
    th = (2.0 * math.pi) * u2
    return (r * torch.cos(th)).float(), (r * torch.sin(th)).float()


def normals(seed: int, frames: torch.Tensor, stream: int, n: int, part: int = 0) -> torch.Tensor:
    """(B, n) f32 normals of the (B,) int64 frame indices: element e is word
    e % 4 of group part + e // 4."""
    groups = part + torch.arange(-(-n // 4), device=frames.device, dtype=torch.int64)
    f = frames.to(torch.int64)[:, None]
    w = philox4x32_10(groups[None], torch.full_like(f, stream), f & MASK32, (f >> 32) & MASK32,
                      seed)
    z0, z1 = box_muller(w[0], w[1])
    z2, z3 = box_muller(w[2], w[3])
    return torch.stack([z0, z1, z2, z3], -1).reshape(frames.shape[0], -1)[:, :n]


def grain(seed: int, frames: torch.Tensor, gh: int, gw: int) -> torch.Tensor:
    """(B, gh, gw) f32 N(0, 1) grain fields."""
    return normals(seed, frames, GRAIN_STREAM, gh * gw).reshape(-1, gh, gw)


def glitch_export(seed: int, frames: torch.Tensor, nseg: int,
                  amp: torch.Tensor) -> torch.Tensor:
    """(B, rows, nseg) int32 export glitch offsets, rint(base + seg)."""
    rows = amp.shape[0]
    seg = (normals(seed, frames, GLITCH_STREAM, rows * nseg).reshape(-1, rows, nseg)
           * (amp * np.float32(0.7))[:, None])
    walk = normals(seed, frames, GLITCH_STREAM, rows, WALK_PART)
    lim = amp * np.float32(0.4)
    s = torch.zeros(frames.shape[0], dtype=torch.float32, device=frames.device)
    base = torch.empty_like(walk)
    for r in range(rows):  # row by row in f32: a cumsum's order is not specified
        s = s + walk[:, r]
        base[:, r] = torch.clamp(s * np.float32(0.1), -lim[r], lim[r])
    return torch.round(base[:, :, None] + seg).to(torch.int32)
