"""Stage 12, the barrel warp: the CUDA kernel and its plain twin.

Port of pythoncrt_tpu/kernels/warp.py (warp_planar / _warp_kernel). The
static inverse map is split on the host by the oracle
(oracle.barrel_warp_maps + oracle.ops.split_map) into integer floor
coordinates and f32 fractions; the kernel gathers four taps per output
pixel directly. The TPU kernel's one-hot matmul masks and window-row
classes are MXU workarounds and have no counterpart here.

csrc/warp.cu reads the tables once per batch: one thread owns four
adjacent outputs, loads their tables once and loops over the batch's
planes.

``warp_planar`` launches csrc/warp.cu for CUDA tensors and runs
``warp_planar_ref`` (plain PyTorch) for CPU tensors.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from .. import oracle
from ..ops import color as ocolor
from ..ops.warp import bilinear_gather_const0
from . import _build, dest, into

launches = 0  # CUDA launches made by warp_planar


class WarpTables(NamedTuple):
    y0: torch.Tensor  # (H, W) int32
    x0: torch.Tensor  # (H, W) int32
    fy: torch.Tensor  # (H, W) f32
    fx: torch.Tensor  # (H, W) f32


def build_warp_tables(h: int, w: int, strength: float, device="cpu") -> WarpTables:
    map_x, map_y = oracle.barrel_warp_maps(h, w, strength)
    x0, fx = oracle.ops.split_map(map_x)
    y0, fy = oracle.ops.split_map(map_y)
    return WarpTables(*(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                        for a in (y0, x0, fy, fx)))


def warp_planar_ref(img: torch.Tensor, tables: WarpTables, *,
                    emit_u8: bool = False) -> torch.Tensor:
    """The warp kernel's plain PyTorch twin, on any device."""
    out = bilinear_gather_const0(img, *tables)
    return ocolor.to_uint8(out) if emit_u8 else out


class _WarpArgs(ctypes.Structure):
    """Mirror of WarpArgs in csrc/warp.cu (checked by size at launch)."""
    _fields_ = [
        ("img", ctypes.c_void_p), ("out", ctypes.c_void_p),
        ("y0", ctypes.c_void_p), ("x0", ctypes.c_void_p),
        ("fy", ctypes.c_void_p), ("fx", ctypes.c_void_p),
        ("b", ctypes.c_int32), ("h", ctypes.c_int32), ("w", ctypes.c_int32),
        ("emit_u8", ctypes.c_int32), ("vec", ctypes.c_int32),
    ]


def warp_planar(img: torch.Tensor, tables: WarpTables, *,
                emit_u8: bool = False, out=None) -> torch.Tensor:
    """(B, 3, H, W) f32 in [0, 1] -> warped f32, or uint8
    clip(rint(v * 255)) with ``emit_u8``, written into ``out`` when
    given. CPU tensors run the plain twin; CUDA tensors launch the
    kernel."""
    global launches
    if img.device.type == "cpu":
        return into(out, warp_planar_ref(img, tables, emit_u8=emit_u8))
    if img.device.type != "cuda":
        raise ValueError(f"warp_planar: unsupported device {img.device}")
    b, c, h, w = img.shape
    if c != 3 or img.dtype != torch.float32 or not img.is_contiguous():
        raise ValueError("warp_planar: img must be a contiguous f32 (B, 3, H, W) tensor")
    a = _WarpArgs()
    a.img = img.data_ptr()
    for name, t, dt in (("y0", tables.y0, torch.int32), ("x0", tables.x0, torch.int32),
                        ("fy", tables.fy, torch.float32), ("fx", tables.fx, torch.float32)):
        if t.device != img.device or t.dtype != dt or tuple(t.shape) != (h, w) \
                or not t.is_contiguous():
            raise ValueError(f"warp_planar: table {name} must be a contiguous {dt} "
                             f"({h}, {w}) tensor on {img.device}")
        setattr(a, name, t.data_ptr())
    out = dest(out, (b, 3, h, w), torch.uint8 if emit_u8 else torch.float32, img.device,
               "warp_planar")
    a.out = out.data_ptr()
    a.b, a.h, a.w = b, h, w
    a.emit_u8 = int(emit_u8)
    a.vec = int(w % 4 == 0 and all(p % 16 == 0 for p in (a.out, a.y0, a.x0, a.fy, a.fx)))
    _build.launch("crt_warp_launch", a, img.device)
    launches += 1
    return out
