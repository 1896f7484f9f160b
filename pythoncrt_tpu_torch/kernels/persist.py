"""Stage 15, the persistence IIR over a batch: the CUDA kernel and its
plain twin.

Port of pythoncrt_tpu/kernels/persist.py (persistence_scan /
_persist_kernel, and persistence_scan_nhwc which wraps it): the serial
blend s_t = clip(p * s_{t-1} + (1 - p) * x_t, 0, 1) (crt_filter.py:1092)
over the B frames of a batch, the first frame of a stream passed through
unblended (:1094-1095), with the uint8 cast clip(rint(s * 255)) fused
into the store. The blend is elementwise, so any layout works: the
engine hands it planar (B, 3, H, W) frames and a (3, H, W) state.

``persistence_scan`` launches csrc/persist.cu for CUDA tensors and runs
``persistence_scan_ref`` (plain PyTorch, the same op order) for CPU
tensors. The multi-clip mode of the TPU kernel (_persist_kernel_mc,
per-clip carries in one flat batch) belongs to the multi-clip engine
(ROADMAP.md queue 1, multiclip).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..ops import color as ocolor
from . import _build

launches = 0  # CUDA launches made by persistence_scan


def _coefs(persistence: float) -> tuple[np.float32, np.float32]:
    # p and 1 - p rounded once to f32, as the TPU kernel and the oracle do
    return np.float32(persistence), np.float32(1.0 - persistence)


def persistence_scan_ref(imgs: torch.Tensor, state: torch.Tensor, first: bool,
                         persistence: float, *, emit_u8: bool = False):
    """The kernel's plain PyTorch twin: a sequential scan over axis 0."""
    pp, om = _coefs(persistence)
    outs = []
    s = state
    for t in range(imgs.shape[0]):
        x = imgs[t]
        s = x if (t == 0 and first) else torch.clamp(pp * s + om * x, 0.0, 1.0)
        outs.append(s)
    out = torch.stack(outs)
    return (ocolor.to_uint8(out) if emit_u8 else out), s.contiguous()


class _PersistArgs(ctypes.Structure):
    """Mirror of PersistArgs in csrc/persist.cu (checked by size at launch)."""
    _fields_ = [
        ("imgs", ctypes.c_void_p), ("state", ctypes.c_void_p),
        ("out", ctypes.c_void_p), ("new_state", ctypes.c_void_p),
        ("n", ctypes.c_int64), ("b", ctypes.c_int32), ("first", ctypes.c_int32),
        ("pp", ctypes.c_float), ("om", ctypes.c_float),
        ("emit_u8", ctypes.c_int32), ("vec", ctypes.c_int32),
    ]


def persistence_scan(imgs: torch.Tensor, state: torch.Tensor, first: bool,
                     persistence: float, *, emit_u8: bool = False,
                     clip_states=None):
    """(B, ...) f32 frames in [0, 1] and a (...) f32 state -> (outs,
    new_state): outs (B, ...) f32, or uint8 with ``emit_u8``; new_state
    the last blended frame (f32). ``first``: the batch opens a stream, so
    frame 0 passes through and ``state`` is not read.

    CPU tensors run the plain twin; CUDA tensors launch the kernel."""
    global launches
    if clip_states is not None:
        raise NotImplementedError(
            "the multi-clip persistence mode is not ported yet: "
            "ROADMAP.md queue 1, multiclip (item 9)")
    if imgs.device.type == "cpu":
        return persistence_scan_ref(imgs, state, first, persistence, emit_u8=emit_u8)
    if imgs.device.type != "cuda":
        raise ValueError(f"persistence_scan: unsupported device {imgs.device}")
    b = imgs.shape[0]
    if b < 1 or imgs.dtype != torch.float32 or not imgs.is_contiguous():
        raise ValueError("persistence_scan: imgs must be a contiguous f32 (B, ...) "
                         "tensor with B >= 1")
    if state.device != imgs.device or state.dtype != torch.float32 \
            or tuple(state.shape) != tuple(imgs.shape[1:]) or not state.is_contiguous():
        raise ValueError(f"persistence_scan: state must be a contiguous f32 "
                         f"{tuple(imgs.shape[1:])} tensor on {imgs.device}")
    out = torch.empty(imgs.shape, device=imgs.device,
                      dtype=torch.uint8 if emit_u8 else torch.float32)
    new_state = torch.empty_like(state)
    a = _PersistArgs()
    a.imgs, a.state = imgs.data_ptr(), state.data_ptr()
    a.out, a.new_state = out.data_ptr(), new_state.data_ptr()
    a.n, a.b, a.first = state.numel(), b, int(bool(first))
    a.pp, a.om = _coefs(persistence)
    a.emit_u8 = int(emit_u8)
    a.vec = int(a.n % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in (imgs, state, new_state))
                and out.data_ptr() % (4 if emit_u8 else 16) == 0)
    _build.launch("crt_persist_launch", a, torch.cuda.current_stream(imgs.device).cuda_stream)
    launches += 1
    return out, new_state
