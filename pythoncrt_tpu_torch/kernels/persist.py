"""Stage 15, the persistence IIR over a batch: the CUDA kernel and its
plain twin.

Port of pythoncrt_tpu/kernels/persist.py (persistence_scan /
_persist_kernel, and persistence_scan_nhwc which wraps it): the serial
blend s_t = clip(p * s_{t-1} + (1 - p) * x_t, 0, 1) (crt_filter.py:1092)
over the B frames of a batch, the first frame of a stream passed through
unblended (:1094-1095), with the uint8 cast clip(rint(s * 255)) fused
into the store. The blend is elementwise, so any layout works: the
engine hands it planar (B, 3, H, W) frames and a (3, H, W) state.

With ``clip_states`` (C, ...) the batch is C independent clips of B / C
frames laid out flat and clip-major, the multi-clip mode of the TPU
kernel (_persist_kernel_mc): the carry restarts at each clip boundary
from that clip's state (or from the frame itself for a stream head), and
each clip's last carry lands in new_states[c]. MultiClipEngine
(parallel/mesh.py) runs it over the flat batch of a lockstep step.

``persistence_scan`` launches csrc/persist.cu for CUDA tensors and runs
``persistence_scan_ref`` (plain PyTorch, the same op order) for CPU
tensors.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..ops import color as ocolor
from . import _build, dest, into

launches = 0  # CUDA launches made by persistence_scan
multiclip_launches = 0  # those of them in the multi-clip mode (clip_states)


def _coefs(persistence: float) -> tuple[np.float32, np.float32]:
    # p and 1 - p rounded once to f32, as the TPU kernel and the oracle do
    return np.float32(persistence), np.float32(1.0 - persistence)


def persistence_scan_ref(imgs: torch.Tensor, state: torch.Tensor, first: bool,
                         persistence: float, *, emit_u8: bool = False, clip_states=None):
    """The kernel's plain PyTorch twin: a sequential scan over axis 0, or
    with ``clip_states`` one scan per clip of the flat batch."""
    pp, om = _coefs(persistence)
    if clip_states is None:
        clips, states = [imgs], [state]
    else:
        cl = _frames_per_clip(imgs, clip_states)
        clips, states = imgs.split(cl), clip_states
    outs, ends = [], []
    for frames, s in zip(clips, states):
        for t in range(frames.shape[0]):
            x = frames[t]
            s = x if (t == 0 and first) else torch.clamp(pp * s + om * x, 0.0, 1.0)
            outs.append(s)
        ends.append(s.contiguous())
    out = torch.stack(outs)
    out = ocolor.to_uint8(out) if emit_u8 else out
    return (out, ends[0]) if clip_states is None else (out, torch.stack(ends))


def _frames_per_clip(imgs: torch.Tensor, clip_states: torch.Tensor) -> int:
    b, c = imgs.shape[0], clip_states.shape[0]
    if c < 1 or b % c:
        raise ValueError(f"batch {b} not divisible by {c} clips")
    if tuple(clip_states.shape[1:]) != tuple(imgs.shape[1:]):
        raise ValueError(f"clip_states {tuple(clip_states.shape)} do not fit frames "
                         f"{tuple(imgs.shape[1:])}")
    return b // c


class _PersistArgs(ctypes.Structure):
    """Mirror of PersistArgs in csrc/persist.cu (checked by size at launch)."""
    _fields_ = [
        ("imgs", ctypes.c_void_p), ("state", ctypes.c_void_p),
        ("out", ctypes.c_void_p), ("new_state", ctypes.c_void_p),
        ("n", ctypes.c_int64), ("b", ctypes.c_int32), ("first", ctypes.c_int32),
        ("pp", ctypes.c_float), ("om", ctypes.c_float),
        ("emit_u8", ctypes.c_int32), ("vec", ctypes.c_int32), ("cl", ctypes.c_int32),
    ]


def persistence_scan(imgs: torch.Tensor, state: torch.Tensor, first: bool,
                     persistence: float, *, emit_u8: bool = False,
                     clip_states=None, out=None):
    """(B, ...) f32 frames in [0, 1] and a (...) f32 state -> (outs,
    new_state): outs (B, ...) f32, or uint8 with ``emit_u8``; new_state
    the last blended frame (f32). ``first``: the batch opens a stream, so
    frame 0 passes through and ``state`` is not read. With ``clip_states``
    (C, ...): C clips of B / C frames, ``state`` ignored, ``first`` for
    every clip, and new_state (C, ...) (B % C != 0 raises ValueError).
    ``out``: the tensor outs are written into (the kernel's destination),
    or None for a new one.

    CPU tensors run the plain twin; CUDA tensors launch the kernel."""
    global launches, multiclip_launches
    if imgs.device.type == "cpu":
        res, ends = persistence_scan_ref(imgs, state, first, persistence, emit_u8=emit_u8,
                                         clip_states=clip_states)
        return into(out, res), ends
    if imgs.device.type != "cuda":
        raise ValueError(f"persistence_scan: unsupported device {imgs.device}")
    b = imgs.shape[0]
    if b < 1 or imgs.dtype != torch.float32 or not imgs.is_contiguous():
        raise ValueError("persistence_scan: imgs must be a contiguous f32 (B, ...) "
                         "tensor with B >= 1")
    states, cl = (state[None], b) if clip_states is None else (
        clip_states, _frames_per_clip(imgs, clip_states))
    if states.device != imgs.device or states.dtype != torch.float32 \
            or tuple(states.shape[1:]) != tuple(imgs.shape[1:]) or not states.is_contiguous():
        raise ValueError(f"persistence_scan: state must be a contiguous f32 "
                         f"{tuple(imgs.shape[1:])} tensor on {imgs.device}")
    out = dest(out, imgs.shape, torch.uint8 if emit_u8 else torch.float32, imgs.device,
               "persistence_scan")
    new_states = torch.empty_like(states)
    a = _PersistArgs()
    a.imgs, a.state = imgs.data_ptr(), states.data_ptr()
    a.out, a.new_state = out.data_ptr(), new_states.data_ptr()
    a.n, a.b, a.cl, a.first = imgs[0].numel(), b, cl, int(bool(first))
    a.pp, a.om = _coefs(persistence)
    a.emit_u8 = int(emit_u8)
    a.vec = int(a.n % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in (imgs, states, new_states))
                and out.data_ptr() % (4 if emit_u8 else 16) == 0)
    _build.launch("crt_persist_launch", a, imgs.device)
    launches += 1
    multiclip_launches += clip_states is not None
    return out, (new_states[0] if clip_states is None else new_states)
