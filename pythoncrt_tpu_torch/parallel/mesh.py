"""Frame-axis and clip-axis sharding across CUDA devices.

Port of pythoncrt_tpu/parallel/mesh.py, two axes of data parallelism:

- **Frame axis** (``ShardedCRTEngine``, one clip): each batch splits into
  equal shards of consecutive frames, one per mesh device. Every stage
  but the persistence IIR s_t = p*s_{t-1} + (1-p)*x_t is frame-local.
  Each shard runs stages 1-14 and the persistence kernel from a zero
  state, y_t = p*y_{t-1} + (1-p)*x_t, and reduces its chunk to the
  affine map (A_i, b_i) = (p^{n_i}, y_last). Shard 0 absorbs the stream
  head (the first frame passed through, or the incoming state) as the
  constant map A = 0. A Hillis-Steele prefix composition over the shards,
  ceil(log2 n) rounds that each copy one frame and one scalar to the
  shard d places ahead, composing (A, b) <- (A*A_in, A*b_in + b), leaves
  shard i holding the state after its last frame; shifted by one shard
  it is shard i's incoming carry, which corrects the local outputs as
  clip(y_t + p^{t+1} * carry, 0, 1). The JAX package's default
  collective form and combine order, so the f32 rounding follows it; its
  ``PCRT_SHARD_COLLECTIVE=all_gather`` A/B form has no counterpart here.

- **Clip axis** (``MultiClipEngine``, several clips in lockstep): each
  device takes whole clips, runs their frames through stages 1-14 and
  one launch of the persistence kernel's multi-clip mode. No collective.

One process drives every device, as the JAX package's single controller
drives its mesh through ``shard_map``: ``DeviceMesh`` is a list of
``torch.device``s, each shard's work is enqueued on the current stream of
its own device (the kernels' launches make that device current,
kernels/_build.py), and the JAX collectives become device-to-device copies
(``Tensor.to``), peer copies over NVLink on a multi-card host, which
PyTorch orders against both devices' current streams. Not
``torch.distributed`` with a process per card: that would change the
CLI's process model (its decode and encode threads, a launcher around
``python -m``), and NCCL refuses two ranks on one card, so a one-card
machine could not run it at all. A device may appear more than once in a
mesh: logical shards on one card (or on the CPU), which run the same
code, carry and bookkeeping as shards on several cards.

Every shard on a device uses one engine: the engine itself on its own
device, elsewhere one replica (``CRTEngine.replica``: the same
configuration and host tables). Native rng stays keyed by (seed, absolute
frame index, stream), so a shard draws what the single-device engine
draws for the same frames. Outputs and states are gathered on the
engine's device, which keeps ``CRTEngine.process``'s contract.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import numpy as np
import torch

from .. import perf
from ..engine import CRTEngine, FrameAux, aux_slice, stack_out
from ..kernels import persist as kpersist
from ..ops import color as ocolor

FRAME_AXIS = "frames"
CLIP_AXIS = "clips"


def _canonical(dev) -> torch.device:
    """A device with its index: "cuda" names the current CUDA device."""
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


class DeviceMesh:
    """A one-axis mesh: ``devices`` (a tuple of ``torch.device``) along the
    axis named ``axis``; the counterpart of a ``jax.sharding.Mesh`` built
    from an explicit device array. Devices may repeat (logical shards)."""

    def __init__(self, devices: Sequence, axis: str = FRAME_AXIS) -> None:
        self.devices = tuple(_canonical(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.axis = axis

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(n_devices: Optional[int] = None, axis: str = FRAME_AXIS) -> DeviceMesh:
    """The first ``n_devices`` visible CUDA devices (all of them by
    default) along ``axis``; ValueError when more are asked for than are
    visible."""
    count = torch.cuda.device_count()
    n = n_devices or count
    if n > count:
        raise ValueError(f"requested {n} devices, have {count}")
    return DeviceMesh([torch.device("cuda", i) for i in range(n)], axis)


def may_shard(device) -> bool:
    """Whether a render on ``device`` may spread over the visible cards:
    the device names the CUDA type, not one card ("cuda:1") nor the CPU."""
    dev = torch.device(device)
    return dev.type == "cuda" and dev.index is None


def _check_frame_dims(engine: CRTEngine, frame_dims) -> None:
    """Per-frame dims must match the engine's layout."""
    exp = engine._frame_shape()
    if tuple(frame_dims) != exp:
        raise ValueError(f"frame shape {tuple(frame_dims)} does not match engine "
                         f"layout={engine.layout!r} (expected {exp})")


def _replicas(engine: CRTEngine, mesh: DeviceMesh) -> list:
    """One engine per shard: the engine on its own device, one replica per
    other distinct device, shared by the shards on that device."""
    by_dev = {_canonical(engine.device): engine}
    for d in mesh.devices:
        if d not in by_dev:
            by_dev[d] = engine.replica(d)
    return [by_dev[d] for d in mesh.devices]


def _on(dev: torch.device):
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


def _uploads(mesh: DeviceMesh, reps: list, aux: FrameAux) -> list:
    """Each shard's copy of the aux's device inputs: one upload per
    distinct device, shared by the shards on it."""
    by_dev: dict = {}
    for dev, rep in zip(mesh.devices, reps):
        if dev not in by_dev:
            with _on(dev):
                by_dev[dev] = rep.upload(aux)
    return [by_dev[d] for d in mesh.devices]


def _planar(x: torch.Tensor, nhwc: bool) -> torch.Tensor:
    """A (N, H, W, 3) batch as the kernels' (N, 3, H, W), contiguous."""
    return (x.permute(0, 3, 1, 2) if nhwc else x).contiguous()


def _gather(parts: list, nhwc: bool, device: torch.device, out=None) -> torch.Tensor:
    """Planar (N_i, 3, H, W) shard results, concatenated along axis 0 on
    ``device`` in the engine's layout, into ``out`` when given (a part
    already written there is not copied)."""
    parts = [p.permute(0, 2, 3, 1) if nhwc else p for p in parts]
    if out is None:
        if len(parts) == 1 and parts[0].device == _canonical(device):
            return parts[0].contiguous()
        n = sum(p.shape[0] for p in parts)
        out = torch.empty((n, *parts[0].shape[1:]), dtype=parts[0].dtype, device=device)
    k = 0
    for p in parts:
        dst = out[k:k + p.shape[0]]
        if p.data_ptr() != dst.data_ptr() or p.stride() != dst.stride():
            dst.copy_(p, non_blocking=True)
        k += p.shape[0]
    return out


class ShardedCRTEngine:
    """Frame-axis data parallelism around a CRTEngine.

    ``process(frames, frame_indices, state)`` splits the batch into one
    shard of consecutive frames per mesh device; the batch size must be a
    multiple of the mesh size. Frames are (B, H, W, 3) uint8, or
    (B, 3, H, W) for an engine of layout "planar". Returns (out, state)
    on the engine's device, as ``CRTEngine.process`` does. With
    persistence on, the carry crosses shard boundaries as the module
    docstring sets out (whatever the engine's ``assoc_scan``, as in the
    JAX package); with it off, each shard finishes alone and the state is
    the last shard's tail. The work of every shard is enqueued before any
    carry copy, then the carry rounds, then the corrections; the sharding
    adds no wait for a device."""

    def __init__(self, engine: CRTEngine, mesh: Optional[DeviceMesh] = None) -> None:
        self.engine = engine
        self.mesh = mesh if mesh is not None else make_mesh()
        self.ndev = self.mesh.size
        self._reps = _replicas(engine, self.mesh)
        p = engine.params
        self._persist = p.persistence_on
        self._pp = np.float32(p.persistence)
        self._om = np.float32(1.0 - p.persistence)

    def process(self, frames_u8, frame_indices=None, state=None):
        with perf.span("crt.call"):
            x, aux, state, first = self._inputs(torch.as_tensor(frames_u8)[None],
                                                frame_indices, state)
            out = torch.empty(x.shape[1:], dtype=torch.uint8, device=self.engine.device)
            return out, self._chunks(x, aux, state, first, out[None])

    def process_stack(self, frames_stack, frame_indices, state=None, out=None):
        """n process() calls over (n, B, ...) frames with (n, B) frame
        indices, enqueued back to back (the JAX engine's process_stack):
        one make_aux of the n * B frames, uploaded once to each shard
        device; per chunk the shards' effects, the carry rounds and the
        corrections as in process(), chunk i gathered into ``out[i]`` (a
        (n, B, ...) uint8 tensor on the engine's device; None: a new one).
        Returns (out, final state), bit for bit n process() calls."""
        with perf.span("crt.call"):
            x, aux, state, first = self._inputs(torch.as_tensor(frames_stack), frame_indices,
                                                state)
            out = stack_out(out, x.shape, self.engine.device)
            return out, self._chunks(x, aux, state, first, out)

    def _chunks(self, x: torch.Tensor, aux: FrameAux, state, first: bool,
                out: torch.Tensor):
        """The sharded steps of (n, B, ...) frames (the host aux of their
        n * B frames, the planar state on shard 0's device): chunk i
        gathered into out[i]. Returns the final state in the layout."""
        nhwc = self.engine.layout == "nhwc"
        auxes = _uploads(self.mesh, self._reps, aux)
        b = x.shape[1]
        for i in range(x.shape[0]):
            with perf.span("crt.step"):
                if i:  # the carry after chunk i - 1, where the next composition starts
                    state = state.to(self.mesh.devices[0], non_blocking=True)
                local = self._local(x[i], auxes, i * b)
                if self._persist:
                    carries, state = self._carry(local, state, first and i == 0)
                    outs = self._correct(local, carries)
                else:
                    outs, state = [y for y, _ in local], local[-1][1]
                _gather(outs, nhwc, self.engine.device, out[i])
        return self._state_out(state)

    # -- the steps of process() (chip_smoke.py times them one by one) --

    def _inputs(self, x: torch.Tensor, frame_indices, state):
        """Validate an (n, B, ...) stack; -> (frames, the host aux of its
        n * B frames, planar (3, H, W) state on shard 0's device or None,
        first)."""
        eng = self.engine
        if x.ndim != 2 + len(eng._frame_shape()):
            raise ValueError(f"frames {tuple(x.shape)} are not a (n, B) stack of frames")
        n, b = x.shape[:2]
        _check_frame_dims(eng, x.shape[2:])
        if x.dtype != torch.uint8:
            raise ValueError(f"frames must be uint8, got {x.dtype}")
        if b % self.ndev != 0:
            raise ValueError(f"batch {b} not divisible by mesh size {self.ndev}")
        idx = (np.arange(n * b) if frame_indices is None
               else np.asarray(frame_indices, dtype=np.int64).reshape(-1))
        if idx.size != n * b:
            raise ValueError(f"frame_indices {idx.shape} do not pair with frames {(n, b)}")
        first = state is None
        if not first:
            state = torch.as_tensor(state, dtype=torch.float32)
            if tuple(state.shape) != eng._frame_shape():
                raise ValueError(f"state shape {tuple(state.shape)} != {eng._frame_shape()}")
            state = state.to(self.mesh.devices[0], non_blocking=True)
            if eng.layout == "nhwc":
                state = state.permute(2, 0, 1)
            state = state.contiguous()
        return x, eng.make_aux(idx), state, first

    def _local(self, x: torch.Tensor, auxes: list, off: int = 0) -> list:
        """Every shard's stages 1-14 on its device, then with persistence
        on the zero-init local scan: [(y f32 (n, 3, H, W), y_last)]; with
        it off, each shard's _finish: [(uint8 frames, tail state)].
        ``auxes`` are the shards' uploads (_uploads) of a stack whose
        frames start ``off`` frames before the batch's."""
        nl = x.shape[0] // self.ndev
        nhwc = self.engine.layout == "nhwc"
        p = self.engine.params
        local = []
        for i, (dev, rep) in enumerate(zip(self.mesh.devices, self._reps)):
            sl = slice(i * nl, (i + 1) * nl)
            with _on(dev):
                xs = _planar(x[sl].to(dev, non_blocking=True), nhwc)
                imgs = rep._effects(xs, aux_slice(auxes[i], slice(off + sl.start,
                                                                  off + sl.stop)))
                if self._persist:
                    zero = torch.zeros(imgs.shape[1:], dtype=torch.float32, device=dev)
                    with perf.span("crt.persist"):
                        local.append(kpersist.persistence_scan(imgs, zero, False,
                                                               p.persistence, emit_u8=False))
                else:
                    local.append(rep._finish(imgs, None, True))
        return local

    def _carry(self, local: list, state: Optional[torch.Tensor], first: bool):
        """The shards' incoming carries and the state after the batch (f32
        planar, on the engine's device) by the Hillis-Steele composition
        of the per-shard (A, b) summaries; the A are host f32 scalars."""
        devs, n = self.mesh.devices, self.ndev
        nl = local[0][0].shape[0]
        a_loc = np.float32(self._pp ** nl)
        with _on(devs[0]):
            y0, last0 = local[0]
            # the stream head: frame 0 passed through is the carry
            # s_{-1} = x_0, rebuilt from y_0 = (1 - p) * x_0
            s_init = y0[0] / float(self._om) if first else state
            b = [float(a_loc) * s_init + last0] + [y_last for _, y_last in local[1:]]
        a = [np.float32(0.0)] + [a_loc] * (n - 1)
        d = 1
        while d < n:
            nb, na = list(b), list(a)
            for i in range(d, n):
                with _on(devs[i]):
                    b_in = b[i - d].to(devs[i], non_blocking=True)
                    nb[i] = float(a[i]) * b_in + b[i]
                    na[i] = np.float32(a[i] * a[i - d])
            b, a = nb, na
            d *= 2
        carries = [s_init]
        for i in range(1, n):
            with _on(devs[i]):
                carries.append(b[i - 1].to(devs[i], non_blocking=True))
        with _on(devs[-1]):
            new_state = torch.clamp(b[-1], 0.0, 1.0)
        return carries, new_state

    def _correct(self, local: list, carries: list) -> list:
        """Each shard's outputs clip(y_t + p^(t+1) * carry, 0, 1) as uint8."""
        outs = []
        for dev, (y, _), carry in zip(self.mesh.devices, local, carries):
            with _on(dev):
                t = torch.arange(1, y.shape[0] + 1, dtype=torch.float32, device=dev)
                tpow = torch.pow(float(self._pp), t).reshape(-1, 1, 1, 1)
                outs.append(ocolor.to_uint8(y.add_(tpow * carry).clamp_(0.0, 1.0)))
        return outs

    def _state_out(self, state: torch.Tensor) -> torch.Tensor:
        """A planar state -> the caller's: on the engine's device, in its
        layout."""
        eng = self.engine
        st = state.to(eng.device, non_blocking=True)
        return (st.permute(1, 2, 0) if eng.layout == "nhwc" else st).contiguous()


class MultiClipEngine:
    """Several clips in lockstep, the clip axis sharded over a mesh.

    process(frames (C, B, H, W, 3), indices (C, B), states (C, H, W, 3))
    -> (outs (C, B, H, W, 3) uint8, new states), or (C, B, 3, H, W) and
    (C, 3, H, W) when the engine's layout is "planar". Pass states=None
    for the first step of the streams (each clip's frame 0 passes through
    unblended). Without a mesh every clip runs on the engine's device;
    with one, C must be a multiple of its size and each device takes C /
    size whole clips (clip-major). On each device the clips' frames run
    as one flat batch through stages 1-14 (the effects are per frame),
    then stage 15 as one launch of the persistence kernel's multi-clip
    mode (kernels/persist.py ``clip_states``), which restarts the carry at
    each clip boundary: one ``CRTEngine._step`` with the clips' (C / size,
    3, H, W) states. With persistence off (or ``assoc_scan``),
    ``CRTEngine._finish`` finishes each clip on its own frames, so its
    state is its last frame as the JAX engine's vmapped ``_finish`` gives.

    Native and host rng draw from absolute frame indices, so clips that
    share indices draw the same streams: what N single-clip renders with
    the same seed give (JAX mesh.py:344-350)."""

    def __init__(self, engine: CRTEngine, mesh: Optional[DeviceMesh] = None) -> None:
        self.engine = engine
        self.mesh = mesh if mesh is not None else DeviceMesh([engine.device], CLIP_AXIS)
        self.ndev = self.mesh.size
        self._reps = _replicas(engine, self.mesh)
        self._nhwc = engine.layout == "nhwc"
        # the devices whose step writes its frames straight into the output
        self._same = [not self._nhwc and d == _canonical(engine.device)
                      for d in self.mesh.devices]

    def process(self, frames_u8, frame_indices, states=None):
        eng = self.engine
        with perf.span("crt.call"):
            x = torch.as_tensor(frames_u8)
            fshape = eng._frame_shape()
            if x.dtype != torch.uint8 or x.ndim != 5 or tuple(x.shape[2:]) != fshape:
                raise ValueError(f"frames {x.dtype} {tuple(x.shape)} != uint8 "
                                 f"(C, B, *{fshape}) for layout={eng.layout!r}")
            out, states = self._chunks(x[None], frame_indices, states, None)
            return out[0], states

    def process_stack(self, frames_stack, frame_indices, states=None, out=None):
        """n process() calls over (n, C, B, ...) frames with (n, C, B)
        frame indices, enqueued back to back (the JAX engine's
        process_stack): one make_aux of the n * C * B frames, uploaded once
        to each device; per chunk each device's clips through stages 1-14
        and the multi-clip persistence launch, chunk i gathered into
        ``out[i]`` (a (n, C, B, ...) uint8 tensor on the engine's device;
        None: a new one). The clips' states stay on their devices between
        chunks. Returns (out, final states), bit for bit n process()
        calls."""
        eng = self.engine
        with perf.span("crt.call"):
            x = torch.as_tensor(frames_stack)
            fshape = eng._frame_shape()
            if x.dtype != torch.uint8 or x.ndim != 6 or tuple(x.shape[3:]) != fshape:
                raise ValueError(f"frames {x.dtype} {tuple(x.shape)} != uint8 "
                                 f"(n, C, B, *{fshape}) for layout={eng.layout!r}")
            return self._chunks(x, frame_indices, states, out)

    def _chunks(self, x: torch.Tensor, frame_indices, states, out):
        """The steps of a checked (n, C, B, ...) stack (process_stack)."""
        eng = self.engine
        fshape = eng._frame_shape()
        n, c, b = x.shape[:3]
        if c % self.ndev != 0:
            raise ValueError(f"clip count {c} not divisible by mesh size {self.ndev}")
        idx = np.asarray(frame_indices, dtype=np.int64)
        if idx.size != n * c * b:
            raise ValueError(f"frame_indices {idx.shape} do not pair with {c} clips of {b}")
        first = states is None
        sts = self._states_in(states, c)
        out = stack_out(out, x.shape, eng.device)
        flat = x.reshape(n, c * b, *fshape)  # clip-major per chunk
        out_flat = out.view(n, c * b, *fshape)
        aux = eng.make_aux(idx.reshape(-1))
        nhwc, k = self._nhwc, c // self.ndev
        auxes = _uploads(self.mesh, self._reps, aux)
        for i in range(n):
            with perf.span("crt.step"):
                outs = []
                for s, (dev, rep) in enumerate(zip(self.mesh.devices, self._reps)):
                    fs = slice(s * k * b, (s + 1) * k * b)
                    with _on(dev):
                        f = _planar(flat[i, fs].to(dev, non_blocking=True), nhwc)
                        o, sts[s] = rep._step(f, aux_slice(auxes[s], slice(
                            i * c * b + fs.start, i * c * b + fs.stop)), sts[s], first and i == 0,
                            out_flat[i, fs] if self._same[s] else None)
                    outs.append(o)
                _gather(outs, nhwc, eng.device, out_flat[i])
        with perf.span("crt.carry"):
            return out, _gather(sts, nhwc, eng.device)

    def _states_in(self, states, c: int) -> list:
        """The C clips' states before a stack (None: the streams' first
        step, zeros), checked and placed clip-major on the mesh devices,
        planar: one (C / size, 3, H, W) f32 tensor per device."""
        eng = self.engine
        fshape = eng._frame_shape()
        with perf.span("crt.carry"):
            if states is None:
                states = torch.zeros((c, *fshape), dtype=torch.float32, device=eng.device)
            elif tuple(states.shape) != (c, *fshape):
                raise ValueError(f"states shape {tuple(states.shape)} != {(c, *fshape)}")
            states = torch.as_tensor(states, dtype=torch.float32)
            k = c // self.ndev
            sts = []
            for s, dev in enumerate(self.mesh.devices):
                with _on(dev):
                    sts.append(_planar(states[s * k:(s + 1) * k].to(dev, non_blocking=True),
                                       self._nhwc))
            return sts
