"""Several clips in lockstep through one engine step on one GPU.

Port of pythoncrt_tpu/parallel/mesh.py ``MultiClipEngine`` (BASELINE.json
config 5): C independent clips, B frames each per step, flattened
clip-major into one (C*B, ...) batch. The effects (stages 1-14) are per
frame, so the flat batch runs through ``CRTEngine._effects`` as one
batch; only the persistence carry is clip-aware, and stage 15 runs as
one launch of the persistence kernel's multi-clip mode
(kernels/persist.py ``clip_states``), which restarts the carry at each
clip boundary. With persistence off (or ``assoc_scan``), each clip
finishes through ``CRTEngine._finish`` on its own frames, so its state is
its last frame as the JAX engine's vmapped ``_finish`` gives.

One device: no mesh and no ``shard_map``. ``ShardedCRTEngine`` (frame-axis
sharding across devices) and multi-GPU clip sharding wait for the
multi-GPU slice (ROADMAP.md queue 1, multiclip: multi-GPU).

Native and host rng draw from absolute frame indices, so clips that
share indices draw the same streams: what N single-clip renders with the
same seed give (JAX mesh.py:344-350).
"""

from __future__ import annotations

import numpy as np
import torch

from ..engine import CRTEngine
from ..kernels import persist as kpersist


class MultiClipEngine:
    """process(frames (C, B, H, W, 3), indices (C, B), states (C, H, W, 3))
    -> (outs (C, B, H, W, 3) uint8, new states), or (C, B, 3, H, W) and
    (C, 3, H, W) when the engine's layout is "planar". Pass states=None
    for the first step of the streams (each clip's frame 0 passes through
    unblended)."""

    def __init__(self, engine: CRTEngine) -> None:
        self.engine = engine

    def _finish(self, imgs: torch.Tensor, states: torch.Tensor, first: bool):
        eng = self.engine
        p = eng.params
        if p.persistence_on and not eng.assoc_scan:
            return kpersist.persistence_scan(imgs, None, first, p.persistence, emit_u8=True,
                                             clip_states=states)
        b = imgs.shape[0] // states.shape[0]
        outs, ends = zip(*(eng._finish(imgs[k * b:(k + 1) * b], states[k], first)
                           for k in range(states.shape[0])))
        return torch.cat(outs), torch.stack(ends)

    def process(self, frames_u8, frame_indices, states=None):
        eng = self.engine
        x = torch.as_tensor(frames_u8).to(eng.device, non_blocking=True)
        fshape = eng._frame_shape()
        if x.dtype != torch.uint8 or x.ndim != 5 or tuple(x.shape[2:]) != fshape:
            raise ValueError(f"frames {x.dtype} {tuple(x.shape)} != uint8 (C, B, *{fshape}) "
                             f"for layout={eng.layout!r}")
        c, b = x.shape[:2]
        idx = np.asarray(frame_indices, dtype=np.int64)
        if idx.size != c * b:
            raise ValueError(f"frame_indices {idx.shape} do not pair with {c} clips of {b}")
        first = states is None
        if first:
            states = torch.zeros((c, *fshape), dtype=torch.float32, device=eng.device)
        elif tuple(states.shape) != (c, *fshape):
            raise ValueError(f"states shape {tuple(states.shape)} != {(c, *fshape)}")
        states = torch.as_tensor(states, dtype=torch.float32).to(eng.device)
        flat = x.reshape(c * b, *fshape)  # clip-major
        aux = eng.make_aux(idx.reshape(-1))
        if eng.layout == "nhwc":
            flat, states = flat.permute(0, 3, 1, 2), states.permute(0, 3, 1, 2)
        out, new_states = self._finish(eng._effects(flat.contiguous(), aux),
                                       states.contiguous(), first)
        if eng.layout == "nhwc":
            out, new_states = out.permute(0, 2, 3, 1), new_states.permute(0, 2, 3, 1)
        return out.contiguous().reshape(c, b, *fshape), new_states.contiguous()

    def process_stack(self, frames_stack, frame_indices, states=None):
        """n sequential process() calls over (n, C, B, ...) frames with
        (n, C, B) frame indices. Returns ((n, C, B, ...) uint8, states)."""
        idx = np.asarray(frame_indices)
        outs = []
        for frames, ii in zip(frames_stack, idx.reshape(len(frames_stack), -1)):
            out, states = self.process(frames, ii, states)
            outs.append(out)
        return torch.stack(outs), states
