"""The numbers that decide ``correct``: the port's frames against the reference's.

Each compared call comes as the entry's streams (portbench/entries/): per
stream, its input frames from ``lead_frames`` before the call (their first
passed through: the persistence carry from further back is under 2^-40),
their frame indices, the draws' seed and the port's frames of the call. The
reference renders each stream and the uint8 frames are compared value by
value:

- ``max_lsb``: the widest gap, in uint8 steps, over every compared value;
- ``off_share``: the share of compared values that differ at all.
"""

from __future__ import annotations

import torch

from .chain import Chain


def to_rgb(frames: torch.Tensor, cfg: dict) -> torch.Tensor:
    """(N, 3, H, W) planar frames in the configuration's plane order, as
    planes R, G, B."""
    if cfg["layout"] != "planar":
        raise NotImplementedError("the comparison reads planar frames")
    corder = (0, 1, 2) if cfg["channel_order"] == "rgb" else (1, 2, 0)
    return frames[:, [corder.index(c) for c in (0, 1, 2)]]


def gaps(got: torch.Tensor, want: torch.Tensor) -> tuple[int, int]:
    """(widest uint8 gap, values that differ)."""
    d = (got.to(torch.int16) - want.to(torch.int16)).abs()
    return int(d.max().item()), int((d > 0).sum().item())


class Reference:
    """The reference chains of a run, one per seed of its streams."""

    def __init__(self, cfg: dict, device, dtype=torch.float32, overlay=None) -> None:
        self.cfg, self.device, self.dtype, self.overlay = cfg, device, dtype, overlay
        self.chains: dict = {}

    def render(self, stream: dict) -> torch.Tensor:
        """The reference's uint8 RGB frames of the stream's part of a call."""
        seed = stream["seed"]
        if seed not in self.chains:
            self.chains[seed] = Chain(self.cfg, seed, self.device, self.dtype, self.overlay)
        out, _ = self.chains[seed].render(to_rgb(stream["x"], self.cfg), stream["idx"], None)
        return out[out.shape[0] - stream["n"]:]


def compare(calls: dict, cfg: dict, device, overlay=None) -> dict:
    """The numbers over ``calls`` ({k: the entry's streams of call k, each
    with the port's frames under ``got``}), the values compared, and each
    call's widest gap."""
    ref = Reference(cfg, device, overlay=overlay)
    widest, off, values, per_call = 0, 0, 0, {}
    for k, streams in sorted(calls.items()):
        per_call[k] = 0
        for s in streams:
            want = ref.render(s)
            w_k, o_k = gaps(to_rgb(s["got"], cfg), want)
            per_call[k] = max(per_call[k], w_k)
            widest, off, values = max(widest, w_k), off + o_k, values + want.numel()
            del want
    return {"max_lsb": widest, "off_share": off / max(1, values), "values": values,
            "per_call": per_call}
