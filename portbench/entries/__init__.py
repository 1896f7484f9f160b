"""Entries: how a cell's calls drive the port, one module per entry.

``portbench/entries/<entry>.py`` holds a class ``Entry(cfg, traffic)``, where
``cfg`` is the configuration with the traffic's caption as its text
parameters and ``traffic`` the cell's traffic mix. It gives:

- ``shape``: one call's input frames, as the harness's input ring holds
  them, and ``frames``: the frames of one call;
- ``indices(k)``: the frame indices of call k;
- ``build(seed, device, overlay)``: builds the port's engine or engines
  for the cell (set-up); ``release()`` frees them;
- ``call(x, idx, state, out)``: enqueues call k on ring entry ``x`` with
  indices ``idx`` and the carried state, writing its frames into ``out``;
  returns the state to carry;
- ``streams(ring, k, lead, seed, out=None)``: what the reference renders to
  judge call k of the run with ``seed``, one dict per independent stream of
  the call: ``seed`` (the stream's key of its draws), ``x`` (the stream's
  input frames in the engine's layout, from ``lead`` frames before the
  call's first), ``idx`` (their frame indices), ``n`` (the call's frames of
  that stream, the last ``n`` of ``x``) and ``got`` (the port's frames of
  them in ``out``, or None without ``out``).

``build`` is the only part that touches the program: the harness's
control and the reference read ``shape`` and ``streams`` without it.
"""

import numpy as np


def crt_engine(cfg: dict, seed: int, device, overlay):
    """A ``CRTEngine`` for the configuration, the kernel library loaded
    first on a card (the first run in a checkout builds it there)."""
    from pythoncrt_tpu_torch import CRTEngine, EffectParams, TextParams

    if device.type == "cuda":
        from pythoncrt_tpu_torch.kernels import _build

        _build.library()
    p = cfg["params"]
    params = EffectParams(**{k: v for k, v in p.items() if k != "text"},
                          text=TextParams(**p["text"]))
    return CRTEngine(params, int(cfg["height"]), int(cfg["width"]), float(cfg["fps"]),
                     engine=cfg["engine"], rng=cfg["rng"], seed=seed, text_rgba=overlay,
                     precision=cfg["precision"], layout=cfg["layout"],
                     channel_order=cfg["channel_order"], device=device)


class OneStream:
    """One clip through one ``CRTEngine``: call k holds frames
    ``k * frames`` to ``(k + 1) * frames - 1`` of the stream as
    (steps_per_call, batch) frames, read from ring entry ``k % len(ring)``."""

    def __init__(self, cfg: dict, traffic: dict) -> None:
        self.cfg, self.engine = cfg, None
        self.steps, self.batch = int(traffic["steps_per_call"]), int(traffic["batch"])
        self.frames = self.steps * self.batch
        h, w = int(cfg["height"]), int(cfg["width"])
        frame = (3, h, w) if cfg["layout"] == "planar" else (h, w, 3)
        self.shape = (self.steps, self.batch, *frame)

    def indices(self, k: int) -> np.ndarray:
        return np.arange(k * self.frames, (k + 1) * self.frames).reshape(self.steps, self.batch)

    def build(self, seed: int, device, overlay) -> None:
        self.engine = crt_engine(self.cfg, seed, device, overlay)

    def release(self) -> None:
        self.engine = None

    def streams(self, ring, k: int, lead: int, seed: int, out=None) -> list:
        start, stop = max(0, k * self.frames - lead), (k + 1) * self.frames
        flat = ring.reshape(ring.shape[0], self.frames, *ring.shape[3:])
        x = ring.new_empty((stop - start, *ring.shape[3:]))
        for j in range(start, stop):
            x[j - start] = flat[(j // self.frames) % ring.shape[0], j % self.frames]
        got = None if out is None else out.reshape(self.frames, *out.shape[2:])
        return [{"seed": seed, "x": x, "idx": np.arange(start, stop), "n": self.frames,
                 "got": got}]
