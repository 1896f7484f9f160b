"""A batch render of several clips in lockstep: one ``MultiClipEngine.process_stack`` call.

As ``multiclip.process_videos`` renders a manifest's group of clips on one
card: the configuration's ``clips`` clips, each ``batch / clips`` frames a
step, their frames one flat clip-major batch through the engine's step and
one launch of the persistence kernel's multi-clip mode. The ring holds
(steps_per_call, clips, batch / clips) frames a call. The clips run in
lockstep at the same frame indices, so they draw the same grain and glitch
streams, as single-clip renders of them with one seed would: the reference
renders each clip as a stream of its own with the run's seed.
"""

import numpy as np

from portbench.entries import crt_engine


class Entry:
    def __init__(self, cfg: dict, traffic: dict) -> None:
        self.cfg, self.engine = cfg, None
        self.clips = int(cfg["clips"])
        self.steps, self.batch = int(traffic["steps_per_call"]), int(traffic["batch"])
        if self.batch % self.clips:
            raise ValueError(f"batch {self.batch} is not a whole number of frames for each of "
                             f"{self.clips} clips")
        self.per = self.batch // self.clips  # a clip's frames in a step
        self.frames = self.steps * self.batch
        h, w = int(cfg["height"]), int(cfg["width"])
        frame = (3, h, w) if cfg["layout"] == "planar" else (h, w, 3)
        self.shape = (self.steps, self.clips, self.per, *frame)

    def indices(self, k: int) -> np.ndarray:
        """Each clip's frames of call k, the same for every clip."""
        n = self.steps * self.per
        one = np.arange(k * n, (k + 1) * n).reshape(self.steps, 1, self.per)
        return np.repeat(one, self.clips, axis=1)

    def build(self, seed: int, device, overlay) -> None:
        from pythoncrt_tpu_torch.parallel import MultiClipEngine

        self.engine = MultiClipEngine(crt_engine(self.cfg, seed, device, overlay))

    def release(self) -> None:
        self.engine = None

    def call(self, x, idx, state, out):
        _, state = self.engine.process_stack(x, idx, state, out=out)
        return state

    def streams(self, ring, k: int, lead: int, seed: int, out=None) -> list:
        n = self.steps * self.per  # a clip's frames in a call
        start, stop = max(0, k * n - lead), (k + 1) * n
        res = []
        for c in range(self.clips):
            x = ring.new_empty((stop - start, *ring.shape[4:]))
            for j in range(start, stop):
                x[j - start] = ring[(j // n) % ring.shape[0], (j % n) // self.per, c,
                                    j % self.per]
            got = None if out is None else out[:, c].reshape(n, *out.shape[3:])
            res.append({"seed": seed, "x": x, "idx": np.arange(start, stop), "n": n,
                        "got": got})
        return res
