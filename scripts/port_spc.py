"""Steps per call on one GPU: n process() calls, process_stack, and a
CUDA graph of process_stack.

    python3 scripts/port_spc.py [--configs defaults,c3,c4,c4-text,c5] [--turns 5]
                                [--repeats 3] [--out port_spc.json]

For each configuration (scripts/port_profile.py's: the CLI defaults, c3,
c4 and c4-text at 1920x1080, batch 8, native rng, planar gbrp frames
already on the card; c5: the c4 params on 4 clips at 3840x2160 through
MultiClipEngine) at the render's auto steps per call n
(pipeline.resolve_steps_per_call; c5: multiclip.auto_steps_per_call):

- engine fps from CUDA events, ``--turns`` turns of ``--repeats``
  super-batches of n * B frames each, the state carried, the modes in
  turns within each turn: n process() calls ("loop"), one
  process_stack ("stack") and, for CRTEngine, one replay of a CUDA graph
  of the stack ("graph", with the host work of a call: make_aux, the
  uploads into the graph's input buffers, the per-frame generators
  reseeded); median, min, max and spread per mode;
- the graph's frames and state against the eager stack's on the same
  inputs (bit for bit or not);
- torch.profiler over one super-batch of each mode: device ms, wall ms
  and the device's idle share.

The graph: the n steps captured once for a fixed (n, B, H, W, layout)
with the state not first, into static frame, input, state and output
buffers. The native draws come from per-frame generators seeded on the
host: the capture takes a pool of generators, one per draw of the
stack in call order, registered with the graph
(torch.cuda.CUDAGraph.register_generator_state) and reseeded with
CRTEngine.frame_seed before each replay. Where this torch lacks
register_generator_state, the native configurations are not captured
and the line says so. c5 is not captured (MultiClipEngine uploads its
inputs inside the stack).

Prints one line per configuration, the card's name and power limit,
and one JSON object; writes the objects to ``--out`` under chiprun_out/
when given. Imports nothing of JAX or of the JAX package; exits 2
without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import port_profile as pp  # noqa: E402  (the configurations and helpers)

H, W, B = pp.H, pp.W, pp.B


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()


def turns(modes: dict, frames_per: int, n_turns: int, repeats: int) -> dict:
    """fps per turn of each mode: ``repeats`` calls between CUDA events,
    the modes' order rotating from turn to turn."""
    import torch

    names = list(modes)
    fps = {k: [] for k in names}
    for t in range(n_turns):
        for k in names[t % len(names):] + names[:t % len(names)]:
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(repeats):
                modes[k]()
            e1.record()
            torch.cuda.synchronize()
            fps[k].append(repeats * frames_per / e0.elapsed_time(e1) * 1e3)
    return fps


def summary(v: list) -> dict:
    med = float(np.median(v))
    return {"median": med, "min": float(min(v)), "max": float(max(v)),
            "spread_pct": (max(v) - min(v)) / med * 100.0, "turns": [float(x) for x in v]}


class StackGraph:
    """A CUDA graph of CRTEngine.process_stack over a fixed (n, B) stack
    of device frames, the state carried in a static buffer."""

    def __init__(self, eng, xs, idx0: np.ndarray, state):
        import torch

        self.eng, self.xs = eng, xs
        self.flat0 = idx0.reshape(-1)
        self.aux = eng.upload(eng.make_aux(self.flat0))  # the static input buffers
        self.state = state.clone()
        self.out = torch.empty_like(xs)
        # the draws of one stack, in call order: (position in the stack, stream)
        self.draws: list = []
        real = eng._frame_generator

        def record(frame_idx, stream):
            self.draws.append((int(np.nonzero(self.flat0 == frame_idx)[0][0]), stream))
            return real(frame_idx, stream)
        eng._frame_generator = record
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):  # warm-up off the capture, as torch asks
            self._body()
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        self.gens = [torch.Generator(device=eng.device) for _ in self.draws]
        self._seed(self.flat0)
        pool = iter(self.gens)
        eng._frame_generator = lambda frame_idx, stream: next(pool)
        self.graph = torch.cuda.CUDAGraph()
        for g in self.gens:
            self.graph.register_generator_state(g)
        try:
            with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
                self._body()
        finally:
            del eng._frame_generator  # the class's method again

    def _body(self):
        st = self.eng._chunks(self.xs, self.aux, self.state, self.out)
        self.state.copy_(st)

    def _seed(self, flat):
        for g, (pos, stream) in zip(self.gens, self.draws):
            g.manual_seed(self.eng.frame_seed(flat[pos], stream))

    def replay(self, idx: np.ndarray):
        """One super-batch at frame indices idx: the host work of a call,
        then the replay. Returns (out, state) (the static buffers)."""
        flat = idx.reshape(-1)
        new = self.eng.upload(self.eng.make_aux(flat))
        for dst, src in zip(self.aux[1:], new[1:]):
            if dst is not None:
                dst.copy_(src, non_blocking=True)
        self._seed(flat)
        self.graph.replay()
        return self.out, self.state


def run_config(name: str, args) -> dict:
    import torch

    from pythoncrt_tpu_torch import CRTEngine, EffectParams, MultiClipEngine, TextParams
    from pythoncrt_tpu_torch import pipeline as tpipe
    from pythoncrt_tpu_torch.multiclip import auto_steps_per_call

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    p = EffectParams(**pp.CONFIGS[name], text=TextParams(**pp.TEXT.get(name, {})))
    res = {"config": name}
    if name == "c5":
        n = auto_steps_per_call(pp.H4, pp.W4, pp.CLIPS, B)
        eng = CRTEngine(p, pp.H4, pp.W4, 24.0, layout="planar", channel_order="gbr", device=dev)
        mc = MultiClipEngine(eng)
        xs = torch.randint(0, 256, (n, pp.CLIPS, B, 3, pp.H4, pp.W4), generator=gen,
                           device=dev, dtype=torch.uint8)
        per = n * pp.CLIPS * B
        box = {"i": 0, "st": None}

        def idx():
            box["i"] += 1
            return (box["i"] * n * B + np.arange(n * B).reshape(n, 1, B)
                    + np.zeros((1, pp.CLIPS, 1), np.int64))

        def loop():
            ii = idx()
            for k in range(n):
                _, box["st"] = mc.process(xs[k], ii[k], box["st"])

        def stack():
            _, box["st"] = mc.process_stack(xs, idx(), box["st"])
        modes = {"loop": loop, "stack": stack}
        res["graph"] = "not captured: MultiClipEngine uploads its inputs inside the stack"
        res["shape"] = f"{pp.CLIPS} clips x B {B}, {pp.W4}x{pp.H4}"
    else:
        n = tpipe.resolve_steps_per_call(H, W, False, 0)
        text = pp.synth_overlay() if name in pp.TEXT else None
        eng = CRTEngine(p, H, W, 24.0, layout="planar", channel_order="gbr", device=dev,
                        text_rgba=text)
        xs = torch.randint(0, 256, (n, B, 3, H, W), generator=gen, device=dev,
                           dtype=torch.uint8)
        per = n * B
        box = {"i": 0, "st": None}

        def idx():
            box["i"] += 1
            return np.arange(box["i"] * per, (box["i"] + 1) * per).reshape(n, B)

        def loop():
            ii = idx()
            for k in range(n):
                _, box["st"] = eng.process(xs[k], ii[k], box["st"])

        def stack():
            _, box["st"] = eng.process_stack(xs, idx(), box["st"])
        modes = {"loop": loop, "stack": stack}
        res["shape"] = f"{W}x{H}, B {B}"
        loop()
        stack()
        torch.cuda.synchronize()
        if not hasattr(torch.cuda.CUDAGraph, "register_generator_state"):
            res["graph"] = (f"not captured: torch {torch.__version__} has no "
                            "CUDAGraph.register_generator_state")
        else:
            t0 = time.perf_counter()
            sg = StackGraph(eng, xs, idx(), box["st"])
            res["graph_capture_s"] = time.perf_counter() - t0
            res["graph_draws"] = len(sg.draws)
            # the graph against the eager stack from one state and one index set
            ii = idx()
            st0 = box["st"].clone()
            want, wst = eng.process_stack(xs, ii, st0.clone())
            sg.state.copy_(st0)
            got, gst = sg.replay(ii)
            torch.cuda.synchronize()
            res["graph_bit_for_bit"] = bool(torch.equal(got, want) and torch.equal(gst, wst))
            res["graph"] = "captured"
            box["st"] = wst

            def graph():
                sg.replay(idx())
            modes["graph"] = graph
    res["steps_per_call"] = n
    for fn in modes.values():
        fn()
    torch.cuda.synchronize()
    fps = turns(modes, per, args.turns, args.repeats)
    res["fps"] = {k: summary(v) for k, v in fps.items()}
    res["profile"] = {}
    for k, fn in modes.items():
        wall_ms, dev_ms, _ = pp.device_split(fn)
        res["profile"][k] = {"wall_ms": wall_ms, "device_ms": dev_ms,
                             "idle_pct": max(0.0, 1.0 - dev_ms / wall_ms) * 100.0}
    return res


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--configs", default="defaults,c3,c4,c4-text,c5")
    ap.add_argument("--turns", type=int, default=5)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("port_spc: no CUDA device available", file=sys.stderr)
        return 2
    from pythoncrt_tpu_torch.kernels import _build

    _build.library()
    c = card()
    results = []
    for name in args.configs.split(","):
        r = run_config(name, args)
        r["card"] = c
        results.append(r)
        fps = "; ".join(f"{k} {v['median']:.2f} fps ({v['min']:.2f}-{v['max']:.2f}, spread "
                        f"{v['spread_pct']:.1f}%)" for k, v in r["fps"].items())
        idle = ", ".join(f"{k} {v['idle_pct']:.1f}%" for k, v in r["profile"].items())
        extra = (f"; graph bit for bit the stack: {r['graph_bit_for_bit']}, {r['graph_draws']} "
                 f"generators, capture {r['graph_capture_s']:.2f}s"
                 if r["graph"] == "captured" else f"; graph {r['graph']}")
        print(f"[spc] {name} ({r['shape']}, {r['steps_per_call']} steps per call): {fps}; "
              f"device idle over one super-batch: {idle}{extra} on {c}", flush=True)
        torch.cuda.empty_cache()
    if args.out:
        os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
        with open(os.path.join(ROOT, "chiprun_out", args.out), "w") as f:
            json.dump(results, f, indent=1)
    print(c)
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
