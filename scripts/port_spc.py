"""Steps per call on one GPU: n process() calls, process_stack, and a
CUDA graph of process_stack; engine fps, device idle and the native
draws' cost, for an A/B of two trees.

    python3 scripts/port_spc.py [--configs defaults,c3,c4,c4-text,c5,sharded-c4-x4]
                                [--modes loop,stack,graph] [--turns 5] [--repeats 3]
                                [--tree DIR] [--tag NAME] [--out port_spc.json]

``--tree`` is the checkout whose ``pythoncrt_tpu_torch`` is imported and
built (default: this script's own). An earlier commit unpacked with
``git archive`` into a git-ignored directory runs its own code, so that
two trees compare in one call (``--modes stack``: the graph needs this
tree's keyed draws).

For each configuration (scripts/port_profile.py's: the CLI defaults, c3,
c4 and c4-text at 1920x1080, batch 8, native rng, planar gbrp frames
already on the card; c5: the c4 params on 4 clips at 3840x2160 through
MultiClipEngine; sharded-c4-x4: c4 through ShardedCRTEngine over 4
logical shards of cuda:0, at 2 steps per call) at the render's auto
steps per call n (pipeline.resolve_steps_per_call; c5:
multiclip.auto_steps_per_call):

- engine fps from CUDA events, ``--turns`` turns of ``--repeats``
  super-batches of n * B frames each, the state carried, the modes in
  turns within each turn: n process() calls ("loop"), one
  process_stack ("stack") and, for CRTEngine, one replay of a CUDA graph
  of the stack ("graph", with the host work of a call: make_aux and the
  uploads into the graph's input buffers); median, min, max and spread
  per mode;
- the graph's frames and state against the eager stack's on the same
  inputs (bit for bit or not);
- torch.profiler over one super-batch of each mode: the device's busy ms
  and its idle share of the mode's unprofiled wall per super-batch (the
  median turn; port_profile.device_busy and idle_share), and the
  profiled window's wall;
- the grain field and the glitch offsets of one step's frames (8; c5:
  32) from the engine's own uploaded inputs, CUDA events around the call
  (its host work included): ms per step;
- a sha256 of one super-batch with rng="host" (the oracle's streams), so
  that two trees' host-rng outputs can be held bit for bit.

Then each native draw entry at the main paths'
shapes (kernels/rng.py: the grain field at 1080x1920, c3's 540x960 and
c5's 2160x3840; the export offsets of c4's and c5's bands; the preview
offsets of c4's band) over DRAW_FRAMES frames, one launch per batch of 8
(c5: 32): a sha256 of the values, so that two trees' native draws can be
held bit for bit, and ms per launch from CUDA events around the wrapper
call beside the kernel's device time from torch.profiler (``--configs ""``
runs these alone).

The graph: the n steps captured once for a fixed (n, B, H, W, layout)
with the state not first, into static frame, input, state and output
buffers. The native draws are keyed by the frame indices in the input
buffers (kernels/rng.py), so a replay draws the new frames' values with
no host state. c5 and the sharded engine are not captured (they upload
their inputs inside the stack).

Prints one line per configuration, the card's name and power limit,
and one JSON object; writes the objects to ``--out`` under chiprun_out/
when given. Imports nothing of JAX or of the JAX package; exits 2
without a CUDA device.
"""

from __future__ import annotations

import argparse
import hashlib
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
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):  # warm-up off the capture, as torch asks
            self._body()
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
            self._body()

    def _body(self):
        st = self.eng._chunks(self.xs, self.aux, self.state, self.out)
        self.state.copy_(st)

    def replay(self, idx: np.ndarray):
        """One super-batch at frame indices idx: the host work of a call,
        then the replay. Returns (out, state) (the static buffers)."""
        flat = idx.reshape(-1)
        new = self.eng.upload(self.eng.make_aux(flat))
        for dst, src in zip(self.aux, new):
            if dst is not None:
                dst.copy_(src, non_blocking=True)
        self.graph.replay()
        return self.out, self.state


DRAW_FRAMES = 64


def draw_entries() -> list:
    """Per native draw entry: sha256 of DRAW_FRAMES frames (1000 on), event
    ms per call (the wrapper's host path included) and the kernel's device
    ms per call (torch.profiler)."""
    import torch

    from pythoncrt_tpu_torch import CRTEngine, EffectParams
    from pythoncrt_tpu_torch.kernels import rng as krng

    dev = torch.device("cuda")
    c4 = {m: CRTEngine(EffectParams(**pp.CONFIGS["c4"]), H, W, 24.0, engine=m, device=dev)
          for m in ("export", "preview")}
    c5 = CRTEngine(EffectParams(**pp.CONFIGS["c4"]), pp.H4, pp.W4, 24.0, device=dev)
    amp, nseg = c4["export"]._glitch_amp, c4["export"]._glitch_nseg
    entries = (  # name, kernel, frames per launch, draw
        ("grain 1080x1920", "grain_kernel", B, lambda f: krng.grain_normals(0, f, H, W)),
        ("grain 540x960 (c3)", "grain_kernel", B,
         lambda f: krng.grain_normals(0, f, H // 2, W // 2)),
        ("grain 2160x3840 (c5)", "grain_kernel", pp.CLIPS * B,
         lambda f: krng.grain_normals(0, f, pp.H4, pp.W4)),
        (f"export {amp.numel()}x{nseg} (c4)", "export_kernel", B,
         lambda f: krng.glitch_export_offsets(0, f, nseg, amp)),
        (f"export {c5._glitch_amp.numel()}x{c5._glitch_nseg} (c5)", "export_kernel",
         pp.CLIPS * B, lambda f: krng.glitch_export_offsets(0, f, c5._glitch_nseg, c5._glitch_amp)),
        (f"preview {c4['preview']._glitch_rows} (c4)", "preview_kernel", B,
         lambda f: krng.glitch_preview_offsets(0, f, c4["preview"]._glitch_amp)))
    out = []
    for name, kernel, nb, draw in entries:
        h = hashlib.sha256()
        for k in range(1000, 1000 + DRAW_FRAMES, nb):
            h.update(draw(torch.arange(k, k + nb, device=dev)).cpu().numpy().tobytes())
        fr = torch.arange(1000, 1000 + nb, device=dev)
        ms = pp.events_ms(lambda: draw(fr))
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        draw(fr)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(20):
                draw(fr)
            torch.cuda.synchronize()
        us = sum((getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0.0))
                 for ev in prof.key_averages()
                 if kernel in ev.key and ev.device_type == torch.autograd.DeviceType.CUDA)
        out.append(dict(entry=name, frames=DRAW_FRAMES, frames_per_launch=nb,
                        sha256=h.hexdigest()[:16], ms_per_call=ms, device_ms_per_call=us / 1e3 / 20))
    return out


def run_config(name: str, args) -> dict:
    import torch

    from pythoncrt_tpu_torch import CRTEngine, EffectParams, MultiClipEngine, TextParams
    from pythoncrt_tpu_torch import pipeline as tpipe
    from pythoncrt_tpu_torch.multiclip import auto_steps_per_call
    from pythoncrt_tpu_torch.parallel import DeviceMesh, ShardedCRTEngine

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    cfg = "c4" if name == "sharded-c4-x4" else name
    p = EffectParams(**pp.CONFIGS[cfg], text=TextParams(**pp.TEXT.get(cfg, {})))
    res = {"config": name}
    box = {"i": 0, "st": None}
    if name == "c5":
        n = auto_steps_per_call(pp.H4, pp.W4, pp.CLIPS, B)
        engines = {r: CRTEngine(p, pp.H4, pp.W4, 24.0, rng=r, layout="planar",
                                channel_order="gbr", device=dev) for r in ("native", "host")}
        runners = {r: MultiClipEngine(e) for r, e in engines.items()}
        xs = torch.randint(0, 256, (n, pp.CLIPS, B, 3, pp.H4, pp.W4), generator=gen,
                           device=dev, dtype=torch.uint8)
        per, step_frames = n * pp.CLIPS * B, pp.CLIPS * B

        def indices(i):
            return (i * n * B + np.arange(n * B).reshape(n, 1, B)
                    + np.zeros((1, pp.CLIPS, 1), np.int64))
        res["graph"] = "not captured: MultiClipEngine uploads its inputs inside the stack"
        res["shape"] = f"{pp.CLIPS} clips x B {B}, {pp.W4}x{pp.H4}"
    else:
        sharded = name == "sharded-c4-x4"
        n = 2 if sharded else tpipe.resolve_steps_per_call(H, W, False, 0)
        text = pp.synth_overlay() if cfg in pp.TEXT else None
        engines = {r: CRTEngine(p, H, W, 24.0, rng=r, layout="planar", channel_order="gbr",
                                device=dev, text_rgba=text) for r in ("native", "host")}
        runners = dict(engines)
        if sharded:
            mesh = DeviceMesh([torch.device("cuda", 0)] * 4)
            runners = {r: ShardedCRTEngine(e, mesh) for r, e in engines.items()}
            res["graph"] = "not captured: ShardedCRTEngine uploads its inputs inside the stack"
        xs = torch.randint(0, 256, (n, B, 3, H, W), generator=gen, device=dev,
                           dtype=torch.uint8)
        per, step_frames = n * B, B

        def indices(i):
            return np.arange(i * per, (i + 1) * per).reshape(n, B)
        res["shape"] = f"{W}x{H}, B {B}" + (", 4 logical shards of cuda:0" if sharded else "")
    eng, run = engines["native"], runners["native"]

    def idx():
        box["i"] += 1
        return indices(box["i"])

    def loop():
        ii = idx()
        for k in range(n):
            _, box["st"] = run.process(xs[k], ii[k], box["st"])

    def stack():
        _, box["st"] = run.process_stack(xs, idx(), box["st"])
    modes = {"loop": loop, "stack": stack}
    if "graph" in args.modes and "graph" not in res:
        loop()
        stack()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sg = StackGraph(eng, xs, idx(), box["st"])
        res["graph_capture_s"] = time.perf_counter() - t0
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
    modes = {k: v for k, v in modes.items() if k in args.modes}
    res["steps_per_call"] = n
    for fn in modes.values():
        fn()
    torch.cuda.synchronize()
    fps = turns(modes, per, args.turns, args.repeats)
    res["fps"] = {k: summary(v) for k, v in fps.items()}
    res["profile"] = {}
    for k, fn in modes.items():
        d = pp.device_busy(fn)
        wall = per / res["fps"][k]["median"] * 1e3
        res["profile"][k] = {"device_ms": d["busy_ms"], "wall_ms": wall,
                             "idle_pct": pp.idle_share(d["busy_ms"], wall) * 100.0,
                             "profiled_wall_ms": d["wall_ms"],
                             "profiled_idle_pct": pp.idle_share(d["busy_ms"], d["wall_ms"]) * 100}
    aux = eng.upload(eng.make_aux(np.arange(step_frames) + 1000))
    if p.noise_on:
        res["grain_ms_per_step"] = pp.events_ms(lambda: eng._grain_field(aux))
    if p.glitch_on:
        res["glitch_offsets_ms_per_step"] = pp.events_ms(lambda: eng.glitch_offsets(aux))
    out, _ = runners["host"].process_stack(xs, indices(0))
    res["host_rng_sha256"] = hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest()[:16]
    return res


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--configs", default="defaults,c3,c4,c4-text,c5,sharded-c4-x4")
    ap.add_argument("--modes", default="loop,stack,graph")
    ap.add_argument("--turns", type=int, default=5)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--tree", default=ROOT)
    ap.add_argument("--tag", default="this")
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    args.modes = args.modes.split(",")
    sys.path.insert(0, os.path.abspath(args.tree))
    if not torch.cuda.is_available():
        print("port_spc: no CUDA device available", file=sys.stderr)
        return 2
    from pythoncrt_tpu_torch.kernels import _build

    _build.library()
    c = card()
    results = []
    for name in filter(None, args.configs.split(",")):
        r = run_config(name, args)
        r["card"], r["tree"], r["tag"] = c, os.path.abspath(args.tree), args.tag
        results.append(r)
        fps = "; ".join(f"{k} {v['median']:.2f} fps ({v['min']:.2f}-{v['max']:.2f}, spread "
                        f"{v['spread_pct']:.1f}%)" for k, v in r["fps"].items())
        idle = ", ".join(f"{k} {v['idle_pct']:.1f}% (busy {v['device_ms']:.3f} of {v['wall_ms']:.3f}"
                         f" ms; profiled window {v['profiled_wall_ms']:.3f} ms, "
                         f"{v['profiled_idle_pct']:.1f}%)" for k, v in r["profile"].items())
        extra = (f"; graph bit for bit the stack: {r['graph_bit_for_bit']}, capture "
                 f"{r['graph_capture_s']:.2f}s" if r.get("graph") == "captured"
                 else f"; graph {r['graph']}" if "graph" in r else "")
        draws = "".join(f"; {k} {r[k]:.4f}" for k in ("grain_ms_per_step",
                                                     "glitch_offsets_ms_per_step") if k in r)
        print(f"[spc {args.tag}] {name} ({r['shape']}, {r['steps_per_call']} steps per call): "
              f"{fps}; device idle per super-batch: {idle}{extra}{draws}; host-rng sha256 "
              f"{r['host_rng_sha256']} on {c}", flush=True)
        torch.cuda.empty_cache()
    for d in draw_entries():
        print(f"[spc {args.tag}] draw {d['entry']}: sha256 {d['sha256']} over {d['frames']} "
              f"frames, {d['frames_per_launch']} per launch; {d['ms_per_call']:.4f} ms per "
              f"call (CUDA events), kernel {d['device_ms_per_call']:.4f} ms (torch.profiler) "
              f"on {c}", flush=True)
        results.append(dict(d, card=c, tree=os.path.abspath(args.tree), tag=args.tag))
    if args.out:
        os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
        with open(os.path.join(ROOT, "chiprun_out", args.out), "w") as f:
            json.dump(results, f, indent=1)
    print(c)
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
