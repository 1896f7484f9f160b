"""Where the fused kernel's time goes: the BIG instance past radius 31 and
c3's raw-grain instance timed whole and with one part of them skipped, on
one GPU.

    python3 scripts/port_fused_phases.py [--tree DIR] [--variants A,B] [--cases A,B]
                                         [--out FILE]

Each variant is a copy of the ``pythoncrt_tpu_torch`` of ``--tree`` (an
earlier commit unpacked with ``git archive`` into a git-ignored directory;
default: this checkout) under ``pythoncrt_tpu_torch/_build/phases/<variant>/``
(git-ignored) with ``csrc/fused.cu`` edited as the table below says, built
by that copy and timed in a process of its own. The edits make the output
wrong; only the time is read:

- ``full``: the kernel as it is;
- ``no_blocked_taps``: the interior strips' register-window taps and the
  vertical pass's blocked walk skipped (their sums left 0);
- ``no_edge_strips``: the edge strips' horizontal loop skipped;
- ``no_border_rows``: the per-row vertical loop (the frame's top and
  bottom rows, a pass's last rows) skipped;
- ``no_prologue``: the prologue skipped (the knee'd rows and the pre-knee
  strip left as they are);
- ``no_epilogue``: the epilogue's triad, scanlines, vignette, flicker,
  grain and store skipped;
- ``rows2``: the vertical pass summing 2 rows per thread in place of 4
  (``BR``; correct output);
- ``no_grain``: the grain read skipped, each grain value 0: the full-size
  field's loads, and the raw grain's (the raw rows' staging and the
  upsample from the stage in a tree with the raw stage; the per-pixel
  loads of the raw field and its taps in an earlier one).

Cases (1920x1080, B = 8, CUDA events, median of 5 repeats of 20 calls,
ms/frame, each at its own plan): the CLI defaults with ``--no-fast-bloom
--bloom-sigma 11`` and ``20`` (uint8 input, pixel 2), c4-text with
``--no-fast-bloom --bloom-sigma 11`` (the f32 input), c3 (gaussian
radius 4, grain size 2: the raw grain), c3 at grain size 1 (the
full-size field) and the CLI defaults at ``--grain-size 2`` (the fast
core's raw grain). ``no_grain`` less ``full`` is what the grain costs the
kernel in that tree. Prints one JSON object and
writes it to --out; exits 2 without a CUDA device. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORK = os.path.join(ROOT, "pythoncrt_tpu_torch", "_build", "phases")
H, W, B = 1080, 1920, 8
C4 = dict(scanline_strength=0.6, triad_strength=0.35, aberration_px=1, bloom_strength=0.25,
          fast_bloom=True, noise_strength=1.5, vignette_strength=0.25, persistence=0.6,
          pixel_size=1, glitch_amp_px=6, glitch_height_frac=0.3, scanline_speed_px_s=120.0)
C3 = dict(scanline_strength=0.6, triad_strength=0.35, triad_softness=0.5, aberration_px=1,
          bloom_sigma=1.2, bloom_strength=0.25, fast_bloom=False, noise_strength=1.5,
          vignette_strength=0.25, persistence=0.0, pixel_size=2, grain_size=2,
          warp_strength=0.15, flicker_strength=0.2, flicker_hz=2.0, brightness=0.02,
          contrast=1.05, gamma=1.1, saturation=0.9, temperature=0.1)
CASES = {"defaults-s11": (dict(fast_bloom=False, bloom_sigma=11.0), False),
         "defaults-s20": (dict(fast_bloom=False, bloom_sigma=20.0), False),
         "c4-text-s11": (dict(C4, fast_bloom=False, bloom_sigma=11.0), True),
         "c3": (C3, False), "c3-g1": (dict(C3, grain_size=1), False),
         "defaults-g2": (dict(grain_size=2), False)}
ZERO_ACC = "for (int i = 0; i < BR; ++i) for (int v = 0; v < 4; ++v) acc[i][v] = 0.0f;"
# variant -> [(file under the package, text, replacement)], each text found once;
# an edit marked optional (a fourth element, True) applies where its text is
# (the trees differ there), and at least one edit of a variant must apply
VARIANTS = {
    "full": [],
    "no_blocked_taps": [
        ("csrc/fused.cu", "vtaps_block(a, S, col, y, r, acc);", ZERO_ACC),
        ("csrc/fused.cu", "for (; t + 4 <= kt; t += 4) {", "for (; t + 4 <= 0; t += 4) {"),
        ("csrc/fused.cu", "if (t < kt) {  // the last", "if (false) {  // the last")],
    "no_edge_strips": [
        ("csrc/fused.cu", "                    if (interior) {",
         "                    if (RT == BIG && !interior) {\n"
         "                        acc[0] = acc[1] = acc[2] = acc[3] = 0.0f;\n"
         "                    } else if (interior) {")],
    "no_border_rows": [
        ("csrc/fused.cu", "for (int i = 0; i < n; ++i) {  // one row at a time",
         "for (int i = 0; i < 0; ++i) {  // one row at a time")],
    "no_prologue": [
        ("csrc/fused.cu", "for (int it = tid; it < dn * nl; it += NT) {",
         "for (int it = tid; it < (RT == BIG ? 0 : dn * nl); it += NT) {")],
    "no_epilogue": [
        ("csrc/fused.cu", "epilogue4<DIRECT>(a, S, bi, y, gx, 4 * q, min(4, xe - gx), m, gr);",
         "if (m[0][0] == -1.0f)\n"
         "    epilogue4<DIRECT>(a, S, bi, y, gx, 4 * q, min(4, xe - gx), m, gr);")],
    "rows2": [
        ("csrc/fused.cu", "constexpr int BR = 4;", "constexpr int BR = 2;"),
        ("kernels/fused.py", "BIG_ROWS = 4", "BIG_ROWS = 2")],
    "no_grain": [
        # load_grain: the full-size field (and, before the raw stage, the raw
        # field through its taps) never read
        ("csrc/fused.cu", "    if (!a.noise_on) return;\n", "    return;\n", True),
        # the raw stage: no rows copied, the upsample from the stage skipped
        ("csrc/fused.cu", "for (int k = warp; k < gn; k += NWARP) {",
         "for (int k = warp; k < 0; k += NWARP) {", True),
        ("csrc/fused.cu", "for (int i = threadIdx.x; i < yb - ya; i += NT) {",
         "for (int i = threadIdx.x; i < 0; i += NT) {", True),
        ("csrc/fused.cu", "    const float* gt = gb + a.gdepth * a.gpitch;\n",
         "    for (int v = 0; v < 4; ++v) gr[v] = 0.0f;\n    return;\n"
         "    const float* gt = gb + a.gdepth * a.gpitch;\n", True)],
}


def make_tree(name: str, edits: list, src_tree: str = ROOT) -> str:
    """A copy of ``src_tree``'s package with the variant's edits (the first
    match of each, which is the BIG instance's code: it precedes the other
    cores')."""
    tree = os.path.join(WORK, name)
    shutil.rmtree(tree, ignore_errors=True)
    shutil.copytree(os.path.join(src_tree, "pythoncrt_tpu_torch"),
                    os.path.join(tree, "pythoncrt_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    applied = 0
    for rel, old, new, *optional in edits:
        path = os.path.join(tree, "pythoncrt_tpu_torch", rel)
        with open(path) as f:
            src = f.read()
        if old not in src:
            if optional:
                continue
            raise SystemExit(f"port_fused_phases: {name}: {old!r} not in {rel}")
        with open(path, "w") as f:
            f.write(src.replace(old, new, 1))
        applied += 1
    if edits and not applied:
        raise SystemExit(f"port_fused_phases: {name}: no edit applies to {src_tree}")
    return tree


def time_tree(tree: str, cases: list) -> dict:
    """Run in the process that imports ``tree``'s package: ms/frame per case."""
    sys.path[:0] = [tree, ROOT]
    import numpy as np
    import torch

    from chip_smoke import synth_overlay, time_ms
    from pythoncrt_tpu_torch import CRTEngine, EffectParams, TextParams
    from pythoncrt_tpu_torch.kernels import fused as kfused

    x = torch.from_numpy(np.random.default_rng(3).integers(0, 256, (B, 3, H, W),
                                                           dtype=np.uint8)).cuda()
    ov = synth_overlay(H, W, 4)
    out = {}
    for name in cases:
        params, text = CASES[name]
        p = EffectParams(**params, **(dict(text=TextParams(text="PLAY", size=48, after=False))
                                      if text else {}))
        eng = CRTEngine(p, H, W, 24.0, rng="host", layout="planar", channel_order="gbr",
                        device="cuda", text_rgba=ov if text else None)
        feed = x if eng.spec.pre else eng._pre_bloom(x).contiguous()
        kw = eng.fused_operands(eng.make_aux(np.arange(B)))

        ms = time_ms(lambda: kfused.fused_pipeline(feed, eng.spec, eng.fused_tables, **kw), 20, 5)
        plan = eng.fused_tables.plan
        out[name] = dict(ms_per_frame=ms / B, sw=plan.sw, step=plan.step,
                         run=plan.run, smem=plan.smem)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="port_fused_phases.json")
    ap.add_argument("--tree", default=ROOT, help="the checkout whose package is timed")
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--cases", default=",".join(CASES))
    ap.add_argument("--time-tree", help=argparse.SUPPRESS)  # the child process's mode
    a = ap.parse_args()
    cases = a.cases.split(",")
    if a.time_tree:
        print(json.dumps(time_tree(a.time_tree, cases)))
        return 0
    import torch

    if not torch.cuda.is_available():
        print("port_fused_phases: no CUDA device available", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    results = {}
    for name in a.variants.split(","):
        tree = make_tree(name, VARIANTS[name], os.path.abspath(a.tree))
        res = subprocess.run([sys.executable, os.path.abspath(__file__), "--time-tree", tree,
                              "--cases", a.cases], capture_output=True, text=True, timeout=1200)
        if res.returncode != 0:
            raise SystemExit(f"port_fused_phases: {name} failed:\n{res.stdout}\n{res.stderr}")
        results[name] = json.loads(res.stdout.strip().splitlines()[-1])
        print(f"{name}: {results[name]}", flush=True)
        shutil.rmtree(tree, ignore_errors=True)
    out = dict(card=card, torch=torch.__version__, tree=os.path.abspath(a.tree), results=results)
    if {"full", "no_grain"} <= set(results):
        out["grain_ms_per_frame"] = {c: results["full"][c]["ms_per_frame"]
                                     - results["no_grain"][c]["ms_per_frame"] for c in cases}
    os.makedirs(os.path.dirname(a.out) or ".", exist_ok=True)
    with open(a.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
