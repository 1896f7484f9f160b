"""The stand-alone blooms', the warp's, the fused and the glitch kernels
timed on one GPU, for an A/B of two trees.

    python3 scripts/port_bloom_ab.py [--tree DIR] [--tag NAME] [--out FILE]
                                     [--sweep [walk|fast|fused|graw|glitch]]
                                     [--only fused|glitch]

``--tree`` is the checkout whose ``pythoncrt_tpu_torch`` is imported and
built (default: this script's own; an earlier commit unpacked with
``git archive`` into a git-ignored directory runs its own kernels). At
1920x1080 with a batch of 8, on the pre-bloom images of the smoke's paths
(``engine._pre_bloom`` of seeded uint8 frames, planar gbrp):

- bloom3_planar (c3-angled, sigma 1.2), bloom3_fast_planar
  (defaults-angled), bloom2_planar gaussian (c3-bloom2) and fast
  (defaults-bloom2), bloom2's pipelined entry at limbs 3, 2 and 1
  (c3-bloom2), the stripe bloom (c3-stripe);
- the gaussian ones again at radius 31 (sigma 31/3), sigma 11 and sigma
  20 (a tree that refuses a radius records the refusal);
- warp_planar on c3's fused output (uint8 emit) and on c3-angled's
  staged output with text after the warp (f32 emit), each with the
  engine's own tables, the uint8 emit again at strength 1.0, and
  grid_sample on c3's operands (the library call);
- the fused kernel on the engine's own operands (host rng) for the CLI
  defaults (fast core), c3 (gaussian core, radius 4), c4-text (text
  before the bloom: the f32-input mode) and, past radius 31 (taps from
  shared memory), the CLI defaults with ``--no-fast-bloom --bloom-sigma
  11`` and ``20`` (radius 33 and 60) and c4-text with ``--no-fast-bloom
  --bloom-sigma 11``; the raw grain (grain size above 1) on c3 at pixel
  size 2 and 3 and on the CLI defaults with ``--grain-size 2`` (the fast
  core), beside c3 at grain size 1 (a full-size field); each with ``precision="exact"`` (the 1024-bin triad tables)
  and ``"fast"`` (the direct-pow triad; a tree without it records the
  refusal); and a digest of each fused instantiation's SASS (its
  instructions, without the kernel's name and the encodings), so that
  two trees' instantiations can be held equal, with ptxas's registers,
  stack frame and spill for each;
- the glitch shear (stage 14) with the c4 params and host-rng offsets:
  in place at the GUI preview's shape (B = 1, 960x540, the preview
  engine's one offset per row), at 1080p B = 8 (the export offsets, 120
  segments) in place and out of place on the band, and at c5's 4K on 32
  frames in place; each with its kernel's device time and torch.gather's
  (the same band and index) in one torch.profiler window beside both
  event times and both host times per call (host_us: calls issued back
  to back without waiting for the card).

Per case: CUDA-event time (median of 5 repeats of 20 calls) per call and
per frame, the bytes bound (inputs and outputs once, tables once, at
3.35 TB/s) and a sha256 of the output, so that two trees' outputs can be
held bit for bit. ``--sweep`` (``walk``) also times this tree's row walk
(kernels/bloom_walk.py) at other strip widths, chunk and run lengths on
the bloom3 and bloom2-fast cases; ``--sweep fast`` times its fast source
at other chunk and run lengths (FAST_STEP, FAST_RUN); ``--sweep fused``
times the fused kernel past radius 31 (sigma 11 and 20 on the CLI
defaults, sigma 11 on c4-text and on c4: uint8 input at pixel 1) with the
tree's own plans, then at each strip width, chunk and run length of
SWEEP_FUSED (STRIP_WIDTHS, WALK's "big" entries), with each plan's shared
memory and the blocks per SM it leaves room for; ``--sweep graw`` times
the raw-grain cases (c3, the CLI defaults with ``--grain-size 2``) at the
strips and chunks of SWEEP_GRAW; ``--sweep glitch`` times the glitch
cases under each plan of SWEEP_GLITCH (kernels/glitch.py's MAX_TX).
``--only fused`` (``glitch``) times those cases alone. Prints one JSON
object and writes it to --out. Imports nothing of JAX; exits 2 without a
CUDA device.
"""

from __future__ import annotations

import argparse
import collections
import hashlib
import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import device_ms, optin_env, synth_overlay, time_ms  # noqa: E402
from portbench.yardstick import HBM_BYTES_PER_S  # noqa: E402

H, W, B = 1080, 1920, 8
C3 = dict(scanline_strength=0.6, triad_strength=0.35, triad_softness=0.5, aberration_px=1,
          bloom_sigma=1.2, bloom_strength=0.25, fast_bloom=False, noise_strength=1.5,
          vignette_strength=0.25, persistence=0.0, pixel_size=2, grain_size=2,
          warp_strength=0.15, flicker_strength=0.2, flicker_hz=2.0, brightness=0.02,
          contrast=1.05, gamma=1.1, saturation=0.9, temperature=0.1)
PATHS = {  # path -> params; the bloom opt-ins' variables: chip_smoke.OPTINS
    "c3-angled": dict(C3, scanline_angle=5.0, scanline_thickness=1.5),
    "defaults-angled": dict(scanline_angle=12.0, scanline_thickness=2.0),
    "c3-bloom2": C3,
    "defaults-bloom2": {},
    "c3-stripe": C3,
}
SIGMAS = {"r31": 31 / 3, "s11": 11.0, "s20": 20.0}
C4 = dict(scanline_strength=0.6, triad_strength=0.35, aberration_px=1, bloom_strength=0.25,
          fast_bloom=True, noise_strength=1.5, vignette_strength=0.25, persistence=0.6,
          pixel_size=1, glitch_amp_px=6, glitch_height_frac=0.3, scanline_speed_px_s=120.0)
FUSED = {"defaults": ({}, False), "c3": (C3, False), "c4-text": (C4, True),  # params, text
         # the raw-grain mode's other cases: c3 at grain size 1 (a full-size
         # field, the kernel the raw grain should not be slower than), c3 at
         # pixel size 3, the CLI defaults with --grain-size 2 (the fast core)
         "c3-g1": (dict(C3, grain_size=1), False), "c3-px3": (dict(C3, pixel_size=3), False),
         "defaults-g2": (dict(grain_size=2), False),
         "defaults-s11": (dict(fast_bloom=False, bloom_sigma=11.0), False),
         "defaults-s20": (dict(fast_bloom=False, bloom_sigma=20.0), False),
         "c4-text-s11": (dict(C4, fast_bloom=False, bloom_sigma=11.0), True)}
# --sweep fused: the fused kernel past radius 31 (params, text), and its grid
BIG_CASES = {"defaults-s11": FUSED["defaults-s11"], "defaults-s20": FUSED["defaults-s20"],
             "c4-text-s11": FUSED["c4-text-s11"],
             "c4-s11": (dict(C4, fast_bloom=False, bloom_sigma=11.0), False)}  # pixel 1, uint8
SWEEP_FUSED = dict(sw=(128, 64, 32, 16), step=(8, 12, 16, 24), run=(64, 128, 256, 540))
# --sweep graw: the raw-grain cases at other strips and chunks (WALK's
# uint8-input entry of their core), with the blocks per SM each leaves
GRAW_CASES = {"c3": ("gaussian", FUSED["c3"]), "defaults-g2": ("fast", FUSED["defaults-g2"])}
SWEEP_GRAW = dict(sw=(128, 64), step={"gaussian": (8, 6), "fast": (12, 10, 8, 6)})
# --sweep glitch: the glitch plan's threads along a row, at most
SWEEP_GLITCH = dict(MAX_TX=(64, 128, 256, 512))
SMEM_PER_SM = 233472  # an H100 SM's shared memory for blocks (228 KB), 1 KB reserved per block


def host_us(fn, calls: int = 200, repeats: int = 5) -> float:
    """Host microseconds per call of fn, the calls issued back to back
    without waiting for the card, median of the repeats."""
    import torch

    fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        runs.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return statistics.median(runs)


# a fused_strip_kernel instantiation's mangled name: core, radius, f32 input,
# then the direct-pow triad, the raw grain and the text where the tree has them
FUSED_NAME = (r"fused_strip_kernelILi(\d)ELi(n?\d+)ELb(\d)E(?:Lb(\d)E)?(?:Lb(\d)E)?"
              r"(?:Lb(\d)E)?")


def fused_key(m) -> str:
    """"core/radius/f32-input/direct", then "/raw" and "/text" where set."""
    return ("/".join((*m.groups()[:3], m.group(4) or "0")) + ("/raw" if m.group(5) == "1" else "")
            + ("/text" if m.group(6) == "1" else ""))


def fused_sass(lib_path: str, nvcc: str) -> dict:
    """sha256 of each fused_strip_kernel instantiation's SASS in the
    built library, keyed "core/radius/f32-input/direct" from its mangled
    name (a tree without the direct-pow triad has no fourth argument), and
    "/raw" after it for the raw-grain instantiations (a fifth argument of
    1; a tree without them has none), then "/text" for the instantiations
    that composite the text (a sixth argument of 1), with its instruction
    count and its count of each opcode."""
    sass = subprocess.run([os.path.join(os.path.dirname(nvcc), "cuobjdump"), "-sass", lib_path],
                          check=True, capture_output=True, text=True, timeout=300).stdout
    out = {}
    for fn in sass.split("Function : ")[1:]:
        name, _, body = fn.partition("\n")
        m = re.search(FUSED_NAME, name)
        if m:
            code = [ln.split("*/", 1)[1].split(";")[0].strip() for ln in body.splitlines()
                    if re.match(r"\s*/\*[0-9a-f]{4,}\*/", ln)]
            key = fused_key(m)
            opcodes = collections.Counter(re.sub(r"^@!?U?P\w+\s+", "", c).split(" ")[0]
                                          .split(".")[0] for c in code)
            out[key] = dict(instructions=len(code), sha256=hashlib.sha256(
                "\n".join(code).encode()).hexdigest()[:16], opcodes=dict(opcodes.most_common()))
    return out


def fused_ptxas(log: str) -> dict:
    """ptxas's registers, stack frame and spill bytes of each
    fused_strip_kernel instantiation, keyed as fused_sass keys them."""
    out, key = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            m = re.search(FUSED_NAME, line)
            key = fused_key(m) if m else None
            if key:
                out[key] = {}
        elif key:
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                          r"(\d+) bytes spill loads", line)
            if m and "stack" not in out[key]:
                out[key].update(zip(("stack", "spill_stores", "spill_loads"),
                                    map(int, m.groups())))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                out[key]["registers"] = int(m.group(1))
                key = None
    return out


def digest(t) -> str:
    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()[:16]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--tag", default="this")
    ap.add_argument("--out", default="port_bloom_ab.json")
    ap.add_argument("--sweep", nargs="?", const="walk",
                    choices=("walk", "fast", "fused", "graw", "glitch"))
    ap.add_argument("--only", choices=("fused", "glitch"))
    a = ap.parse_args()
    sys.path.insert(0, os.path.abspath(a.tree))
    import torch

    if not torch.cuda.is_available():
        print("port_bloom_ab: no CUDA device available", file=sys.stderr)
        return 2
    from pythoncrt_tpu_torch import CRTEngine, EffectParams, TextParams
    from pythoncrt_tpu_torch.kernels import _build
    from pythoncrt_tpu_torch.kernels import bloom as kbloom
    from pythoncrt_tpu_torch.kernels import bloom2 as kbloom2
    from pythoncrt_tpu_torch.kernels import bloom3 as kbloom3
    from pythoncrt_tpu_torch.kernels import fused as kfused
    from pythoncrt_tpu_torch.kernels import glitch as kglitch
    from pythoncrt_tpu_torch.kernels import warp as kwarp

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    t0 = time.perf_counter()
    lib = _build.library()
    built = time.perf_counter() - t0
    sass = fused_sass(lib._name, _build.find_nvcc())
    for k, v in fused_ptxas(_build.build_log).items():
        sass.setdefault(k, {}).update(v)
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.integers(0, 256, (B, 3, H, W), dtype=np.uint8)).cuda()
    feeds = {}
    for path, params in PATHS.items():
        with optin_env(path):
            eng = CRTEngine(EffectParams(**params), H, W, 24.0, layout="planar",
                            channel_order="gbr", device="cuda")
        feeds[path] = (eng, eng._pre_bloom(x).contiguous())
    bound_ms = lambda nbytes: nbytes / HBM_BYTES_PER_S * 1e3  # noqa: E731

    def case(fn, feed, extra_bytes=0, out_bytes=None):
        out = fn()
        torch.cuda.synchronize()
        ms = time_ms(fn, 20, 5)
        bms = bound_ms(feed.numel() * 4 + (feed.numel() * 4 if out_bytes is None else out_bytes)
                       + extra_bytes)
        return dict(ms=ms, ms_per_frame=ms / B, bound_ms_per_frame=bms / B,
                    share_of_bound=bms / ms, sha256=digest(out))

    results = {}

    def run(name, make):
        try:
            results[name] = make()
        except (NotImplementedError, ValueError) as e:
            results[name] = dict(refused=f"{type(e).__name__}: {e}")
        print(f"{a.tag} {name}: {results[name]}", flush=True)

    def bloom3_case(sigma):
        eng, feed = feeds["c3-angled"]
        spec = eng.bloom3_spec if sigma is None else kbloom3.build_bloom3_spec(
            H, W, sigma, eng.bloom3_spec.strength, eng.bloom3_spec.threshold)
        return case(lambda: kbloom3.bloom3_planar(feed, spec), feed)

    def bloom2_case(path, sigma=None, limbs=None):
        eng, feed = feeds[path]
        spec = eng.bloom_spec
        if sigma is not None:
            spec = kbloom2.build_bloom2_spec(H, W, variant="gaussian", sigma=sigma,
                                             strength=spec.strength, threshold=spec.threshold)
        tabs = kbloom2.bloom2_tables(spec, "cuda", limbs or 3)
        extra = sum(t.numel() * 4 for t in tabs)
        if limbs is None:
            return case(lambda: kbloom2.bloom2_planar(feed, spec, tabs), feed, extra)
        return case(lambda: kbloom2.bloom2_planar_pipelined(feed, spec, limbs, tabs), feed, extra)

    def bloom3_fast_case():
        eng, feed = feeds["defaults-angled"]
        tabs = getattr(eng, "bloom3_tables", None)  # the parent: the fused consts' taps
        if tabs is None:
            tabs = (eng.fused_tables.fast_taps, eng.fused_tables.fast_extent)
            extra = sum(t.numel() * 4 for t in tabs[0])
        else:
            extra = sum(t.numel() * 4 for t in tabs.taps)
        return case(lambda: kbloom3.bloom3_fast_planar(feed, eng.bloom3_spec, tabs), feed, extra)

    # the warp's operands: c3's fused output (uint8 emit), c3-angled's
    # staged output with text after the warp (f32 emit)
    warps = {}
    aux_idx = np.arange(B)
    eng = CRTEngine(EffectParams(**C3), H, W, 24.0, layout="planar", channel_order="gbr",
                    device="cuda")
    kw = eng.fused_operands(eng.make_aux(aux_idx))
    warps["u8"] = (eng, kfused.fused_pipeline(x, eng.spec, eng.fused_tables, **kw))
    ov = synth_overlay(H, W, 4)
    eng = CRTEngine(EffectParams(**PATHS["c3-angled"], text=TextParams(text="CH 3", size=48,
                                                                       after=True)),
                    H, W, 24.0, layout="planar", channel_order="gbr", device="cuda",
                    text_rgba=ov)
    warps["f32"] = (eng, eng._staged_stages(x, eng.make_aux(aux_idx)).contiguous())

    def warp_case(emit, strength=None):
        eng, f = warps[emit]
        tabs = (eng.warp_tables if strength is None
                else kwarp.build_warp_tables(H, W, strength, "cuda"))
        u8 = eng._warp_u8
        return case(lambda: kwarp.warp_planar(f, tabs, emit_u8=u8), f,
                    sum(t.numel() * 4 for t in tabs), out_bytes=f.numel() * (1 if u8 else 4))

    def grid_sample_case():
        from pythoncrt_tpu_torch import oracle

        _, f = warps["u8"]
        map_x, map_y = oracle.barrel_warp_maps(H, W, C3["warp_strength"])
        grid = torch.from_numpy(np.stack([map_x * (2.0 / (W - 1)) - 1.0,
                                          map_y * (2.0 / (H - 1)) - 1.0], -1)).float().cuda()
        grid = grid[None].expand(B, H, W, 2).contiguous()
        return case(lambda: torch.nn.functional.grid_sample(
            f, grid, mode="bilinear", padding_mode="zeros", align_corners=True), f,
            grid.numel() * 4)

    def stripe_case(sigma=None):
        eng, feed = feeds["c3-stripe"]
        spec = eng.bloom_spec if sigma is None else kbloom.build_bloom_spec(
            H, W, sigma, eng.bloom_spec.strength, eng.bloom_spec.threshold)
        return case(lambda: kbloom.bloom_planar(feed, spec), feed)

    def fused_case(params, text, precision):
        p = EffectParams(**params, **(dict(text=TextParams(text="PLAY", size=48, after=False))
                                      if text else {}))
        eng = CRTEngine(p, H, W, 24.0, rng="host", precision=precision, layout="planar",
                        channel_order="gbr", device="cuda", text_rgba=ov if text else None)
        feed = x if eng.spec.pre else eng._pre_bloom(x).contiguous()
        kw = eng.fused_operands(eng.make_aux(aux_idx))
        fn = lambda: kfused.fused_pipeline(feed, eng.spec, eng.fused_tables, **kw)  # noqa: E731
        out = fn()
        torch.cuda.synchronize()
        ms = time_ms(fn, 20, 5)
        plan = eng.fused_tables.plan
        return dict(ms=ms, ms_per_frame=ms / B, sha256=digest(out),
                    plan=dict(sw=plan.sw, step=plan.step, run=plan.run, depth=plan.depth,
                              smem=plan.smem,
                              blocks_per_sm_by_smem=SMEM_PER_SM // (plan.smem + 1024)))

    # the glitch shear's operands: (frames, y0, offsets, seg) per shape
    glitch_ops = {}

    def glitch_operands(shape):
        if shape not in glitch_ops:
            mode, nb, h, w, clips = {"preview": ("preview", 1, 540, 960, 1),
                                     "c4": ("export", B, H, W, 1),
                                     "c5": ("export", B, 2160, 3840, 4)}[shape]
            eng = CRTEngine(EffectParams(**C4), h, w, 24.0, rng="host", engine=mode,
                            device="cuda")
            off = eng.glitch_offsets(eng.make_aux(np.tile(np.arange(nb), clips)))
            frames = torch.from_numpy(np.random.default_rng(5).random(
                (nb * clips, 3, h, w), dtype=np.float32)).cuda()
            glitch_ops[shape] = (frames, eng._glitch_y0, off, eng.consts["glitch_seg_index"])
        return glitch_ops[shape]

    def glitch_case(shape, inplace=True):
        frames, y0, off, seg = glitch_operands(shape)
        band = frames[:, :, y0:].contiguous()
        w = frames.shape[3]
        gidx = torch.remainder(torch.arange(w, device="cuda") + off.long()[:, :, seg.long()],
                               w)[:, None].expand(band.shape).contiguous()
        if inplace:
            out = kglitch.shear_planar_inplace(frames.clone(), y0, off, seg)[:, :, y0:]
            work = frames.clone()
            fn = lambda: kglitch.shear_planar_inplace(work, y0, off, seg)  # noqa: E731
        else:
            out = kglitch.shear_planar(band, off, seg)
            fn = lambda: kglitch.shear_planar(band, off, seg)  # noqa: E731
        lib = lambda: torch.gather(band, 3, gidx)  # noqa: E731
        same = torch.equal(out, lib())
        nb = frames.shape[0]
        ms, lib_ms = time_ms(fn, 20, 5), time_ms(lib, 20, 5)
        dev, lib_dev = device_ms((fn, "glitch_kernel"), (lib, None))
        host, lib_host = host_us(fn), host_us(lib)
        bms = bound_ms(2 * band.numel() * 4 + off.numel() * 4 + seg.numel() * 4)
        return dict(ms=ms, ms_per_frame=ms / nb, device_ms=dev, device_ms_per_frame=dev / nb,
                    gather_ms=lib_ms, gather_device_ms=lib_dev, host_us=host,
                    gather_host_us=lib_host, bound_ms=bms,
                    share_of_bound=bms / ms, device_share_of_bound=bms / dev,
                    frames=nb, gather_equal=same, sha256=digest(out))

    GLITCH = {"glitch_preview": ("preview", True), "glitch_c4": ("c4", True),
              "glitch_band": ("c4", False), "glitch_c5": ("c5", True)}
    if a.only in (None, "glitch"):
        for name, (shape, inplace) in GLITCH.items():
            run(name, lambda: glitch_case(shape, inplace))
    if a.only != "glitch":
        for cfg, (params, text) in FUSED.items():
            for precision in ("exact", "fast"):
                run(f"fused_{cfg}_{precision}", lambda: fused_case(params, text, precision))
    if a.only is None:  # the stand-alone blooms and the warp
        run("bloom3_planar", lambda: bloom3_case(None))
        run("bloom3_fast_planar", bloom3_fast_case)
        run("warp_planar", lambda: warp_case("u8"))
        run("warp_planar_f32", lambda: warp_case("f32"))
        run("warp_planar_strength1", lambda: warp_case("u8", strength=1.0))
        run("grid_sample", grid_sample_case)
        run("bloom2_planar", lambda: bloom2_case("c3-bloom2"))
        run("bloom2_planar_fast", lambda: bloom2_case("defaults-bloom2"))
        for limbs in (3, 2, 1):
            run(f"bloom2_planar_pipelined_limbs{limbs}",
                lambda: bloom2_case("c3-bloom2", limbs=limbs))
        run("bloom_stripe", lambda: stripe_case())
        for tag, sigma in SIGMAS.items():
            run(f"bloom3_planar_{tag}", lambda: bloom3_case(sigma))
            run(f"bloom2_planar_{tag}", lambda: bloom2_case("c3-bloom2", sigma=sigma))
            run(f"bloom_stripe_{tag}", lambda: stripe_case(sigma))

    sweep = []
    if a.sweep == "glitch":  # the glitch kernel's threads along a row, at most
        keep = kglitch.MAX_TX
        for max_tx in SWEEP_GLITCH["MAX_TX"]:
            kglitch.MAX_TX = max_tx
            kglitch.glitch_plan.cache_clear()
            row = dict(MAX_TX=max_tx)
            for name, (shape, inplace) in GLITCH.items():
                r = glitch_case(shape, inplace)
                row[name] = (r["ms_per_frame"], r["device_ms_per_frame"])
                row[name + "_same"] = r["sha256"] == results[name]["sha256"]
                row[name + "_plan"] = kglitch.last_plan
            print(f"{a.tag} sweep {row}", flush=True)
            sweep.append(row)
        kglitch.MAX_TX = keep
        kglitch.glitch_plan.cache_clear()
    if a.sweep == "fused":  # the fused kernel's walk past radius 31: strip, chunk and run
        ref = {}
        for cfg, (params, text) in BIG_CASES.items():  # the tree's own plans first
            ref[cfg] = fused_case(params, text, "exact")
            print(f"{a.tag} sweep plan {cfg}: {ref[cfg]}", flush=True)
        keep = (kfused.STRIP_WIDTHS, dict(kfused.WALK))
        for sw in SWEEP_FUSED["sw"]:
            for step in SWEEP_FUSED["step"]:
                for run_rows in SWEEP_FUSED["run"]:
                    kfused.STRIP_WIDTHS = (sw,)
                    for pre in (True, False):
                        kfused.WALK["big", pre] = (step, run_rows)
                    row = dict(sw=sw, step=step, run=run_rows)
                    for cfg, (params, text) in BIG_CASES.items():
                        r = fused_case(params, text, "exact")
                        row[cfg] = r["ms_per_frame"]
                        row[cfg + "_same"] = r["sha256"] == ref[cfg]["sha256"]
                        row[cfg + "_plan"] = r["plan"]
                    print(f"{a.tag} sweep {row}", flush=True)
                    sweep.append(row)
        kfused.STRIP_WIDTHS, kfused.WALK = keep
    if a.sweep == "graw":  # the raw-grain mode at other strips and chunks, each as set
        keep = (kfused.STRIP_WIDTHS, dict(kfused.WALK), kfused.GRAW_STEPS)
        kfused.GRAW_STEPS = ()
        for cfg, (core, (params, text)) in GRAW_CASES.items():
            ref = results[f"fused_{cfg}_exact"]
            for sw in SWEEP_GRAW["sw"]:
                for step in SWEEP_GRAW["step"][core]:
                    kfused.STRIP_WIDTHS = (sw,)
                    kfused.WALK[core, True] = (step, keep[1][core, True][1])
                    r = fused_case(params, text, "exact")
                    row = dict(case=cfg, sw=sw, step=step, ms_per_frame=r["ms_per_frame"],
                               same=r["sha256"] == ref["sha256"], plan=r["plan"])
                    print(f"{a.tag} sweep {row}", flush=True)
                    sweep.append(row)
            kfused.STRIP_WIDTHS, kfused.WALK = keep[0], dict(keep[1])
        kfused.GRAW_STEPS = keep[2]
    if a.sweep == "fast":
        from pythoncrt_tpu_torch.kernels import bloom_walk as kwalk

        eng, feed = feeds["defaults-angled"]
        keep = (kwalk.STEPS, kwalk.FAST_STEP, kwalk.FAST_RUN)
        for step in (8, 16, 32):
            for run_rows in (32, 64, 128, 256):
                kwalk.STEPS = tuple(sorted({step, *keep[0]}, reverse=True))
                kwalk.FAST_STEP, kwalk.FAST_RUN = step, run_rows
                kwalk.fast_plan.cache_clear()
                tabs = kwalk.fast_tables(H, W, eng.bloom3_spec.threshold, "cuda")
                r = case(lambda: kbloom3.bloom3_fast_planar(feed, eng.bloom3_spec, tabs), feed)
                row = dict(step=step, run=run_rows, depth=tabs.plan.depth,
                           bloom3_fast_planar=r["ms_per_frame"],
                           bloom3_fast_planar_same=r["sha256"]
                           == results["bloom3_fast_planar"]["sha256"])
                print(f"{a.tag} sweep {row}", flush=True)
                sweep.append(row)
        kwalk.STEPS, kwalk.FAST_STEP, kwalk.FAST_RUN = keep
        kwalk.fast_plan.cache_clear()
    if a.sweep == "walk":
        from pythoncrt_tpu_torch.kernels import bloom_walk as kwalk

        keep = (kwalk.STRIP_WIDTHS, kwalk.STEPS, kwalk.RUN)
        for sw in (128, 64):
            for step in (8, 16, 32):
                for run_rows in (32, 64, 128, 256):
                    kwalk.STRIP_WIDTHS = tuple(v for v in keep[0] if v <= sw)
                    kwalk.STEPS = tuple(sorted({step, *keep[1]}, reverse=True))
                    kwalk.STEPS = tuple(v for v in kwalk.STEPS if v <= step)
                    kwalk.RUN = run_rows
                    kwalk.walk_plan.cache_clear()
                    row = dict(sw=sw, step=step, run=run_rows)
                    for name, fn in (("bloom3_planar", lambda: bloom3_case(None)),
                                     ("bloom2_planar_fast",
                                      lambda: bloom2_case("defaults-bloom2"))):
                        r = fn()
                        row[name] = r["ms_per_frame"]
                        row[name + "_same"] = r["sha256"] == results[name]["sha256"]
                    print(f"{a.tag} sweep {row}", flush=True)
                    sweep.append(row)
        kwalk.STRIP_WIDTHS, kwalk.STEPS, kwalk.RUN = keep
        kwalk.walk_plan.cache_clear()

    out = dict(tag=a.tag, tree=os.path.abspath(a.tree), card=card, build_s=built,
               torch=torch.__version__, results=results, sweep=sweep, fused_sass=sass)
    os.makedirs(os.path.dirname(a.out) or ".", exist_ok=True)
    with open(a.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
