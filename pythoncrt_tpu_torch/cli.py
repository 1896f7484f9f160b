"""Command-line interface of the PyTorch/CUDA port.

The flag surface is the reference CLI's (crt_filter.py:1153-1207), name
for name and default for default with pythoncrt_tpu/cli.py (the JAX
package's additions included), plus ``--device``. The clamp semantics of
the reference driver (:1225-1266) apply through EffectParams.clamped.
``--batch-manifest`` renders a JSON manifest of clips (batch.render_batch:
lockstep groups through multiclip.process_videos, journal resume,
per-clip retry), as pythoncrt_tpu/cli.py's ``_run_batch`` does.
``--check-deps`` prints the dependency report and exits 0 or 4 before
any other work. ``--gui``, or no ``--input`` without ``--batch-manifest``,
opens the Qt window (gui.launch_gui) on ``--device``, as
pythoncrt_tpu/cli.py does: exit 3 without PySide6. ``--sharding auto``
(the default) splits each batch's frames across the visible cards, at
most ``--devices`` of them, when ``--device`` is ``cuda``; manifest
groups shard their clips the same way. ``--steps-per-call`` n runs n
batches per device call (0, the default: the JAX package's auto rule;
forced to 1 under ``--segment-frames``), for the single clip and the
manifest alike. Every value the JAX CLI accepts renders; nothing falls
back to another path.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from pathlib import Path

from .params import EffectParams, TextParams, load_preset, load_text_preset


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m pythoncrt_tpu_torch",
        description="CRT video effect renderer (PyTorch/CUDA port)",
    )
    p.add_argument("--input", type=str, default="")
    p.add_argument("--output", type=str)
    p.add_argument("--width", type=int, default=0)
    p.add_argument("--height", type=int, default=0)
    p.add_argument("--fps", type=int, default=0)
    p.add_argument("--scanline-strength", type=float, default=0.6)
    p.add_argument("--triad-strength", type=float, default=0.35)
    p.add_argument("--triad-gamma", type=float, default=2.2)
    p.add_argument("--triad-preserve-luma", action="store_true")
    p.add_argument("--triad-softness", type=float, default=0.5)
    p.add_argument("--aberration-px", type=int, default=1)
    p.add_argument("--bloom-sigma", type=float, default=1.2)
    p.add_argument("--bloom-strength", type=float, default=0.25)
    p.add_argument("--bloom-threshold", type=float, default=0.0)
    p.add_argument("--noise-strength", type=float, default=1.5)
    p.add_argument("--vignette-strength", type=float, default=0.25)
    p.add_argument("--persistence", type=float, default=0.2)
    p.add_argument("--crf", type=int, default=18)
    p.add_argument("--bitrate", type=int, default=0)
    p.add_argument("--scanline-speed", type=float, default=30.0)
    p.add_argument("--scanline-period", type=float, default=2.0)
    # the default rides on the action, not on p.set_defaults: parser-level
    # defaults would slip past provided_flags and beat a preset's value
    p.add_argument("--fast-bloom", action="store_true", default=True)
    p.add_argument("--no-fast-bloom", dest="fast_bloom", action="store_false")
    p.add_argument("--pixel-size", type=int, default=2)
    p.add_argument("--brightness", type=float, default=0.0)
    p.add_argument("--contrast", type=float, default=1.0)
    p.add_argument("--gamma", type=float, default=1.0)
    p.add_argument("--saturation", type=float, default=1.0)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--flicker-strength", type=float, default=0.0)
    p.add_argument("--flicker-hz", type=float, default=0.0)
    p.add_argument("--grain-size", type=int, default=1)
    p.add_argument("--scanline-angle", type=float, default=0.0)
    p.add_argument("--scanline-thickness", type=float, default=1.0)
    p.add_argument("--warp-strength", type=float, default=0.0)
    p.add_argument("--text", type=str, default="")
    p.add_argument("--text-font", type=str, default="")
    p.add_argument("--text-size", type=int, default=36)
    p.add_argument("--text-color", type=str, default="#FFFFFF")
    p.add_argument("--text-x", type=int, default=32)
    p.add_argument("--text-y", type=int, default=32)
    p.add_argument("--text-after", action="store_true")
    p.add_argument("--gpu", action="store_true",
                   help="prefer a hardware host encoder (probe-verified)")
    p.add_argument("--nvenc-preset", type=str, default="p4")
    p.add_argument("--encoder", type=str, default="auto",
                   choices=["auto", "nvidia", "amd", "cpu"])
    p.add_argument("--decoder", type=str, default="auto",
                   choices=["auto", "nvidia", "amd", "intel", "cpu"])
    p.add_argument("--glitch-amp", type=int, default=0)
    p.add_argument("--glitch-height", type=float, default=0.0)
    p.add_argument("--gui", action="store_true")
    p.add_argument("--check-deps", action="store_true",
                   help="report missing dependencies and exit")
    p.add_argument("--preset", type=str, default="",
                   help="load an effect preset JSON (reference schema)")
    p.add_argument("--text-preset", type=str, default="",
                   help="load a text preset JSON (reference schema)")
    p.add_argument("--batch-size", type=int, default=16,
                   help="frames per device batch")
    p.add_argument("--engine-mode", type=str, default="export",
                   choices=["export", "preview"],
                   help="glitch algorithm variant (reference export/preview split)")
    p.add_argument("--rng", type=str, default="native", choices=["native", "host"],
                   help="noise/glitch randomness source")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--precision", type=str, default="exact",
                   choices=["exact", "fast"],
                   help="'exact' keeps <=1 LSB parity with the CPU reference")
    p.add_argument("--assoc-scan", action="store_true",
                   help="O(log B) associative persistence scan")
    p.add_argument("--pipe-format", type=str, default="rgb24",
                   choices=["rgb24", "yuv420p"],
                   help="rawvideo decode pipe format (rgb24 becomes planar "
                        "gbrp pipes when an ffmpeg binary is present)")
    p.add_argument("--segment-frames", type=int, default=0,
                   help="checkpoint the render every N frames; 0 disables")
    p.add_argument("--profile", type=str, default="",
                   help="write a torch.profiler trace of the render to this directory")
    p.add_argument("--sharding", type=str, default="auto", choices=["auto", "none"],
                   help="frame-axis sharding across devices")
    p.add_argument("--devices", type=int, default=0,
                   help="max devices to shard across (0 = all visible)")
    p.add_argument("--decode-workers", type=int, default=1,
                   help="parallel seek-positioned decode workers")
    p.add_argument("--steps-per-call", type=int, default=0,
                   help="batch chunks per device dispatch (0 = auto)")
    p.add_argument("--batch-manifest", type=str, default="",
                   help="render a batch of clips from a JSON manifest")
    p.add_argument("--batch-journal", type=str, default="",
                   help="journal path for --batch-manifest resume")
    p.add_argument("--batch-retries", type=int, default=1,
                   help="per-clip retries for failed --batch-manifest jobs")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to render on (default cuda; 'cpu' runs "
                        "the kernels' plain PyTorch twins)")
    return p


def provided_flags(argv=None) -> set:
    """Dest names of the options the user passed: a parallel parse with
    every default suppressed leaves only the given options. Lets an
    explicit flag beat a --preset value even when it equals the default."""
    sp = build_parser()
    for act in sp._actions:
        act.default = argparse.SUPPRESS
    sp._defaults.clear()  # parser-level set_defaults would bypass the above
    ns, _ = sp.parse_known_args(argv)
    return set(vars(ns))


def params_from_args(a: argparse.Namespace, provided: set | None = None) -> EffectParams:
    """EffectParams from the flags. As in the reference, the preset is
    the base and explicit flags win. ``provided`` (from provided_flags)
    names the explicit flags exactly; without it, a flag at its parser
    default defers to the preset."""
    base = EffectParams()
    if a.preset:
        try:
            base, _ = load_preset(a.preset, base)
        except (OSError, ValueError) as e:
            raise SystemExit(f"failed to load preset {a.preset!r}: {e}")
    defaults = build_parser().parse_args([]) if provided is None else None

    def explicit(flag: str) -> bool:
        if provided is not None:
            return flag in provided
        return getattr(a, flag) != getattr(defaults, flag)

    t_base = TextParams()
    if a.text_preset:
        try:
            t_base = load_text_preset(a.text_preset)
        except (OSError, ValueError) as e:
            raise SystemExit(f"failed to load text preset {a.text_preset!r}: {e}")
    text_map = dict(text="text", text_font="font", text_size="size",
                    text_color="color", text_x="x", text_y="y", text_after="after")
    t_upd = {}
    for flag, field in text_map.items():
        if not a.text_preset or explicit(flag):
            t_upd[field] = getattr(a, flag)
    text = dataclasses.replace(t_base, **t_upd)
    flag_map = dict(
        scanline_strength="scanline_strength", triad_strength="triad_strength",
        triad_gamma="triad_gamma", triad_preserve_luma="triad_preserve_luma",
        triad_softness="triad_softness", aberration_px="aberration_px",
        bloom_sigma="bloom_sigma", bloom_strength="bloom_strength",
        bloom_threshold="bloom_threshold", noise_strength="noise_strength",
        vignette_strength="vignette_strength", persistence="persistence",
        scanline_speed="scanline_speed_px_s", scanline_period="scanline_period_px",
        fast_bloom="fast_bloom", pixel_size="pixel_size",
        brightness="brightness", contrast="contrast", gamma="gamma",
        saturation="saturation", temperature="temperature",
        flicker_strength="flicker_strength", flicker_hz="flicker_hz",
        grain_size="grain_size", scanline_angle="scanline_angle",
        scanline_thickness="scanline_thickness", warp_strength="warp_strength",
        glitch_amp="glitch_amp_px", glitch_height="glitch_height_frac",
    )
    updates = {}
    for flag, field in flag_map.items():
        if not a.preset or explicit(flag):
            updates[field] = getattr(a, flag)
    return dataclasses.replace(base, **updates, text=text).clamped()


def _run_batch(a: argparse.Namespace, argv) -> int:
    """--batch-manifest: manifest jobs -> batch.render_batch (journal
    resume, per-clip retry; jobs that share params, size and fps render
    in lockstep through multiclip.process_videos). Exit 2 on a bad
    manifest, 5 when a clip failed."""
    import json

    mpath = Path(a.batch_manifest)
    if not mpath.exists():
        print("batch manifest not found", file=sys.stderr)
        return 2
    try:
        data = json.loads(mpath.read_text())
        if isinstance(data, dict):
            data = data["jobs"]
        if not isinstance(data, list) or not data:
            raise ValueError("manifest must be a non-empty list of jobs (or {'jobs': [...]})")
    except (OSError, ValueError, KeyError) as e:
        print(f"failed to load batch manifest {a.batch_manifest!r}: {e}", file=sys.stderr)
        return 2

    prov = provided_flags(argv)
    params = params_from_args(a, prov)
    from .batch import ClipJob, render_batch

    # the JAX CLI's kwargs (so the journal signatures agree), plus the device
    kwargs = dict(
        crf=int(max(12, min(28, a.crf))),
        target_bitrate_kbps=int(max(0, a.bitrate)),
        gpu=bool(a.gpu),
        nvenc_preset=str(a.nvenc_preset),
        encoder_preference=str(a.encoder),
        decoder_preference=str(a.decoder),
        batch_size=max(1, int(a.batch_size)),
        engine_mode=str(a.engine_mode),
        rng=str(a.rng),
        seed=int(a.seed),
        precision=str(a.precision),
        pipe_format=str(a.pipe_format),
        devices=max(0, int(a.devices)),
        steps_per_call=int(a.steps_per_call),
        device=a.device,
    )
    # options outside the lockstep surface send the job down the
    # sequential per-clip path (batch.MULTI_CLIP_KWARGS)
    if a.segment_frames > 0:
        kwargs["segment_frames"] = int(a.segment_frames)
    if a.decode_workers > 1:
        kwargs["decode_workers"] = int(a.decode_workers)
    if a.assoc_scan:
        kwargs["assoc_scan"] = True
    if a.sharding != "auto":
        kwargs["sharding"] = str(a.sharding)
    if a.profile:
        kwargs["profile_dir"] = str(a.profile)

    jobs = []
    for i, d in enumerate(data):
        try:
            inp = Path(d["input"])
        except (TypeError, KeyError):
            print(f"manifest job {i} has no 'input'", file=sys.stderr)
            return 2
        out = d.get("output") or str(inp.with_name(inp.stem + "_crt.mp4"))
        job_params = params
        if d.get("preset") or d.get("text_preset"):
            # a job's preset replaces --preset/--text-preset as its base;
            # explicitly passed flags still win (the single-clip rule)
            ja = argparse.Namespace(**vars(a))
            if d.get("preset"):
                ja.preset = str(d["preset"])
            if d.get("text_preset"):
                ja.text_preset = str(d["text_preset"])
            try:
                job_params = params_from_args(ja, prov)
            except SystemExit as e:
                print(f"manifest job {i}: {e}", file=sys.stderr)
                return 2
        try:
            jw = int(d["width"]) if d.get("width") else (a.width if a.width > 0 else None)
            jh = int(d["height"]) if d.get("height") else (a.height if a.height > 0 else None)
            jf = float(d["fps"]) if d.get("fps") else (a.fps if a.fps > 0 else None)
        except (TypeError, ValueError) as e:
            print(f"manifest job {i}: bad width/height/fps: {e}", file=sys.stderr)
            return 2
        jobs.append(ClipJob(str(inp), str(out), job_params, width=jw, height=jh, fps=jf,
                            kwargs=dict(kwargs)))

    journal = a.batch_journal or str(mpath) + ".journal.jsonl"
    if journal == "none":
        journal = None
    t0 = time.perf_counter()
    results = render_batch(jobs, journal=journal, max_retries=max(0, int(a.batch_retries)))
    n_ok = sum(r.ok for r in results)
    n_skip = sum(r.skipped for r in results)
    for r in results:
        tag = "skipped (journal)" if r.skipped else "ok" if r.ok else "FAILED"
        print(f"{r.job.input_path} -> {r.job.output_path}: {tag}"
              + (f" [{r.seconds:.1f}s]" if not r.skipped else ""))
        if not r.ok and r.error:
            print(f"  {r.error.strip().splitlines()[-1]}", file=sys.stderr)
    print(f"{n_ok}/{len(results)} clips ok ({n_skip} resumed), "
          f"elapsed {time.perf_counter() - t0:.3f}s")
    return 0 if n_ok == len(results) else 5


def _no_cuda(device: str) -> bool:
    import torch

    if device.startswith("cuda") and not torch.cuda.is_available():
        print(f"--device {device}: no CUDA device is available "
              "(pass --device cpu to render with the plain PyTorch path)", file=sys.stderr)
        return True
    return False


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    a = build_parser().parse_args(argv)
    if a.check_deps:
        from .bootstrap import check_deps

        rep = check_deps()
        print(rep.render())
        return 0 if rep.ok else 4
    if a.batch_manifest:
        return 2 if _no_cuda(a.device) else _run_batch(a, argv)
    if a.gui or not a.input:
        from . import gui

        # PySide6 first (exit 3, the JAX package's guard), then the card
        if gui.qt_available() and _no_cuda(a.device):
            return 2
        return gui.launch_gui(device=a.device)
    t0 = time.perf_counter()
    inp = Path(a.input)
    if not inp.exists():
        print("input not found", file=sys.stderr)
        return 2
    out = Path(a.output) if a.output else inp.with_name(inp.stem + "_crt.mp4")
    params = params_from_args(a, provided_flags(argv))
    if _no_cuda(a.device):
        return 2
    from .pipeline import process_video

    used_gpu = process_video(
        inp, out, params,
        width=a.width if a.width > 0 else None,
        height=a.height if a.height > 0 else None,
        fps=a.fps if a.fps > 0 else None,
        crf=int(max(12, min(28, a.crf))),
        target_bitrate_kbps=int(max(0, a.bitrate)),
        gpu=bool(a.gpu),
        nvenc_preset=str(a.nvenc_preset),
        encoder_preference=str(a.encoder),
        decoder_preference=str(a.decoder),
        batch_size=max(1, int(a.batch_size)),
        engine_mode=str(a.engine_mode),
        rng=str(a.rng),
        seed=int(a.seed),
        assoc_scan=bool(a.assoc_scan),
        precision=str(a.precision),
        pipe_format=str(a.pipe_format),
        sharding=str(a.sharding),
        devices=max(0, int(a.devices)),
        decode_workers=max(1, int(a.decode_workers)),
        segment_frames=max(0, int(a.segment_frames)),
        steps_per_call=int(a.steps_per_call),
        device=a.device,
        profile_dir=a.profile or None,
    )
    print("Hardware encoder used" if used_gpu else "CPU encoder used")
    print(f"elapsed {time.perf_counter() - t0:.3f}s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
