"""Command-line interface of the PyTorch/CUDA port.

The flag surface is the JAX package's (pythoncrt_tpu.cli.build_parser,
name for name with the reference CLI), plus ``--device``. Flags whose
machinery is not ported yet exit with status 2 and name the ROADMAP.md
item that brings them; so do effect configurations outside the port's
slice (engine.unsupported). Nothing falls back to another path.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

from pythoncrt_tpu.cli import build_parser, params_from_args, provided_flags


def _parser():
    p = build_parser()
    p.prog = "python -m pythoncrt_tpu_torch"
    p.description = "CRT video effect renderer (PyTorch/CUDA port)"
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to render on (default cuda; 'cpu' runs "
                        "the kernels' plain PyTorch twins)")
    return p


def _without_device(argv):
    """argv minus --device (the JAX parser would read it as --devices)."""
    out, skip = [], False
    for tok in argv:
        if skip:
            skip = False
        elif tok == "--device":
            skip = True
        elif not tok.startswith("--device="):
            out.append(tok)
    return out


def _refusal(a) -> str:
    """The first flag the port does not run yet, as a message, or ''."""
    todo = [
        (a.batch_manifest, "--batch-manifest", "queue 1, multiclip"),
        (a.gui, "--gui", "queue 1, GUI"),
        (a.segment_frames > 0, "--segment-frames", "queue 1, pipeline: segment resume"),
        (a.devices > 1, "--devices", "queue 1, multiclip"),
        (a.assoc_scan, "--assoc-scan", "queue 1, c4 slice"),
        (a.precision == "fast", "--precision fast", "queue 1, fallback slice"),
        (a.engine_mode == "preview", "--engine-mode preview", "queue 1, c4 slice"),
        (a.decode_workers > 1, "--decode-workers", "queue 1, pipeline: parallel decode"),
        (a.steps_per_call > 1, "--steps-per-call", "queue 1, pipeline"),
        (a.check_deps, "--check-deps", "queue 1, pipeline"),
    ]
    for hit, flag, item in todo:
        if hit:
            return f"{flag} is not ported to the PyTorch/CUDA package yet: ROADMAP.md {item}"
    return ""


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    a = _parser().parse_args(argv)
    msg = _refusal(a)
    if msg:
        print(msg, file=sys.stderr)
        return 2
    if not a.input:
        print("--input is required (the GUI is not ported yet: ROADMAP.md queue 1, GUI)",
              file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    inp = Path(a.input)
    if not inp.exists():
        print("input not found", file=sys.stderr)
        return 2
    out = Path(a.output) if a.output else inp.with_name(inp.stem + "_crt.mp4")
    params = params_from_args(a, provided_flags(_without_device(argv)))
    from .engine import unsupported

    why = unsupported(params)
    if why:
        print(why, file=sys.stderr)
        return 2
    import torch

    if a.device.startswith("cuda") and not torch.cuda.is_available():
        print(f"--device {a.device}: no CUDA device is available "
              "(pass --device cpu to render with the plain PyTorch path)",
              file=sys.stderr)
        return 2
    from .pipeline import process_video

    try:
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
            precision=str(a.precision),
            pipe_format=str(a.pipe_format),
            device=a.device,
            profile_dir=a.profile or None,
        )
    except NotImplementedError as e:
        print(str(e), file=sys.stderr)
        return 2
    print("Hardware encoder used" if used_gpu else "CPU encoder used")
    print(f"elapsed {time.perf_counter() - t0:.3f}s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
