"""The port's entry points: no import of JAX or of the JAX package,
refusals for what the port does not run, the GUI guard (exit 3 without
PySide6), the render loop against
CRTEngine.process, and CLI renders of a tiny clip on the CPU (c3, the
CLI defaults and c4, export and preview; 2-D scanlines and text
overlays; --precision fast, --segment-frames, --decode-workers,
--pipe-format yuv420p, --devices, --sharding, --steps-per-call and
--check-deps in a fresh interpreter each)."""

import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from pythoncrt_tpu_torch import CRTEngine, TextParams, cli
from pythoncrt_tpu_torch.pipeline import render_stream

from conftest import synth_frames
from test_engine_vs_oracle import identity_params
from test_fused import FULL

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W, FPS = 48, 256, 24.0

C3_FLAGS = [
    "--scanline-strength", "0.6", "--triad-strength", "0.35", "--triad-softness", "0.5",
    "--aberration-px", "1", "--bloom-sigma", "1.2", "--bloom-strength", "0.25",
    "--no-fast-bloom", "--noise-strength", "1.5", "--vignette-strength", "0.25",
    "--persistence", "0", "--pixel-size", "2", "--grain-size", "2",
    "--warp-strength", "0.15", "--flicker-strength", "0.2", "--flicker-hz", "2",
    "--brightness", "0.02", "--contrast", "1.05", "--gamma", "1.1",
    "--saturation", "0.9", "--temperature", "0.1",
]


def write_clip(path, n=8, seed=2):
    cv2 = pytest.importorskip("cv2")
    wr = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), FPS, (W, H))
    for f in synth_frames(n, H, W, seed=seed):
        wr.write(f)
    wr.release()


def count_frames(path):
    import cv2

    cap = cv2.VideoCapture(str(path))
    n = 0
    while cap.read()[0]:
        n += 1
    cap.release()
    return n


def test_port_imports_no_jax(tmp_path):
    """After CLI renders on the CPU (the CLI defaults, angled scanlines, a
    text overlay), in a fresh interpreter each, neither JAX nor any
    module of the JAX package is loaded."""
    inp = tmp_path / "in.mp4"
    write_clip(inp, n=4)
    for i, flags in enumerate([[], ["--scanline-angle", "12", "--scanline-thickness", "2"],
                               ["--text", "HI", "--text-size", "12"]]):
        out = tmp_path / f"out{i}.mp4"
        code = ("import sys, pythoncrt_tpu_torch.cli as c, pythoncrt_tpu_torch.convert; "
                f"rc = c.main(['--input', {str(inp)!r}, '--output', {str(out)!r}, *{flags!r}, "
                "'--device', 'cpu', '--batch-size', '2']); "
                "bad = sorted(m for m in sys.modules "
                "if m.split('.')[0] in ('jax', 'pythoncrt_tpu')); "
                "print('rc', rc, 'loaded', bad); sys.exit(rc or (1 if bad else 0))")
        res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                             capture_output=True, text=True, timeout=300)
        assert res.returncode == 0, (flags, res.stdout + res.stderr)
        assert "rc 0 loaded []" in res.stdout and count_frames(out) == 4, flags


@pytest.mark.parametrize("overrides,kw,item", [
    ({}, dict(precision="medium"), "precision must be"),
])
def test_out_of_slice_configs_raise(overrides, kw, item):
    """Precision "fast" renders now (test_torch_precision.py); a precision
    the JAX engine does not have is refused as it refuses it."""
    with pytest.raises(ValueError, match=item):
        CRTEngine(identity_params(**overrides), H, W, FPS, device="cpu", **kw)


@pytest.mark.parametrize("flags", [
    ["--precision", "fast"], ["--segment-frames", "2"], ["--decode-workers", "2"],
    ["--pipe-format", "yuv420p"], ["--check-deps"], ["--devices", "2"],
    ["--devices", "2", "--sharding", "none"], ["--steps-per-call", "2"],
], ids=["precision_fast", "segment_frames", "decode_workers", "yuv420p", "check_deps",
        "devices_2", "devices_2_sharding_none", "steps_per_call_2"])
def test_ported_flags_render_without_jax(tmp_path, flags):
    """Each flag the port now runs renders 4 frames through cli.main (or,
    --check-deps, reports and exits 0) in a fresh interpreter that loads
    no module of JAX or of the JAX package. --devices 2 with --device cpu
    renders on the one device named, as the JAX package caps the shards
    at the devices it sees."""
    inp, out = tmp_path / "in.mp4", tmp_path / "out.mp4"
    write_clip(inp, n=4)
    code = ("import sys, pythoncrt_tpu_torch.cli as c; "
            f"rc = c.main(['--input', {str(inp)!r}, '--output', {str(out)!r}, *{flags!r}, "
            "'--device', 'cpu', '--batch-size', '2', '--persistence', '0.5']); "
            "bad = sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'pythoncrt_tpu')); "
            "print('rc', rc, 'loaded', bad); sys.exit(rc or (1 if bad else 0))")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, (flags, res.stdout + res.stderr)
    assert "rc 0 loaded []" in res.stdout
    if flags == ["--check-deps"]:
        assert not out.exists()
        assert "all dependencies present" in res.stdout or "missing (optional)" in res.stdout
    else:
        assert count_frames(out) == 4 and "perf frames 4" in res.stdout


@pytest.mark.parametrize("overrides", [
    dict(scanline_strength=0.5, scanline_angle=12.0),
    dict(text=TextParams(text="hi", size=14, after=False)),
], ids=["scanline_angle", "text"])
def test_formerly_refused_configs_render(overrides):
    """Angled scanlines and a text overlay (rasterized by the port's
    text.overlay_for) build and render, and change the frames."""
    from pythoncrt_tpu_torch.text import overlay_for

    p = identity_params(**overrides)
    frames = synth_frames(4, H, W, seed=6)
    eng = CRTEngine(p, H, W, FPS, device="cpu", text_rgba=overlay_for(W, H, p.text))
    out, _ = eng.process(frames)
    assert out.shape == frames.shape and out.dtype == torch.uint8
    assert not np.array_equal(out.numpy(), frames)


@pytest.mark.parametrize("flags", [["--steps-per-call", "2"]])
def test_out_of_slice_flags_exit_2(flags, tmp_path, monkeypatch, capsys):
    """The last flag value the port refused (exit 2 until super-batches
    were ported) renders: exit 0, every frame written, and the frames
    handed to the encoder are those of ``--steps-per-call 1``, byte for
    byte (10 frames at batch 2: two super-batches of 4, then a batch)."""
    from pythoncrt_tpu_torch.io import video as tvio

    got = {}
    real = tvio.open_writer

    def open_writer(dst, *a, **k):
        wtr, gpu = real(dst, *a, **k)
        rec = got[str(dst)] = []

        class Rec:
            def write_frame(self, f):
                rec.append(np.array(f))
                wtr.write_frame(f)

            def close(self):
                wtr.close()
        return Rec(), gpu
    monkeypatch.setattr(tvio, "open_writer", open_writer)
    inp = tmp_path / "in.mp4"
    write_clip(inp, n=10)
    outs = {}
    for tag, extra in (("flags", flags), ("one", ["--steps-per-call", "1"])):
        outs[tag] = tmp_path / f"{tag}.mp4"
        rc = cli.main(["--input", str(inp), "--output", str(outs[tag]), *C4_FLAGS, *extra,
                       "--batch-size", "2", "--device", "cpu"])
        assert rc == 0, capsys.readouterr()
        assert count_frames(outs[tag]) == 10
    a, b = (np.stack(got[str(outs[t])]) for t in ("flags", "one"))
    assert a.shape == (10, H, W, 3)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("argv", [
    ["--input", "x.mp4", "--gui"], ["--gui"], [], ["--gui", "--device", "cpu"],
    ["--output", "y.mp4", *C3_FLAGS],
], ids=["input_gui", "gui", "no_args", "gui_cpu", "no_input"])
def test_gui_without_pyside6_exits_3(argv, capsys):
    """--gui, or no --input without --batch-manifest, opens the GUI as the
    JAX CLI does (pythoncrt_tpu/cli.py:359-362); without PySide6 the guard
    exits 3 with the JAX package's message, naming the port's CLI, before
    it asks for a CUDA device."""
    if importlib.util.find_spec("PySide6") is not None:
        pytest.skip("PySide6 is installed here")
    assert cli.main(argv) == 3
    err = capsys.readouterr().err
    assert "GUI unavailable: PySide6 is not installed" in err
    assert "python -m pythoncrt_tpu_torch --input in.mp4" in err


@pytest.mark.parametrize("argv", [["--gui"], []], ids=["gui", "no_args"])
def test_gui_guard_loads_no_jax(argv):
    """In a fresh interpreter the guard exits 3 and loads neither JAX nor
    any module of the JAX package (nor torch: the guard needs none)."""
    if importlib.util.find_spec("PySide6") is not None:
        pytest.skip("PySide6 is installed here")
    code = ("import sys, pythoncrt_tpu_torch.cli as c; "
            f"rc = c.main({argv!r}); "
            "bad = sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'pythoncrt_tpu')); "
            "print('rc', rc, 'loaded', bad, 'torch', 'torch' in sys.modules)")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert "rc 3 loaded [] torch False" in res.stdout, res.stdout + res.stderr
    assert "GUI unavailable" in res.stderr


def test_gui_with_qt_but_no_cuda_exits_2(monkeypatch, capsys):
    """With Qt present, --device cuda on a host without CUDA exits 2 with
    the no-CUDA message, before any window is built."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    from pythoncrt_tpu_torch import gui

    monkeypatch.setattr(gui, "qt_available", lambda: True)
    monkeypatch.setattr(gui, "launch_gui", lambda device: pytest.fail("window built"))
    assert cli.main(["--gui"]) == 2
    assert "no CUDA device" in capsys.readouterr().err


@pytest.mark.parametrize("extra", [[], ["--devices", "2"]], ids=["render", "devices_2"])
def test_cli_renders_a_batch_manifest(tmp_path, capsys, extra):
    """--batch-manifest renders two clips of different lengths in
    lockstep on the CPU (every frame of each), with --devices 2 too: the
    jobs carry it into process_videos, which shards no clip on the CPU."""
    import json

    clips = []
    for i, n in enumerate((5, 3)):
        clips.append(tmp_path / f"in{i}.mp4")
        write_clip(clips[-1], n=n, seed=i)
    m = tmp_path / "jobs.json"
    m.write_text(json.dumps({"jobs": [{"input": str(c), "output": str(tmp_path / f"o{i}.mp4")}
                                      for i, c in enumerate(clips)]}))
    rc = cli.main(["--batch-manifest", str(m), *C4_FLAGS, "--batch-size", "2",
                   "--device", "cpu", *extra])
    out, err = capsys.readouterr()
    assert rc == 0, out + err
    assert "2/2 clips ok" in out
    assert [count_frames(tmp_path / f"o{i}.mp4") for i in range(2)] == [5, 3]


C4_FLAGS = [
    "--scanline-strength", "0.6", "--triad-strength", "0.35", "--aberration-px", "1",
    "--bloom-strength", "0.25", "--fast-bloom", "--noise-strength", "1.5",
    "--vignette-strength", "0.25", "--persistence", "0.6", "--pixel-size", "1",
    "--glitch-amp", "6", "--glitch-height", "0.3", "--scanline-speed", "120",
]


@pytest.mark.parametrize("flags", [
    [], C4_FLAGS, [*C4_FLAGS, "--engine-mode", "preview"], ["--assoc-scan", "--rng", "host"],
    ["--scanline-angle", "12", "--scanline-thickness", "2"],
    [*C4_FLAGS, "--text", "PLAY", "--text-size", "12"],
    [*C3_FLAGS, "--scanline-angle", "5", "--scanline-thickness", "1.5", "--text", "HI",
     "--text-size", "12", "--text-after"],
], ids=["defaults", "c4", "c4_preview", "defaults_assoc_host", "defaults_angled", "c4_text",
        "c3_angled_text_after"])
def test_cli_renders_the_temporal_configs(tmp_path, capsys, flags):
    """The CLI defaults (no effect flags) and c4, in both glitch modes and
    with the associative persistence scan, and the new paths (angled
    scanlines, text before and after the effects) render on the CPU,
    exit 0 and write every frame."""
    inp, out = tmp_path / "in.mp4", tmp_path / "out.mp4"
    write_clip(inp, n=6)
    rc = cli.main(["--input", str(inp), "--output", str(out), *flags,
                   "--batch-size", "4", "--device", "cpu"])
    assert rc == 0, capsys.readouterr()
    assert "perf frames 6" in capsys.readouterr().out
    assert count_frames(out) == 6


def test_cuda_device_without_cuda_exits_nonzero(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    inp = tmp_path / "in.mp4"
    inp.write_bytes(b"")
    assert cli.main(["--input", str(inp), *C3_FLAGS]) != 0
    assert "no CUDA device" in capsys.readouterr().err


class ListReader:
    """In-memory reader with the io.video protocol."""

    def __init__(self, frames):
        self.frames, self.i = frames, 0
        self.out_h, self.out_w = frames.shape[1], frames.shape[2]

    def read_into(self, buf) -> bool:
        if self.i >= len(self.frames):
            return False
        buf[...] = self.frames[self.i]
        self.i += 1
        return True

    def close(self):
        pass


class ListWriter:
    def __init__(self):
        self.frames = []

    def write_frame(self, frame):
        self.frames.append(np.array(frame))

    def close(self):
        pass


@pytest.mark.parametrize("layout", ["nhwc", "planar_gbr"])
def test_render_stream_matches_process(layout):
    """The render loop (threads, host buffer pools, batch split 3+3+2)
    gives the bytes of one process() call, in the NHWC layout and in
    the planar gbrp layout an ffmpeg pipe feeds."""
    p = identity_params(**FULL)
    frames = synth_frames(8, H, W, seed=4)
    kw = {}
    if layout == "planar_gbr":
        frames = np.ascontiguousarray(np.transpose(frames, (0, 3, 1, 2))[:, [1, 2, 0]])
        kw = dict(layout="planar", channel_order="gbr")
    reader = ListReader(frames)
    reader.out_h, reader.out_w, reader.frame_shape = H, W, frames.shape[1:]
    writer = ListWriter()
    eng = CRTEngine(p, H, W, FPS, seed=3, device="cpu", **kw)
    n = render_stream(reader, writer, eng, batch_size=3)
    assert n == 8 and len(writer.frames) == 8
    want, _ = CRTEngine(p, H, W, FPS, seed=3, device="cpu", **kw).process(frames)
    np.testing.assert_array_equal(np.stack(writer.frames), want.numpy())


def test_render_stream_surfaces_codec_failures():
    p = identity_params(**FULL)
    frames = synth_frames(8, H, W, seed=4)
    eng = CRTEngine(p, H, W, FPS, device="cpu")

    class BadWriter(ListWriter):
        def write_frame(self, frame):
            raise OSError("disk full")

    class BadReader(ListReader):
        def read_into(self, buf):
            if self.i == 5:
                raise OSError("corrupt packet")
            return super().read_into(buf)

    with pytest.raises(RuntimeError, match="encode failed"):
        render_stream(ListReader(frames), BadWriter(), eng, batch_size=2)
    with pytest.raises(RuntimeError, match="decode failed"):
        render_stream(BadReader(frames), ListWriter(), eng, batch_size=2)


def test_cli_renders_a_tiny_clip(tmp_path, capsys):
    cv2 = pytest.importorskip("cv2")
    inp, out = tmp_path / "in.mp4", tmp_path / "out.mp4"
    wr = cv2.VideoWriter(str(inp), cv2.VideoWriter_fourcc(*"mp4v"), FPS, (W, H))
    for f in synth_frames(8, H, W, seed=2):
        wr.write(f)
    wr.release()
    rc = cli.main(["--input", str(inp), "--output", str(out), *C3_FLAGS,
                   "--batch-size", "4", "--device", "cpu"])
    assert rc == 0, capsys.readouterr()
    report = capsys.readouterr().out
    assert "perf frames 8" in report and "fx.dispatch" in report
    cap = cv2.VideoCapture(str(out))
    n = 0
    while cap.read()[0]:
        n += 1
    cap.release()
    assert n == 8
