"""The port's decode side (pythoncrt_tpu_torch.io.video): the
ChunkedParallelReader copy (``--decode-workers``) against the port's
sequential reader and against the JAX package's ChunkedParallelReader on
the same clip, with the JAX tests' estimated totals and failure cases
(tests/test_pipeline.py:92-240); the readers' start-frame seeks
(``--segment-frames`` resume) and the yuv420p pipe's arguments. Frames
are compared byte for byte (the same OpenCV decoder on both sides; no
ffmpeg binary here, so the OpenCV tier decodes)."""

import numpy as np
import pytest

from pythoncrt_tpu.io import video as jvio
from pythoncrt_tpu_torch.io import video as tvio

from conftest import synth_frames
from test_pipeline import write_clip

H, W, FPS = 48, 64, 24


@pytest.fixture
def tiny_clip(tmp_path):
    frames = synth_frames(12, H, W, seed=3)
    return write_clip(tmp_path / "in.mp4", frames), frames


def read_all(rdr):
    shape = getattr(rdr, "frame_shape", (rdr.out_h, rdr.out_w, 3))
    out = []
    while True:
        buf = np.empty(shape, np.uint8)
        if not rdr.read_into(buf):
            break
        out.append(buf)
    rdr.close()
    return np.stack(out) if out else np.zeros((0, *shape), np.uint8)


def batches(par, b):
    idx, got = [], []
    for i0, batch in par.iter_batches(b):
        idx.append(i0)
        got.append(np.array(batch))
    par.close()
    return idx, (np.concatenate(got) if got else np.zeros((0,)))


@pytest.mark.parametrize("workers,chunk_batches", [(2, 1), (3, 2)])
def test_parallel_reader_matches_sequential_and_jax(tiny_clip, workers, chunk_batches):
    path, _ = tiny_clip
    want = read_all(tvio.open_reader(str(path), W, H, FPS))
    kw = dict(total_frames=len(want), batch_size=4, workers=workers,
              chunk_batches=chunk_batches)
    idx, got = batches(tvio.ChunkedParallelReader(str(path), W, H, FPS, **kw), 4)
    jidx, jgot = batches(jvio.ChunkedParallelReader(str(path), W, H, FPS, **kw), 4)
    assert idx == jidx == list(range(0, len(want), 4))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jgot)


@pytest.mark.parametrize("delta", [5, -3], ids=["overestimated", "underestimated"])
def test_parallel_reader_estimated_total(tiny_clip, delta):
    """ceil(duration * fps) may over- or undershoot the real count: the
    reader stops at the true end either way (the last chunk reads on)."""
    path, frames = tiny_clip
    par = tvio.ChunkedParallelReader(str(path), W, H, FPS, total_frames=len(frames) + delta,
                                     batch_size=4, workers=2, chunk_batches=1)
    _, got = batches(par, 4)
    assert len(got) == len(frames)


def test_parallel_reader_fps_resample_is_sequential(tiny_clip):
    """A resampling output rate degrades to one sequential reader and
    yields the plain reader's frames (the JAX reader's too)."""
    path, _ = tiny_clip
    want = read_all(tvio.open_reader(str(path), W, H, 12))
    par = tvio.ChunkedParallelReader(str(path), W, H, 12, total_frames=len(want),
                                     batch_size=2, workers=3, chunk_batches=1)
    assert par.workers == 1 and par._sequential
    _, got = batches(par, 2)
    np.testing.assert_array_equal(got, want)
    _, jgot = batches(jvio.ChunkedParallelReader(str(path), W, H, 12, total_frames=len(want),
                                                 batch_size=2, workers=3, chunk_batches=1), 2)
    np.testing.assert_array_equal(got, jgot)


@pytest.mark.parametrize("start", [0, 4, 7, 12, 20])
def test_start_frame_matches_skipping(tiny_clip, start):
    """A reader opened at start_frame yields the frames a reader from 0
    yields from there on (CV2Reader's positioned read, the parallel
    reader's chunks); past the end, a clean empty stream."""
    path, frames = tiny_clip
    want = read_all(tvio.open_reader(str(path), W, H, FPS))[start:]
    got = read_all(tvio.open_reader(str(path), W, H, FPS, start_frame=start))
    np.testing.assert_array_equal(got, want)
    par = tvio.ChunkedParallelReader(str(path), W, H, FPS, total_frames=len(frames),
                                     batch_size=4, workers=2, chunk_batches=1,
                                     start_frame=start)
    idx, pgot = batches(par, 4)
    assert idx == list(range(start, len(frames), 4))
    np.testing.assert_array_equal(pgot.reshape(want.shape), want)


def test_parallel_reader_surfaces_decode_failure(tiny_clip, monkeypatch):
    """A worker's exception raises from iter_batches, never a fake end."""
    path, frames = tiny_clip
    real_open = tvio.open_reader

    def flaky(*a, **k):
        if k.get("start_frame", 0) > 0:
            raise RuntimeError("simulated mid-stream decoder death")
        return real_open(*a, **k)

    monkeypatch.setattr(tvio, "open_reader", flaky)
    par = tvio.ChunkedParallelReader(str(path), W, H, FPS, total_frames=len(frames),
                                     batch_size=4, workers=2, chunk_batches=1)
    with pytest.raises(RuntimeError, match="parallel decode worker"):
        for _ in par.iter_batches(4):
            pass
    par.close()


def test_chunk_cap_and_batch_contract(tiny_clip):
    """Chunks shrink to stay within 256 MB (here: 4K frames); a batch size
    other than the reader's is refused."""
    path, frames = tiny_clip
    par = tvio.ChunkedParallelReader(str(path), 3840, 2160, FPS, total_frames=len(frames),
                                     batch_size=8, workers=1, chunk_batches=4)
    assert par.chunk == 8  # 4 x 8 4K frames would be 796 MB
    with pytest.raises(ValueError, match="iter_batches"):
        next(par.iter_batches(4))
    par.close()


class FakeProc:
    stdout = None


@pytest.mark.parametrize("fmt", ["rgb24", "yuv420p", "gbrp"])
def test_ffmpeg_reader_arguments(monkeypatch, fmt):
    """The ffmpeg reader's command line, as the JAX reader builds it: the
    pipe format, and the accurate seek half a frame before the first
    frame when the rate is the source's (rounding up past frame k's pts
    would drop it); a resampling rate decodes and drops instead."""
    cmds = []
    monkeypatch.setattr(tvio, "find_ffmpeg", lambda: "/bin/ffmpeg")
    monkeypatch.setattr(tvio.subprocess, "Popen", lambda cmd, **kw: cmds.append(cmd) or FakeProc())
    for fps, k in ((30000.0 / 1001.0, 2997), (24.0, 7), (60.0, 1)):
        rd = tvio.FFmpegRawReader("x.mp4", W, H, fps, pipe_format=fmt, start_frame=k,
                                  src_fps=fps)
        cmd = cmds[-1]
        ts = float(cmd[cmd.index("-ss") + 1])
        assert (k - 1) / fps < ts < k / fps and cmd[cmd.index("-pix_fmt") + 1] == fmt
        assert rd.frame_shape == ((3, H, W) if fmt == "gbrp" else (H, W, 3))
    rd = tvio.FFmpegRawReader("x.mp4", W, H, 12.0, pipe_format=fmt, start_frame=5, src_fps=24.0)
    assert "-ss" not in cmds[-1] and rd._skip == 5


def test_yuv420p_reader_converts_a_half_size_pipe(monkeypatch):
    """The yuv420p mode reads W*H*3/2 bytes per frame from the pipe and
    converts them with the native BT.601 converter (byte for byte the
    JAX reader's)."""
    import io

    rng = np.random.default_rng(5)
    raw = rng.integers(0, 256, 2 * W * H * 3 // 2, dtype=np.uint8).tobytes()

    class Proc:
        stdout = io.BytesIO(raw)

        def wait(self, timeout=None):
            return 0

        def terminate(self):
            pass

    monkeypatch.setattr(tvio, "find_ffmpeg", lambda: "/bin/ffmpeg")
    monkeypatch.setattr(tvio.subprocess, "Popen", lambda cmd, **kw: Proc())
    got = read_all(tvio.FFmpegRawReader("x.mp4", W, H, 24.0, pipe_format="yuv420p"))
    from pythoncrt_tpu import native as jnative

    n = W * H * 3 // 2
    want = np.stack([jnative.yuv420p_to_rgb24(raw[i * n:(i + 1) * n], W, H) for i in range(2)])
    np.testing.assert_array_equal(got, want)


def test_yuv420p_without_ffmpeg_takes_the_opencv_tier(tiny_clip, monkeypatch):
    path, _ = tiny_clip
    monkeypatch.setattr(tvio, "find_ffmpeg", lambda: None)
    rd = tvio.open_reader(str(path), W, H, FPS, pipe_format="yuv420p")
    assert isinstance(rd, tvio.CV2Reader)
    np.testing.assert_array_equal(read_all(rd), read_all(tvio.open_reader(str(path), W, H, FPS)))


@pytest.mark.parametrize("pipe_format", ["rgb24", "yuv420p", "gbrp"])
@pytest.mark.parametrize("ffmpeg", [None, "/usr/bin/ffmpeg"])
def test_planar_pipe_gate_matches_jax(monkeypatch, pipe_format, ffmpeg):
    """The port's gate is the JAX package's (with its opt-out variable
    unset): planar only for rgb24 with an ffmpeg binary; yuv420p runs
    NHWC."""
    from pythoncrt_tpu import pipeline as jpipe
    from pythoncrt_tpu_torch import pipeline as tpipe

    monkeypatch.delenv("PCRT_NO_PLANAR", raising=False)
    monkeypatch.setattr(jvio, "find_ffmpeg", lambda: ffmpeg)
    monkeypatch.setattr(tvio, "find_ffmpeg", lambda: ffmpeg)
    want = pipe_format == "rgb24" and ffmpeg is not None
    assert tpipe.planar_pipe_gate(pipe_format) == jpipe.planar_pipe_gate(pipe_format) == want
