"""``--segment-frames`` in the port (pythoncrt_tpu_torch.segments and the
segmented loop of pipeline.process_video) on the CPU: the JAX package's
segment tests (tests/test_pipeline.py TestSegmentResume and
TestSegmentStore) run against the port, and the resume contract is held
bit for bit: the uint8 frames that reach the segment writers of a
crash-resumed render are the straight render's, with persistence and
native-rng grain and glitch on. Without an ffmpeg binary the merge
re-encodes through OpenCV (the output is a second generation: PSNR
> 30 dB against the plain render, the JAX test's bound); its ffmpeg
concat branch does not run here."""

import json

import numpy as np
import pytest

from pythoncrt_tpu import EffectParams as JaxParams
from pythoncrt_tpu.pipeline import process_video as jax_process_video
from pythoncrt_tpu_torch import EffectParams
from pythoncrt_tpu_torch import pipeline as tpipe
from pythoncrt_tpu_torch.io import video as tvio
from pythoncrt_tpu_torch.pipeline import process_video
from pythoncrt_tpu_torch.segments import SegmentStore

from conftest import synth_frames
from test_pipeline import read_clip, write_clip

PARAMS = dict(noise_strength=0.0, persistence=0.5, scanline_strength=0.5)  # the JAX test's
# persistence, native-rng grain (upsampled) and the glitch's native draws
BITS = dict(persistence=0.5, noise_strength=6.0, grain_size=2, scanline_strength=0.5,
            glitch_amp_px=3, glitch_height_frac=0.3)


def psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 10 * np.log10(255.0 ** 2 / max(mse, 1e-9))


def clip(tmp_path, n=24):
    frames = synth_frames(n, 48, 64, seed=7)
    return write_clip(tmp_path / "seg_in.mp4", frames), frames


class Capture:
    """Records the frames handed to every writer the port opens, per
    destination; a destination opened again starts over (a segment the
    resume renders anew)."""

    def __init__(self, monkeypatch):
        self.frames = {}
        real = tvio.open_writer

        def open_writer(dst, *a, **k):
            wtr, gpu = real(dst, *a, **k)
            rec = self.frames[str(dst)] = []

            class Rec:
                def write_frame(self, f):
                    rec.append(np.array(f))
                    wtr.write_frame(f)

                def close(self):
                    wtr.close()
            return Rec(), gpu
        monkeypatch.setattr(tvio, "open_writer", open_writer)

    def segments(self):
        return [self.frames[k] for k in sorted(self.frames) if ".segments/seg-" in k]

    def stream(self, keys):
        return np.stack([f for k in keys for f in self.frames[k]])


def test_segmented_render_matches_plain(tmp_path):
    path, frames = clip(tmp_path)
    p = EffectParams(**PARAMS)
    plain, seg = tmp_path / "plain.mp4", tmp_path / "seg.mp4"
    process_video(path, plain, p, batch_size=4, device="cpu", report=False)
    process_video(path, seg, p, batch_size=4, segment_frames=8, device="cpu", report=False)
    a, b = read_clip(plain), read_clip(seg)
    assert a.shape == b.shape == frames.shape
    assert psnr(a, b) > 30.0
    assert not (tmp_path / "seg.mp4.segments").exists()  # cleaned up


def test_crash_then_resume(tmp_path):
    path, frames = clip(tmp_path)
    p = EffectParams(**PARAMS)
    plain, seg = tmp_path / "plain2.mp4", tmp_path / "seg2.mp4"
    process_video(path, plain, p, batch_size=4, device="cpu", report=False)
    with pytest.raises(RuntimeError, match="injected failure"):
        process_video(path, seg, p, batch_size=4, segment_frames=8, device="cpu",
                      report=False, _fail_after_frames=16)
    segdir = tmp_path / "seg2.mp4.segments"
    assert segdir.exists() and not seg.exists()
    done = [json.loads(line) for line in (segdir / "journal.jsonl").read_text().splitlines()[1:]]
    assert len(done) >= 1 and done[0]["frames"] == 8
    assert (segdir / "state-00000.npy").exists()  # the carry: persistence is on
    process_video(path, seg, p, batch_size=4, segment_frames=8, device="cpu", report=False)
    got = read_clip(seg)
    assert got.shape == frames.shape and psnr(read_clip(plain), got) > 30.0


@pytest.mark.parametrize("decode_workers", [1, 2])
def test_resumed_frames_are_the_straight_render_bit_for_bit(tmp_path, monkeypatch,
                                                            decode_workers):
    """Crash after 16 frames, resume: the frames that reached the segment
    writers (the committed segments of the crashed run and the resumed
    run's) equal the straight render's, byte for byte. The carry comes
    from the snapshot, the rng streams from the absolute frame index, the
    decoder starts at the resume point (the parallel reader's chunks
    too)."""
    path, frames = clip(tmp_path)
    p = EffectParams(**BITS)
    cap = Capture(monkeypatch)
    plain, seg = tmp_path / "plain.mp4", tmp_path / "seg.mp4"
    kw = dict(batch_size=4, device="cpu", report=False, decode_workers=decode_workers)
    process_video(path, plain, p, **kw)
    want = cap.stream([str(plain)])
    with pytest.raises(RuntimeError, match="injected failure"):
        process_video(path, seg, p, segment_frames=8, _fail_after_frames=16, **kw)
    process_video(path, seg, p, segment_frames=8, **kw)
    segs = cap.segments()
    assert [len(s) for s in segs] == [8, 8, 8]
    np.testing.assert_array_equal(np.concatenate(segs), want)
    assert read_clip(seg).shape == frames.shape


def test_snapshot_is_the_state_after_the_segment(monkeypatch):
    """The journal's carry snapshot is the engine's state after the batch
    that closes the segment, in the engine's layout."""
    from pythoncrt_tpu_torch import CRTEngine

    frames = synth_frames(8, 48, 64, seed=3)
    eng = CRTEngine(EffectParams(**BITS), 48, 64, 24.0, device="cpu")
    _, st = eng.process(frames[:4], np.arange(4))
    _, st = eng.process(frames[4:], np.arange(4, 8), st)

    class Reader:
        out_h, out_w, i = 48, 64, 0

        def read_into(self, buf):
            if self.i >= 8:
                return False
            buf[...] = frames[self.i]
            self.i += 1
            return True

    class Store:
        def __init__(self):
            self.marks = []

        def seg_path(self, i):
            return f"/dev/null/seg-{i}"

        def mark_done(self, i, n, state):
            self.marks.append((i, n, state))

    store = Store()

    class Sink:
        def write_frame(self, f):
            pass

        def close(self):
            pass

    seg = tpipe.SegmentRun(store, 8, 0, 0, 64, 48, 24.0, {})
    monkeypatch.setattr(tvio, "open_writer", lambda *a, **k: (Sink(), False))
    n = tpipe.render_stream(Reader(), None, CRTEngine(EffectParams(**BITS), 48, 64, 24.0,
                                                      device="cpu"),
                            batch_size=4, segments=seg)
    assert n == 8 and [m[:2] for m in store.marks] == [(0, 8)]
    assert store.marks[0][2].shape == (48, 64, 3)
    np.testing.assert_array_equal(store.marks[0][2], st.numpy())


@pytest.mark.parametrize("change", ["params", "jax_journal", "native_stream"])
def test_changed_config_invalidates_journal(tmp_path, monkeypatch, change):
    """A journal whose signature differs starts afresh: other params, a
    journal the JAX package wrote (its native rng draws other numbers,
    and its signature names no implementation), or one whose signature
    names no native stream (a port that drew with per-frame generators)."""
    path, frames = clip(tmp_path, n=12)
    seg = tmp_path / "seg3.mp4"
    if change in ("params", "native_stream"):
        with pytest.raises(RuntimeError):
            process_video(path, seg, EffectParams(**PARAMS), batch_size=4,
                          segment_frames=4 if change == "native_stream" else 8,
                          device="cpu", report=False, _fail_after_frames=8)
        p = EffectParams(**{**PARAMS, "scanline_strength": 0.9})
        if change == "native_stream":
            journal = tmp_path / "seg3.mp4.segments" / "journal.jsonl"
            lines = journal.read_text().splitlines()
            head = json.loads(lines[0])
            assert head["sig"].pop("native_stream") == "philox4x32-10"
            journal.write_text("\n".join([json.dumps(head), *lines[1:]]) + "\n")
            p = EffectParams(**PARAMS)
    else:
        with pytest.raises(RuntimeError, match="injected failure"):
            jax_process_video(path, seg, JaxParams(**PARAMS), batch_size=4, segment_frames=4,
                              report=False, _fail_after_frames=8)
        head = json.loads((tmp_path / "seg3.mp4.segments" / "journal.jsonl")
                          .read_text().splitlines()[0])
        assert "impl" not in head["sig"] and (tmp_path / "seg3.mp4.segments"
                                              / "seg-00000.mp4").exists()
        p = EffectParams(**PARAMS)
    cap = Capture(monkeypatch)
    process_video(path, seg, p, batch_size=4, segment_frames=4, device="cpu", report=False)
    assert [len(s) for s in cap.segments()] == [4, 4, 4]  # segment 0 rendered again
    assert read_clip(seg).shape == frames.shape


def store(tmp_path, sig=None):
    return SegmentStore(tmp_path / "o.mp4", sig or {"k": 1})


def test_fresh_store_resumes_at_zero(tmp_path):
    assert store(tmp_path).resume() == (0, 0, None)


@pytest.mark.parametrize("damage", ["journal", "snapshot"])
def test_corrupt_journal_resets(tmp_path, damage):
    """A journal that is not JSON, or a truncated carry snapshot, starts
    the render afresh instead of failing or resuming a wrong carry."""
    st = store(tmp_path, sig={"params": {"persistence": 0.5}})
    st.resume()
    if damage == "journal":
        st.journal.write_text("not json\n")
    else:
        st.seg_path(0).write_bytes(b"x")
        st.mark_done(0, 8, np.zeros((2, 2, 3), np.float32))
        st._state_path(0).write_bytes(b"\x93NUMP")
    assert st.resume() == (0, 0, None)


def test_prefix_stops_at_missing_file(tmp_path):
    st = store(tmp_path)
    st.resume()
    st.seg_path(0).write_bytes(b"x")
    st.mark_done(0, 8, np.zeros((2, 2, 3), np.float32))
    st.mark_done(1, 8, None)  # journaled, but its file is missing
    nxt, skip, state = st.resume()
    assert (nxt, skip) == (1, 8) and state.shape == (2, 2, 3)


def test_segment_length_is_batch_aligned(tmp_path, monkeypatch):
    """--segment-frames 6 with batches of 4 writes segments of 8 frames
    (boundaries on batch ends), the tail shorter."""
    path, _ = clip(tmp_path, n=12)
    cap = Capture(monkeypatch)
    process_video(path, tmp_path / "o.mp4", EffectParams(**PARAMS), batch_size=4,
                  segment_frames=6, device="cpu", report=False)
    assert [len(s) for s in cap.segments()] == [8, 4]
