"""``--steps-per-call`` in the port on the CPU: super-batches through
``pipeline.render_stream`` and ``process_video`` (one host buffer of n
batches, ``process_stack`` on a full one, the ragged tail sliced into
batches), the lockstep collector of ``multiclip.process_videos``, the
manifest jobs, and ``process_stack`` of the three engines (one make_aux,
chunk i written into ``out[i]``). Every render at n > 1 hands the encoder
the bytes of the same render at n = 1 (the frames its writers were given,
compared byte for byte), and with host rng the port at n > 1 is within 1
LSB of the JAX package at the same n (tests/test_pipeline.py:553,
tests/test_multiclip.py:62). The auto rule is held to the JAX package's
(pythoncrt_tpu/pipeline.py:306-322), its notice word for word."""

import ast
import inspect
import json

import numpy as np
import pytest
import torch

from pythoncrt_tpu import EffectParams as JaxParams
from pythoncrt_tpu import multiclip as jmulticlip
from pythoncrt_tpu import pipeline as jpipe
from pythoncrt_tpu.io import video as jvio
from pythoncrt_tpu_torch import CRTEngine, EffectParams, MultiClipEngine
from pythoncrt_tpu_torch import multiclip as tmulticlip
from pythoncrt_tpu_torch import pipeline as tpipe
from pythoncrt_tpu_torch.batch import ClipJob, render_batch
from pythoncrt_tpu_torch.io import video as tvio
from pythoncrt_tpu_torch.parallel import DeviceMesh, ShardedCRTEngine

from conftest import synth_frames
from test_pipeline import write_clip

H, W, FPS = 48, 64, 24.0
# persistence, native-rng grain (upsampled) and the glitch's native draws
BITS = dict(persistence=0.6, noise_strength=6.0, grain_size=2, scanline_strength=0.5,
            glitch_amp_px=3, glitch_height_frac=0.3)
HOST = dict(persistence=0.6, noise_strength=0.0)  # the JAX tests' params
N_FRAMES = 15  # at B = 2: full super-batches, then a tail of one batch and one frame


def capture(monkeypatch, vio):
    """The frames handed to every writer ``vio`` opens, per destination."""
    got = {}
    real = vio.open_writer

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
    monkeypatch.setattr(vio, "open_writer", open_writer)
    return got


def count_stacks(monkeypatch, cls):
    """Record the n of every process_stack call of ``cls``."""
    calls = []
    real = cls.process_stack

    def spy(self, frames, idx, *a, **k):
        calls.append(int(np.asarray(idx).shape[0]))
        return real(self, frames, idx, *a, **k)
    monkeypatch.setattr(cls, "process_stack", spy)
    return calls


def lsb(a, b) -> int:
    return int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max())


@pytest.fixture
def clip(tmp_path):
    return write_clip(tmp_path / "in.mp4", synth_frames(N_FRAMES, H, W, seed=3))


@pytest.mark.parametrize("route", ["engine", "decode_workers_2", "sharded_cpu_shards"])
def test_process_video_steps_per_call_is_byte_equal(clip, tmp_path, monkeypatch, route):
    """process_video at n = 1, 2 and 3 (B = 2, 15 frames: full super-
    batches and a ragged tail) hands the encoder the same bytes; n > 1
    runs full super-batches through process_stack. ``sharded_cpu_shards``
    renders through a ShardedCRTEngine over 2 logical CPU shards
    (``sharding="auto"``): full batches on the runner, the tail's short
    batch on the engine, at every n."""
    kw = dict(batch_size=2, device="cpu", report=False)
    if route == "decode_workers_2":
        kw["decode_workers"] = 2
    cls = CRTEngine
    if route == "sharded_cpu_shards":
        cls = ShardedCRTEngine
        monkeypatch.setattr(tpipe, "frame_runner", lambda eng, sharding, devices, b:
                            ShardedCRTEngine(eng, DeviceMesh(["cpu"] * 2)))
    stacks = count_stacks(monkeypatch, cls)
    cap = capture(monkeypatch, tvio)
    got = {}
    for spc in (1, 2, 3):
        out = tmp_path / f"s{spc}.mp4"
        tpipe.process_video(clip, out, EffectParams(**BITS), steps_per_call=spc, **kw)
        got[spc] = np.stack(cap[str(out)])
    assert got[1].shape == (N_FRAMES, H, W, 3)
    np.testing.assert_array_equal(got[2], got[1])
    np.testing.assert_array_equal(got[3], got[1])
    assert stacks == [2, 2, 2, 3, 3]  # 12 frames of stacks at each n, the tails sliced


class ListReader:
    def __init__(self, frames):
        self.frames, self.i = frames, 0
        self.frame_shape = frames.shape[1:]
        self.out_h, self.out_w = H, W

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

    def write_frame(self, f):
        self.frames.append(np.array(f))

    def close(self):
        pass


@pytest.mark.parametrize("spc", [2, 3])
@pytest.mark.parametrize("layout", ["nhwc", "planar_gbr"])
def test_render_stream_super_batches(monkeypatch, layout, spc):
    """render_stream over in-memory frames in both layouts (planar gbr:
    the ffmpeg pipe's): n = 2 and 3 give the bytes of n = 1; full
    super-batches go through process_stack with out=None and the pool
    holds max(2, POOL // n) buffers of n * B frames per direction."""
    frames = synth_frames(N_FRAMES, H, W, seed=5)
    kw = {}
    if layout == "planar_gbr":
        frames = np.ascontiguousarray(np.transpose(frames, (0, 3, 1, 2))[:, [1, 2, 0]])
        kw = dict(layout="planar", channel_order="gbr")
    eng = CRTEngine(EffectParams(**BITS), H, W, FPS, device="cpu", **kw)
    stacks = count_stacks(monkeypatch, CRTEngine)
    want, got = ListWriter(), ListWriter()
    assert tpipe.render_stream(ListReader(frames), want, eng, batch_size=2) == N_FRAMES
    assert stacks == []
    assert tpipe.render_stream(ListReader(frames), got, eng, batch_size=2,
                               steps_per_call=spc) == N_FRAMES
    assert stacks == [spc] * (N_FRAMES // (2 * spc))
    np.testing.assert_array_equal(np.stack(got.frames), np.stack(want.frames))
    assert tpipe.host_pool(2, spc) == (2 * spc, 2) and tpipe.host_pool(16, 1) == (16, 4)
    assert tpipe.host_pool(16, 8) == (128, 2)


def test_render_stream_refuses_steps_with_segments():
    eng = CRTEngine(EffectParams(), H, W, FPS, device="cpu")
    with pytest.raises(ValueError, match="steps_per_call"):
        tpipe.render_stream(ListReader(synth_frames(2, H, W)), ListWriter(), eng,
                            steps_per_call=2, segments=object())


def test_steps_per_call_host_rng_matches_jax(tmp_path, monkeypatch):
    """The JAX pipeline test (tests/test_pipeline.py:553) on both packages:
    12 frames at batch 4 and steps per call 2 (one full super-batch, then
    a plain batch), host rng: the port's encoder frames within 1 LSB of
    the JAX package's, and byte-equal to the port's at 1."""
    src = write_clip(tmp_path / "in.mp4", synth_frames(12, H, W, seed=1))
    tcap, jcap = capture(monkeypatch, tvio), capture(monkeypatch, jvio)
    kw = dict(batch_size=4, rng="host", report=False)
    outs = {k: tmp_path / f"{k}.mp4" for k in ("t1", "t2", "j2")}
    tpipe.process_video(src, outs["t1"], EffectParams(**HOST), steps_per_call=1,
                        device="cpu", **kw)
    tpipe.process_video(src, outs["t2"], EffectParams(**HOST), steps_per_call=2,
                        device="cpu", **kw)
    jpipe.process_video(src, outs["j2"], JaxParams(**HOST), steps_per_call=2, **kw)
    t1, t2 = np.stack(tcap[str(outs["t1"])]), np.stack(tcap[str(outs["t2"])])
    j2 = np.stack(jcap[str(outs["j2"])])
    assert t2.shape == j2.shape == (12, H, W, 3)
    np.testing.assert_array_equal(t2, t1)
    assert lsb(t2, j2) <= 1


LENGTHS = (12, 8, 14)  # at B = 2 and n = 3: a round of stacks, then the ragged tails


@pytest.fixture
def clip_set(tmp_path):
    return [write_clip(tmp_path / f"c{i}.mp4", synth_frames(n, H, W, seed=10 + i))
            for i, n in enumerate(LENGTHS)]


def test_process_videos_steps_per_call(clip_set, tmp_path, monkeypatch):
    """process_videos at n = 1 and 3 on ragged clips (12, 8 and 14 frames
    at B = 2) hands every clip's encoder the same bytes (n = 3: a round
    of stacks, then a round per batch, clip 1 short, then clip 2's last
    two frames alone); with host rng the port at n = 3 is within 1 LSB of
    the JAX package at n = 3 (tests/test_multiclip.py:62)."""
    tcap, jcap = capture(monkeypatch, tvio), capture(monkeypatch, jvio)
    stacks = count_stacks(monkeypatch, MultiClipEngine)
    kw = dict(batch_size=2, report=False)
    outs = {}
    for tag, spc, rng in (("n1", 1, "native"), ("n3", 3, "native"), ("h3", 3, "host")):
        outs[tag] = [tmp_path / f"{tag}_{i}.mp4" for i in range(len(LENGTHS))]
        p = EffectParams(**BITS)
        res = tmulticlip.process_videos(clip_set, outs[tag], p, steps_per_call=spc, rng=rng,
                                        device="cpu", **kw)
        assert all(r.ok for r in res) and [r.frames for r in res] == list(LENGTHS)
    assert stacks == [3, 3]  # round 1 of the native and of the host render
    outs["j3"] = [tmp_path / f"j3_{i}.mp4" for i in range(len(LENGTHS))]
    res = jmulticlip.process_videos(clip_set, outs["j3"], JaxParams(**BITS), steps_per_call=3,
                                    rng="host", **kw)
    assert all(r.ok for r in res)
    for i, n in enumerate(LENGTHS):
        a, b = (np.stack(tcap[str(outs[t][i])]) for t in ("n1", "n3"))
        assert a.shape == (n, H, W, 3)
        np.testing.assert_array_equal(b, a)
        h3, j3 = np.stack(tcap[str(outs["h3"][i])]), np.stack(jcap[str(outs["j3"][i])])
        assert h3.shape == j3.shape and lsb(h3, j3) <= 1


def test_process_videos_stacks_run_and_tails_pad(tmp_path, monkeypatch):
    """Clips of 8, 12 and 5 frames at B = 2, n = 2: a round of stacks,
    a round per batch (clip 2 short), then a stack of clip 1 alone (the
    finished clips' slots padded); every clip's bytes are those of n =
    1."""
    lengths = (8, 12, 5)
    clips = [write_clip(tmp_path / f"r{i}.mp4", synth_frames(n, H, W, seed=20 + i))
             for i, n in enumerate(lengths)]
    cap = capture(monkeypatch, tvio)
    stacks = count_stacks(monkeypatch, MultiClipEngine)
    got = {}
    for spc in (1, 2):
        outs = [tmp_path / f"o{spc}_{i}.mp4" for i in range(3)]
        res = tmulticlip.process_videos(clips, outs, EffectParams(**BITS), batch_size=2,
                                        steps_per_call=spc, device="cpu", report=False)
        assert all(r.ok for r in res)
        got[spc] = [np.stack(cap[str(o)]) for o in outs]
    assert stacks == [2, 2]
    for a, b, n in zip(got[1], got[2], lengths):
        assert a.shape[0] == n
        np.testing.assert_array_equal(b, a)


def three_engines(layout, rng):
    kw = dict(layout="planar", channel_order="gbr") if layout == "planar_gbr" else {}
    eng = CRTEngine(EffectParams(**BITS), H, W, FPS, rng=rng, seed=4, device="cpu", **kw)
    return eng, ShardedCRTEngine(eng, DeviceMesh(["cpu"] * 2)), MultiClipEngine(eng)


def in_layout(x, layout):
    t = torch.as_tensor(x)
    return t if layout == "nhwc" else t.movedim(-1, -3)[..., [1, 2, 0], :, :].contiguous()


@pytest.mark.parametrize("rng", ["native", "host"])
@pytest.mark.parametrize("layout", ["nhwc", "planar_gbr"])
@pytest.mark.parametrize("which", ["crt", "sharded", "multiclip"])
def test_process_stack_with_out_is_the_process_loop(which, layout, rng):
    """process_stack(..., out=) of CRTEngine, ShardedCRTEngine (2 CPU
    shards) and MultiClipEngine (2 clips) writes chunk i into out[i] of
    the caller's tensor and returns that tensor, and its frames and
    state are bit for bit those of n process() calls, from a stream head
    and from a carried state."""
    eng, sh, mc = three_engines(layout, rng)
    run = {"crt": eng, "sharded": sh, "multiclip": mc}[which]
    n, b = 3, 4
    if which == "multiclip":
        x = in_layout(np.stack([synth_frames(n * b, H, W, seed=s) for s in (1, 2)]), layout)
        idx = np.stack([np.arange(n * b), np.arange(n * b) + 50])
        stack = x.reshape(2, n, b, *x.shape[2:]).transpose(0, 1).contiguous()
        sidx = idx.reshape(2, n, b).transpose(1, 0, 2)
    else:
        x = in_layout(synth_frames(n * b, H, W, seed=1), layout)
        idx = np.arange(n * b) + 7
        stack, sidx = x.reshape(n, b, *x.shape[1:]), idx.reshape(n, b)
    for st0 in (None, "carried"):
        if st0 is not None:
            _, st0 = run.process(stack[0], sidx[0])
        outs, st = [], st0
        for k in range(n):
            o, st = run.process(stack[k], sidx[k], st)
            outs.append(o)
        dst = torch.full(stack.shape, 7, dtype=torch.uint8)
        got, gst = run.process_stack(stack, sidx, st0, out=dst)
        assert got is dst
        assert torch.equal(got, torch.stack(outs)) and torch.equal(gst, st)


def test_process_stack_refuses_bad_shapes():
    eng, sh, mc = three_engines("nhwc", "native")
    x = torch.zeros((2, 4, H, W, 3), dtype=torch.uint8)
    for run in (eng, sh):
        with pytest.raises(ValueError, match="frame"):
            run.process_stack(x[0], np.arange(4))
        with pytest.raises(ValueError, match="frame_indices"):
            run.process_stack(x, np.arange(7))
        with pytest.raises(ValueError, match="out must be"):
            run.process_stack(x, np.arange(8).reshape(2, 4), out=torch.empty((1, 4, H, W, 3),
                                                                              dtype=torch.uint8))
    with pytest.raises(ValueError, match="frames"):
        mc.process_stack(x, np.arange(8))


def jax_notice() -> str:
    """The notice the JAX process_video prints under segments, read from
    its source (adjacent literals are one constant in the tree)."""
    for node in ast.walk(ast.parse(inspect.getsource(jpipe.process_video).lstrip())):
        if isinstance(node, ast.Call) and getattr(node.func, "id", "") == "print" \
                and isinstance(node.args[0], ast.Constant) \
                and "steps-per-call" in str(node.args[0].value):
            return node.args[0].value
    raise AssertionError("no steps-per-call notice in the JAX process_video")


@pytest.mark.parametrize("h, w, segmented, requested, want", [
    (1080, 1920, False, 0, 8), (1080, 1921, False, 0, 4), (2160, 3840, False, 0, 4),
    (48, 64, False, 0, 8), (1440, 1440, False, 0, 8), (1080, 1920, True, 0, 1),
    (2160, 3840, True, 0, 1), (48, 64, False, 3, 3), (2160, 3840, False, 1, 1),
    (48, 64, True, 1, 1), (48, 64, True, 4, 1), (2160, 3840, True, 2, 1),
    (48, 64, False, -1, 8),
])
def test_resolve_steps_per_call_is_the_jax_rule(capsys, h, w, segmented, requested, want):
    """The JAX package's rule (pythoncrt_tpu/pipeline.py:306-322): auto is
    8 at 1920x1080 pixels or fewer and 4 above, 1 under segments; an
    explicit request above 1 under segments is forced to 1 with the JAX
    package's notice, word for word."""
    assert tpipe.resolve_steps_per_call(h, w, segmented, requested) == want
    said = capsys.readouterr().out
    if segmented and requested > 1:
        assert said == jax_notice() + "\n"
    else:
        assert said == ""


def test_segment_resume_at_explicit_steps_is_the_straight_render(clip, tmp_path, monkeypatch,
                                                                  capsys):
    """--segment-frames with an explicit 4 steps per call (forced to 1,
    with the notice): crash after 8 frames, resume; the segments' frames
    are the straight render's at 4 steps per call, bit for bit."""
    cap = capture(monkeypatch, tvio)
    p = EffectParams(**BITS)
    kw = dict(batch_size=2, device="cpu", report=False, steps_per_call=4)
    plain, seg = tmp_path / "plain.mp4", tmp_path / "seg.mp4"
    tpipe.process_video(clip, plain, p, **kw)
    with pytest.raises(RuntimeError, match="injected failure"):
        tpipe.process_video(clip, seg, p, segment_frames=4, _fail_after_frames=8, **kw)
    tpipe.process_video(clip, seg, p, segment_frames=4, **kw)
    assert capsys.readouterr().out.count(jax_notice()) == 2
    segs = [cap[k] for k in sorted(cap) if ".segments/seg-" in k]
    assert [len(s) for s in segs] == [4, 4, 4, 3]
    np.testing.assert_array_equal(np.concatenate(segs), np.stack(cap[str(plain)]))


def test_manifest_steps_per_call_renders_the_same_bytes(clip_set, tmp_path, monkeypatch):
    """Manifest jobs carry steps_per_call into the render (no longer
    stripped): the lockstep group and a job rendered alone (a group of
    one) give the same bytes at 2 as at 1, and the journal signatures of
    the two differ."""
    cap = capture(monkeypatch, tvio)
    seen = []
    real = tmulticlip.process_videos

    def spy(*a, **k):
        seen.append(k["steps_per_call"])
        return real(*a, **k)
    monkeypatch.setattr(tmulticlip, "process_videos", spy)
    frames = {}
    for spc in (1, 2):
        jobs = [ClipJob(str(c), str(tmp_path / f"m{spc}_{i}.mp4"), EffectParams(**BITS),
                        kwargs=dict(batch_size=2, device="cpu", steps_per_call=spc))
                for i, c in enumerate(clip_set)]
        jobs[2].kwargs["assoc_scan"] = False  # outside the lockstep surface: rendered alone
        res = render_batch(jobs, journal=tmp_path / f"j{spc}.jsonl")
        assert all(r.ok for r in res)
        frames[spc] = [np.stack(cap[j.output_path]) for j in jobs]
    assert seen == [1, 2]
    for a, b, n in zip(frames[1], frames[2], LENGTHS):
        assert a.shape[0] == n
        np.testing.assert_array_equal(b, a)
    sigs = [json.loads(line)["sig"] for spc in (1, 2)
            for line in (tmp_path / f"j{spc}.jsonl").read_text().splitlines()]
    assert len(set(sigs)) == 4  # two signatures per run: the group's and the lone job's
