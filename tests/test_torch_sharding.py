"""The port's sharded engines (pythoncrt_tpu_torch.parallel) on the CPU,
over logical shards: ``DeviceMesh(["cpu"] * n)`` runs the per-shard
effects, the (A, b) carry rounds, the corrections and the gathers that a
mesh of cards runs, on the kernels' plain twins.

Against the JAX package's ShardedCRTEngine over its 8-device virtual CPU
mesh (tests/conftest.py) and MultiClipEngine over clip meshes of 2, 4 and
8, on the same frames with host rng so both draw the same noise; and
against the port's own single-device engine. Tolerances, those of the
JAX package's tests/test_sharding.py: 0 LSB without persistence; with
it, at most 1 LSB and the state within 1e-4 (the shard carry composes
the blend in another order than the sequential scan). The clip-sharded
engine is bit for bit the port's single-device one. Against the JAX
clip-sharded engine its uint8 frames differ only where XLA's FMA-contracted
blend (ROADMAP.md queue 3) rounds to the other side of a half, on the
same values as between the two single-device engines, and its per-clip
states by an ulp (held to 1e-6). Also: the device guard around every kernel launch
(stubbed CUDA), best_mesh_size against the JAX one, the sharding
decision of process_video, and process_video / render_stream / a segment
resume through a 4-shard runner with a ragged tail."""

import contextlib

import jax
import numpy as np
import pytest
import torch

from pythoncrt_tpu import CRTEngine as JaxEngine
from pythoncrt_tpu import EffectParams as JaxParams
from pythoncrt_tpu import multiclip as jmulticlip
from pythoncrt_tpu.parallel import MultiClipEngine as JaxMultiClip
from pythoncrt_tpu.parallel import ShardedCRTEngine as JaxSharded
from pythoncrt_tpu.parallel import make_mesh as jax_make_mesh
import pythoncrt_tpu_torch.parallel as tparallel
from pythoncrt_tpu_torch import CRTEngine, EffectParams
from pythoncrt_tpu_torch import multiclip as tmulticlip
from pythoncrt_tpu_torch import pipeline as tpipe
from pythoncrt_tpu_torch.kernels import _build
from pythoncrt_tpu_torch.parallel import (CLIP_AXIS, FRAME_AXIS, DeviceMesh, MultiClipEngine,
                                          ShardedCRTEngine, make_mesh)

from conftest import synth_frames
from test_pipeline import read_clip, write_clip
from test_torch_engine import C4, lsb

H, W, FPS = 48, 64, 24.0
CONFIGS = {  # the JAX tests' (test_sharding.py), plus c4 (glitch, grain, persistence 0.6)
    "stateless": dict(persistence=0.0, noise_strength=0.0),
    "p07": dict(persistence=0.7, noise_strength=0.0),
    "p09": dict(persistence=0.9, noise_strength=0.0),
    "p095": dict(persistence=0.95, noise_strength=0.0, scanline_strength=0.3),
    "c4": C4,
}
GBR = dict(layout="planar", channel_order="gbr")


def planar(x):
    """NHWC RGB frames as planar gbr."""
    return np.ascontiguousarray(np.moveaxis(x, -1, -3)[..., [1, 2, 0], :, :])


def two_batches(run, frames, b):
    """Two stateful batches of b frames through run.process."""
    o1, s = run.process(frames[:b], np.arange(b))
    o2, s = run.process(frames[b:2 * b], np.arange(b, 2 * b), s)
    return np.concatenate([np.asarray(o1), np.asarray(o2)]), np.asarray(s)


def assert_within(got, want, persist, what):
    mx, frac = lsb(got[0], want[0])
    if not persist:
        assert mx == 0, f"{what}: {mx} LSB on {frac:.2e} of values"
        return
    assert mx <= 1, f"{what}: {mx} LSB"
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-4, err_msg=what)


# ---- ShardedCRTEngine ------------------------------------------------------

@pytest.mark.parametrize("b", [8, 16])
@pytest.mark.parametrize("layout", ["nhwc", "planar_gbr"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_frame_sharding_matches_jax_and_single(name, layout, b):
    """8 logical shards, B = 8 (one frame a shard: the carry rounds do all
    the work) and 16, two batches with the state chained, host rng."""
    kw = GBR if layout == "planar_gbr" else {}
    frames = synth_frames(2 * b, H, W, seed=5)
    if kw:
        frames = planar(frames)
    p = CONFIGS[name]
    persist = p["persistence"] > 0
    eng = CRTEngine(EffectParams(**p), H, W, FPS, rng="host", device="cpu", **kw)
    sh = ShardedCRTEngine(eng, DeviceMesh(["cpu"] * 8))
    got = two_batches(sh, frames, b)
    assert got[0].shape == frames.shape and got[0].dtype == np.uint8
    assert_within(got, two_batches(eng, frames, b), persist, "vs the port's single device")
    jeng = JaxEngine(JaxParams(**p), H, W, FPS, rng="host", **kw)
    want = two_batches(JaxSharded(jeng, jax_make_mesh(8)), frames, b)
    assert_within(got, want, persist, "vs the JAX ShardedCRTEngine")


def test_frame_sharding_wider_frames_and_native_rng():
    """64x128, c4, 4 shards: host rng against the JAX sharded engine;
    native rng against the port's single-device engine (the draws are
    keyed by absolute frame index, so a shard draws what it would)."""
    h, w = 64, 128
    frames = synth_frames(16, h, w, seed=9)
    for rng in ("host", "native"):
        eng = CRTEngine(EffectParams(**C4), h, w, FPS, rng=rng, seed=3, device="cpu")
        got = two_batches(ShardedCRTEngine(eng, DeviceMesh(["cpu"] * 4)), frames, 8)
        assert_within(got, two_batches(eng, frames, 8), True, f"{rng} vs single")
        if rng == "host":
            jeng = JaxEngine(JaxParams(**C4), h, w, FPS, rng="host", seed=3)
            want = two_batches(JaxSharded(jeng, jax_make_mesh(4)), frames, 8)
            assert_within(got, want, True, "host vs JAX")


@pytest.mark.parametrize("name", ["p07", "stateless"])
def test_process_stack_is_sequential_calls(name):
    frames = synth_frames(16, H, W, seed=2)
    sh = ShardedCRTEngine(CRTEngine(EffectParams(**CONFIGS[name]), H, W, FPS, device="cpu"),
                          DeviceMesh(["cpu"] * 4))
    o1, s = sh.process(frames[:8], np.arange(8))
    o2, s = sh.process(frames[8:], np.arange(8, 16), s)
    om, sm = sh.process_stack(frames.reshape(2, 8, H, W, 3), np.arange(16).reshape(2, 8))
    assert torch.equal(om[0], o1) and torch.equal(om[1], o2) and torch.equal(sm, s)


def test_frame_sharding_rejects_bad_input():
    frames = synth_frames(16, H, W)
    mesh = DeviceMesh(["cpu"] * 8)
    sh = ShardedCRTEngine(CRTEngine(EffectParams(), H, W, FPS, device="cpu"), mesh)
    with pytest.raises(ValueError, match="not divisible"):
        sh.process(frames[:10])
    with pytest.raises(ValueError, match="layout"):
        sh.process(np.transpose(frames, (0, 3, 1, 2)))
    shp = ShardedCRTEngine(CRTEngine(EffectParams(persistence=0.5), H, W, FPS, device="cpu",
                                     layout="planar"), mesh)
    with pytest.raises(ValueError, match="layout"):
        shp.process(frames)
    with pytest.raises(ValueError, match="layout"):
        shp.process_stack(frames.reshape(2, 8, H, W, 3), np.arange(16).reshape(2, 8))
    with pytest.raises(ValueError, match="state shape"):
        sh.process(frames[:8], state=torch.zeros(3, H, W))


def test_shards_on_one_device_share_the_engine():
    """Logical shards on the engine's device use the engine itself (no
    table copies); a replica holds its own tables and computes the same."""
    eng = CRTEngine(EffectParams(**C4), H, W, FPS, device="cpu")
    sh = ShardedCRTEngine(eng, DeviceMesh(["cpu"] * 4))
    assert all(r is eng for r in sh._reps) and sh.mesh.axis == FRAME_AXIS
    rep = eng.replica("cpu")
    assert rep is not eng and rep.fused_tables is not eng.fused_tables
    frames = synth_frames(4, H, W, seed=1)
    a, sa = eng.process(frames)
    b, sb = rep.process(frames)
    assert torch.equal(a, b) and torch.equal(sa, sb)


@pytest.mark.parametrize("var, route", [("PCRT_BLOOM2_GAUSS", "bloom2"),
                                        ("PCRT_PALLAS_BLOOM", "stripe")])
def test_replica_keeps_the_engines_bloom_route(var, route, monkeypatch):
    """A bloom opt-in is read once, when the engine is built: a replica
    made after the variable is unset keeps the engine's stage-6 route and
    computes its outputs bit for bit."""
    params = EffectParams(**{**C4, "fast_bloom": False})
    monkeypatch.setenv(var, "1")
    eng = CRTEngine(params, H, W, FPS, rng="host", device="cpu")
    assert eng.bloom_route == route and eng._staged
    monkeypatch.delenv(var)
    assert CRTEngine(params, H, W, FPS, device="cpu").bloom_route == "fused"
    rep = eng.replica("cpu")
    assert (rep.bloom_route, rep._staged) == (eng.bloom_route, eng._staged)
    assert type(rep.bloom_spec) is type(eng.bloom_spec) and rep.fused_tables is not eng.fused_tables
    frames = synth_frames(4, H, W, seed=2)
    a, sa = eng.process(frames)
    b, sb = rep.process(frames)
    assert torch.equal(a, b) and torch.equal(sa, sb)


# ---- the clip axis -----------------------------------------------------------

@pytest.mark.parametrize("layout", ["nhwc", "planar_gbr"])
@pytest.mark.parametrize("n", [2, 4, 8])
def test_clip_sharding_matches_single_and_jax(n, layout):
    """8 clips x 8 frames in two steps, host rng, glitch, grain and
    persistence on."""
    kw = GBR if layout == "planar_gbr" else {}
    p = dict(persistence=0.5, noise_strength=6.0, glitch_amp_px=4, glitch_height_frac=0.4,
             scanline_speed_px_s=45.0)
    clips = np.stack([synth_frames(8, H, W, seed=80 + c) for c in range(8)])
    if kw:
        clips = planar(clips)
    idx = np.tile(np.arange(8), (8, 1)) + 8 * np.arange(8)[:, None]

    def steps(mc):
        o1, s = mc.process(clips[:, :4], idx[:, :4])
        o2, s = mc.process(clips[:, 4:], idx[:, 4:], s)
        return np.concatenate([np.asarray(o1), np.asarray(o2)], 1), np.asarray(s)

    eng = CRTEngine(EffectParams(**p), H, W, FPS, rng="host", device="cpu", **kw)
    mc = MultiClipEngine(eng, DeviceMesh(["cpu"] * n, CLIP_AXIS))
    got = steps(mc)
    single = steps(MultiClipEngine(eng))
    np.testing.assert_array_equal(got[0], single[0])
    np.testing.assert_array_equal(got[1], single[1])
    jeng = JaxEngine(JaxParams(**p), H, W, FPS, rng="host", **kw)
    want = steps(JaxMultiClip(jeng, jax_make_mesh(n, axis="clips")))
    want1 = steps(JaxMultiClip(jeng, jax_make_mesh(1, axis="clips")))
    # the uint8 frames are the JAX engine's but where its FMA-contracted
    # blend rounds to the other side of a half: 1 LSB there, and those
    # values are the same with one device or n, so sharding adds nothing
    mx, frac = lsb(got[0], want[0])
    assert mx <= 1 and frac < 1e-5, f"{mx} LSB on {frac:.2e} of values"
    np.testing.assert_array_equal(got[0] != want[0], single[0] != want1[0])
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-6)


def test_clip_sharding_rejects_indivisible_clips():
    mc = MultiClipEngine(CRTEngine(EffectParams(), H, W, FPS, device="cpu"),
                         DeviceMesh(["cpu"] * 4, CLIP_AXIS))
    with pytest.raises(ValueError, match="not divisible"):
        mc.process(np.zeros((6, 2, H, W, 3), np.uint8), np.zeros((6, 2)))


@pytest.mark.parametrize("visible", [0, 1, 2, 3, 4, 8])
def test_best_mesh_size_matches_jax(monkeypatch, visible):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: visible)
    monkeypatch.setattr(jax, "devices", lambda *a: [None] * visible)
    for c in range(1, 13):
        for devices in (0, 1, 2, 3, 5, 16):
            assert (tmulticlip.best_mesh_size(c, devices)
                    == jmulticlip.best_mesh_size(c, devices)), (c, devices, visible)


# ---- meshes and the render's sharding decision -------------------------------

def test_make_mesh(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    m = make_mesh()
    assert m.devices == (torch.device("cuda", 0), torch.device("cuda", 1))
    assert m.size == 2 and m.axis == FRAME_AXIS
    assert make_mesh(1, axis=CLIP_AXIS).devices == (torch.device("cuda", 0),)
    with pytest.raises(ValueError, match="requested 3 devices, have 2"):
        make_mesh(3)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(ValueError):
        make_mesh()


class FakeEngine:
    def __init__(self, device):
        self.device = torch.device(device)


@pytest.mark.parametrize("device, sharding, devices, batch, want", [
    ("cuda", "auto", 0, 8, 4),      # every visible card
    ("cuda", "auto", 2, 8, 2),      # --devices caps them
    ("cuda", "auto", 1, 8, 1),
    ("cuda", "auto", 0, 6, 1),      # 6 frames do not split over 4 cards
    ("cuda", "auto", 3, 6, 3),
    ("cuda", "none", 0, 8, 1),      # --sharding none
    ("cuda:1", "auto", 0, 8, 1),    # one card named
    ("cpu", "auto", 2, 8, 1),
])
def test_frame_runner_decision(monkeypatch, device, sharding, devices, batch, want):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    built = []
    monkeypatch.setattr(tparallel, "ShardedCRTEngine",
                        lambda eng, m: built.append(m.devices) or ("sharded", m.size))
    eng = FakeEngine(device)
    got = tpipe.frame_runner(eng, sharding, devices, batch)
    if want == 1:
        assert got is eng and not built
    else:
        assert got == ("sharded", want)
        assert built == [tuple(torch.device("cuda", i) for i in range(want))]


def test_frame_runner_refuses_unknown_sharding():
    with pytest.raises(ValueError, match="sharding"):
        tpipe.frame_runner(FakeEngine("cpu"), "ring", 0, 8)


# ---- the device guard at kernel launch -----------------------------------------

def test_launch_makes_the_operand_device_current(monkeypatch):
    """_build.launch enters torch.cuda.device(operand's device) around the
    C launcher and hands it that device's current stream."""
    import ctypes

    events = []

    class Lib:
        def crt_x_args_bytes(self):
            return ctypes.sizeof(ctypes.c_int)

        def crt_x_launch(self, args, stream):
            events.append(("launch", stream.value))
            return 0

    @contextlib.contextmanager
    def device(dev):
        events.append(("enter", dev))
        yield
        events.append(("exit", dev))

    class Stream:
        def __init__(self, dev):
            events.append(("stream", dev))
            self.cuda_stream = 7000 + dev.index

    monkeypatch.setattr(_build, "library", lambda: Lib())
    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(torch.cuda, "current_stream", Stream)
    dev = torch.device("cuda", 3)
    _build.launch("crt_x_launch", ctypes.c_int(0), dev)
    assert events == [("enter", dev), ("stream", dev), ("launch", 7003), ("exit", dev)]


# ---- the render through a sharded runner -----------------------------------------

def logical_runner(monkeypatch, n=4):
    """process_video's runner: a ShardedCRTEngine over n logical CPU
    shards, counting its calls."""
    calls = []

    def runner(eng, sharding, devices, batch_size):
        assert sharding == "auto"
        sh = ShardedCRTEngine(eng, DeviceMesh(["cpu"] * n))
        real = sh.process

        def process(x, idx, state):
            calls.append(x.shape[0])
            return real(x, idx, state)
        sh.process = process
        return sh
    monkeypatch.setattr(tpipe, "frame_runner", runner)
    return calls


def test_process_video_sharded_matches_single(tmp_path, monkeypatch):
    """The JAX package's pipeline test (test_sharding.py:278-301) on the
    port: 19 frames at B = 8 (two sharded batches and a ragged tail on
    the single-device engine), "auto" over a 4-shard runner against
    "none"; the decoded frames within 2 LSB."""
    frames = synth_frames(19, H, W, seed=21)
    src = write_clip(tmp_path / "in.mp4", frames)
    p = EffectParams(persistence=0.6, noise_strength=0.0)
    out_s, out_1 = tmp_path / "sharded.mp4", tmp_path / "single.mp4"
    tpipe.process_video(src, out_1, p, batch_size=8, sharding="none", device="cpu",
                        report=False)
    calls = logical_runner(monkeypatch)
    tpipe.process_video(src, out_s, p, batch_size=8, device="cpu", report=False)
    assert calls == [8, 8]
    a, b = read_clip(out_s), read_clip(out_1)
    assert a.shape == b.shape == frames.shape
    assert np.abs(a.astype(int) - b.astype(int)).max() <= 2


class ListReader:
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

    def write_frame(self, f):
        self.frames.append(np.array(f))

    def close(self):
        pass


def test_render_stream_runner_takes_full_batches():
    """In memory, native rng, c4: render_stream with a 4-shard runner
    against the single-device render, within 1 LSB; the tail batch (3
    frames) runs on the engine."""
    frames = synth_frames(19, H, W, seed=4)
    eng = CRTEngine(EffectParams(**C4), H, W, FPS, device="cpu")
    sh = ShardedCRTEngine(eng, DeviceMesh(["cpu"] * 4))
    seen = []
    real = sh.process
    sh.process = lambda x, idx, st: seen.append(len(idx)) or real(x, idx, st)
    w1, ws = ListWriter(), ListWriter()
    assert tpipe.render_stream(ListReader(frames), w1, eng, batch_size=8) == 19
    assert tpipe.render_stream(ListReader(frames), ws, eng, batch_size=8, runner=sh) == 19
    assert seen == [8, 8]
    mx, _ = lsb(np.stack(ws.frames), np.stack(w1.frames))
    assert mx <= 1


def test_segment_resume_through_the_sharded_runner(tmp_path, monkeypatch):
    """--segment-frames with the 4-shard runner: crash after 16 frames,
    resume; the frames that reached the segment writers equal the
    straight sharded render's bit for bit (the journal's carry is the
    runner's state)."""
    from test_torch_segments import BITS, Capture

    frames = synth_frames(24, H, W, seed=7)
    path = write_clip(tmp_path / "seg_in.mp4", frames)
    p = EffectParams(**BITS)
    logical_runner(monkeypatch)
    cap = Capture(monkeypatch)
    plain, seg = tmp_path / "plain.mp4", tmp_path / "seg.mp4"
    kw = dict(batch_size=4, device="cpu", report=False)
    tpipe.process_video(path, plain, p, **kw)
    want = cap.stream([str(plain)])
    with pytest.raises(RuntimeError, match="injected failure"):
        tpipe.process_video(path, seg, p, segment_frames=8, _fail_after_frames=16, **kw)
    tpipe.process_video(path, seg, p, segment_frames=8, **kw)
    segs = cap.segments()
    assert [len(s) for s in segs] == [8, 8, 8]
    np.testing.assert_array_equal(np.concatenate(segs), want)


@pytest.mark.parametrize("devices, want", [(0, 3), (2, 1), (4, 3)])
def test_process_videos_shards_clips_over_the_cards(tmp_path, monkeypatch, devices, want):
    """process_videos(devices=...) on "cuda" builds a clip mesh of
    best_mesh_size(C, devices) cards (stubbed: 4 visible cards, logical
    CPU shards in their place); 3 clips render as the unsharded group."""
    meshes = []
    monkeypatch.setattr(tparallel, "may_shard", lambda dev: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(tparallel, "make_mesh", lambda n, axis: meshes.append((n, axis))
                        or DeviceMesh(["cpu"] * n, axis))
    frames = synth_frames(3, H, W, seed=1)
    ins = [write_clip(tmp_path / f"in{i}.mp4", frames[::-1] if i % 2 else frames)
           for i in range(3)]
    kw = dict(batch_size=2, device="cpu", report=False)
    ones = [tmp_path / f"one{i}.mp4" for i in range(3)]
    res = tmulticlip.process_videos(ins, ones, EffectParams(**C4), devices=1, **kw)
    assert all(r.ok for r in res) and meshes == []
    outs = [tmp_path / f"o{i}.mp4" for i in range(3)]
    res = tmulticlip.process_videos(ins, outs, EffectParams(**C4), devices=devices, **kw)
    assert all(r.ok for r in res)
    assert meshes == ([(want, CLIP_AXIS)] if want > 1 else [])
    for a, b in zip(outs, ones):
        got, ref = read_clip(a), read_clip(b)
        assert got.shape == (3, H, W, 3)
        np.testing.assert_array_equal(got, ref)
