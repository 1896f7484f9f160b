"""The port's multi-clip batch render on the CPU (the kernels' plain
twins): the persistence kernel's multi-clip mode against the JAX kernel
in interpret mode and against per-clip scans, MultiClipEngine against
single-clip CRTEngine runs, against the benchmark's plain reference
(portbench/reference/) and against the JAX MultiClipEngine, the engine's
finish over clip-major states against per-clip finishes,
process_videos against sequential process_video renders, render_batch's
grouping, fallback and journal, and the --batch-manifest CLI.

Tolerances. The multi-clip twin is bitwise the per-clip sequential scan
(the same op order). Against the JAX kernel on the CPU, XLA contracts
p * s + (1 - p) * x into an FMA (ROADMAP.md queue 3): f32 values differ by
up to an ulp per frame (1e-6 here), the uint8 cast by at most 1 LSB.
MultiClipEngine equals C single-clip runs bit for bit, and the JAX
MultiClipEngine within 1 LSB (the same FMA delta, and the JAX Pallas
path's bf16 grain, ROADMAP.md queue 3)."""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pythoncrt_tpu import CRTEngine as JaxEngine
from pythoncrt_tpu import EffectParams as JaxParams
from pythoncrt_tpu.kernels import persist as jpersist
from pythoncrt_tpu.parallel import MultiClipEngine as JaxMultiClip
from pythoncrt_tpu.parallel import make_mesh
from pythoncrt_tpu_torch import CRTEngine, EffectParams, TextParams, cli
from pythoncrt_tpu_torch.batch import ClipJob, render_batch
from pythoncrt_tpu_torch.kernels import persist as tpersist
from pythoncrt_tpu_torch.multiclip import ClipRenderResult, process_videos
from pythoncrt_tpu_torch.parallel import MultiClipEngine
from pythoncrt_tpu_torch.pipeline import process_video

from conftest import synth_frames
from test_torch_engine import C4, lsb

cv2 = pytest.importorskip("cv2")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W, FPS = 48, 64, 24
LENGTHS = [6, 4, 7]


# ---- the persistence kernel's multi-clip mode -------------------------

@pytest.mark.parametrize("emit_u8", [False, True])
@pytest.mark.parametrize("first", [True, False])
def test_multiclip_twin_matches_jax_kernel(first, emit_u8):
    rng = np.random.default_rng(1)
    imgs = rng.random((6, 16, 128), dtype=np.float32)
    states = rng.random((3, 16, 128), dtype=np.float32)
    want, want_s = jpersist.persistence_scan(
        jnp.asarray(imgs), None, jnp.full((1,), first, jnp.bool_), 0.6, interpret=True,
        emit_u8=emit_u8, clip_states=jnp.asarray(states))
    got, got_s = tpersist.persistence_scan(torch.from_numpy(imgs), None, first, 0.6,
                                           emit_u8=emit_u8, clip_states=torch.from_numpy(states))
    assert got.dtype == (torch.uint8 if emit_u8 else torch.float32) and got_s.shape == (3, 16, 128)
    d = np.abs(got.numpy().astype(np.float64) - np.asarray(want).astype(np.float64))
    if emit_u8:
        assert d.max() <= 1 and (d > 0).mean() < 1e-3
    else:
        assert d.max() <= 1e-6
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=0, atol=1e-6)


@pytest.mark.parametrize("clips", [1, 2, 4])
@pytest.mark.parametrize("first", [True, False])
def test_multiclip_twin_is_per_clip_scans(first, clips):
    """Bitwise the sequential scan of each clip on its own, on an odd
    planar shape."""
    rng = np.random.default_rng(clips)
    imgs = torch.from_numpy(rng.random((4 * clips, 3, 5, 7), dtype=np.float32))
    states = torch.from_numpy(rng.random((clips, 3, 5, 7), dtype=np.float32))
    got, got_s = tpersist.persistence_scan(imgs, None, first, 0.35, emit_u8=True,
                                           clip_states=states)
    for c in range(clips):
        want, want_s = tpersist.persistence_scan(imgs[4 * c:4 * c + 4], states[c], first, 0.35,
                                                 emit_u8=True)
        assert torch.equal(got[4 * c:4 * c + 4], want) and torch.equal(got_s[c], want_s)


# ---- MultiClipEngine ----------------------------------------------------

TEXT_AFTER = TextParams(text="CH 5", size=12, after=True)
CONFIGS = {
    "c4": C4,
    "persistence_off": dict(persistence=0.0, noise_strength=3.0, glitch_amp_px=4,
                            glitch_height_frac=0.25),
    "angled_text_free": dict(persistence=0.5, scanline_angle=8.0, scanline_thickness=1.5),
    # the c5 batch render: c4's strengths, a caption after the effects
    "c5_text_after_2clips": dict(C4, text=TEXT_AFTER),
    "c5_text_after_3clips": dict(C4, text=TEXT_AFTER),
}


def planar(x):
    return np.ascontiguousarray(np.moveaxis(x, -1, -3)[..., [1, 2, 0], :, :])


def caption(h, w, seed=5):
    """(H, W, 4) uint8 RGBA drawn from the seed over a box inside the
    frame, clear elsewhere (the benchmark's overlay_for)."""
    ov = np.zeros((h, w, 4), np.uint8)
    box = ov[h // 6:h // 6 + h // 3, w // 8:w // 8 + w // 2]
    box[...] = np.random.default_rng(seed).integers(0, 256, box.shape, dtype=np.uint8)
    return ov


@pytest.mark.parametrize("rng", ["native", "host"])
@pytest.mark.parametrize("layout", ["nhwc", "planar_gbr"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_multiclip_engine_equals_single_clip_runs(name, layout, rng):
    """3 clips (2 where the case says so) x 4 frames, two steps, bit for
    bit the single-clip runs (outputs and carried states); rng streams
    keyed by frame index."""
    p = EffectParams(**CONFIGS[name])
    clips = 2 if name.endswith("_2clips") else 3
    kw = dict(layout="planar", channel_order="gbr") if layout == "planar_gbr" else {}
    if p.text.enabled:
        kw["text_rgba"] = caption(H, W)
    frames = np.stack([synth_frames(8, H, W, seed=30 + c) for c in range(clips)])
    if layout == "planar_gbr":
        frames = planar(frames)
    idx = np.tile(np.arange(8), (clips, 1)) + np.array([[0], [100], [0]])[:clips]
    mc = MultiClipEngine(CRTEngine(p, H, W, FPS, rng=rng, seed=2, device="cpu", **kw))
    assert mc.engine.text_route == ("after" if p.text.enabled else "none")
    o1, st = mc.process(frames[:, :4], idx[:, :4])
    o2, st = mc.process(frames[:, 4:], idx[:, 4:], st)
    assert o1.shape == (clips, 4, *frames.shape[2:]) and o1.dtype == torch.uint8
    for c in range(clips):
        eng = CRTEngine(p, H, W, FPS, rng=rng, seed=2, device="cpu", **kw)
        a, s = eng.process(frames[c, :4], idx[c, :4])
        b, s = eng.process(frames[c, 4:], idx[c, 4:], s)
        assert torch.equal(o1[c], a) and torch.equal(o2[c], b) and torch.equal(st[c], s), c


def test_multiclip_text_after_is_the_plain_reference():
    """The c5 configuration at 30x64 (c4's strengths, planar gbr, native
    draws, a caption after the effects), 2 clips x 4 frames over two steps
    of one process_stack call, against the benchmark's plain reference
    rendering each clip as a stream with the engine's seed: bit for bit."""
    from portbench.reference.chain import Chain
    from portbench.reference.compare import gaps, to_rgb

    h, w, seed = 30, 64, 2**31 + 17
    with open(os.path.join(REPO, "portbench", "configs", "c5_batch_4k.json")) as f:
        cfg = json.load(f)
    cfg = dict(cfg, height=h, width=w, params=dict(cfg["params"], text={
        "text": "PLAY", "size": 12, "after": True}))
    ov = caption(h, w)
    p = EffectParams(**{k: v for k, v in cfg["params"].items() if k != "text"},
                     text=TextParams(**cfg["params"]["text"]))
    mc = MultiClipEngine(CRTEngine(p, h, w, cfg["fps"], engine=cfg["engine"], rng=cfg["rng"],
                                   seed=seed, text_rgba=ov, layout=cfg["layout"],
                                   channel_order=cfg["channel_order"], device="cpu"))
    frames = planar(np.stack([synth_frames(8, h, w, seed=60 + c) for c in range(2)]))
    stack = np.ascontiguousarray(frames.reshape(2, 2, 4, 3, h, w).transpose(1, 0, 2, 3, 4, 5))
    idx = np.tile(np.arange(8).reshape(2, 1, 4), (1, 2, 1))
    outs, _ = mc.process_stack(stack, idx)
    chain = Chain(cfg, seed, "cpu", torch.float32, ov)
    for c in range(2):
        want, _ = chain.render(to_rgb(torch.from_numpy(frames[c]), cfg), np.arange(8), None)
        got = to_rgb(outs[:, c].reshape(8, 3, h, w), cfg)
        assert gaps(got, want) == (0, 0), c


@pytest.mark.parametrize("first", [True, False])
@pytest.mark.parametrize("route", ["kernel", "assoc_scan", "persistence_off",
                                   "persistence_off_u8"])
def test_finish_over_clip_major_states_is_per_clip_finishes(route, first):
    """CRTEngine._finish with a (C, 3, H, W) state (the multi-clip launch,
    or each clip on its own frames) equals _finish over each clip's
    frames with its own state: frames and states bit for bit."""
    p = EffectParams(persistence=0.0 if route.startswith("persistence_off") else 0.6)
    eng = CRTEngine(p, 5, 7, FPS, assoc_scan=route == "assoc_scan", layout="planar",
                    device="cpu")
    rng = np.random.default_rng(3)
    clips, b = 3, 4
    imgs = torch.from_numpy(rng.random((clips * b, 3, 5, 7), dtype=np.float32))
    if route == "persistence_off_u8":
        imgs = (imgs * 255).to(torch.uint8)
    states = torch.from_numpy(rng.random((clips, 3, 5, 7), dtype=np.float32))
    got, got_s = eng._finish(imgs, states, first)
    assert got.dtype == torch.uint8 and got.shape == imgs.shape and got_s.shape == states.shape
    for c in range(clips):
        want, want_s = eng._finish(imgs[c * b:(c + 1) * b], states[c], first)
        assert torch.equal(got[c * b:(c + 1) * b], want) and torch.equal(got_s[c], want_s), c


def test_multiclip_engine_assoc_scan_and_stack():
    """assoc_scan finishes each clip on its own; process_stack is n
    process() calls."""
    p = EffectParams(persistence=0.7)
    frames = np.stack([synth_frames(6, H, W, seed=c) for c in range(2)])
    idx = np.tile(np.arange(6), (2, 1))
    mc = MultiClipEngine(CRTEngine(p, H, W, FPS, assoc_scan=True, device="cpu"))
    outs, st = mc.process_stack(np.stack([frames[:, :3], frames[:, 3:]]),
                                np.stack([idx[:, :3], idx[:, 3:]]))
    for c in range(2):
        eng = CRTEngine(p, H, W, FPS, assoc_scan=True, device="cpu")
        a, s = eng.process(frames[c, :3], idx[c, :3])
        b, s = eng.process(frames[c, 3:], idx[c, 3:], s)
        assert torch.equal(outs[0, c], a) and torch.equal(outs[1, c], b)
        assert torch.equal(st[c], s)


def test_multiclip_engine_refuses_bad_shapes():
    mc = MultiClipEngine(CRTEngine(EffectParams(), H, W, FPS, device="cpu"))
    frames = np.zeros((2, 3, H, W, 3), np.uint8)
    with pytest.raises(ValueError):
        mc.process(frames[:, :, :, :-1], np.zeros((2, 3)))
    with pytest.raises(ValueError):
        mc.process(frames, np.zeros((2, 2)))
    with pytest.raises(ValueError):
        mc.process(frames, np.zeros((2, 3)), states=torch.zeros((3, H, W, 3)))


@pytest.mark.parametrize("layout", ["nhwc", "planar_gbr"])
def test_multiclip_engine_matches_jax(layout):
    """Against the JAX MultiClipEngine on a one-device mesh, its kernels
    in interpret mode (the multi-clip persistence kernel included), host
    rng, c4 params at 48x128, 3 clips x 4 frames over two steps."""
    h, w = 48, 128
    kw = dict(layout="planar", channel_order="gbr") if layout == "planar_gbr" else {}
    frames = np.stack([synth_frames(8, h, w, seed=40 + c) for c in range(3)])
    if kw:
        frames = planar(frames)
    idx = np.tile(np.arange(8), (3, 1))
    mine = MultiClipEngine(CRTEngine(EffectParams(**C4), h, w, FPS, rng="host", device="cpu",
                                     **kw))
    jeng = JaxEngine(JaxParams(**C4), h, w, FPS, rng="host", pallas="on", interpret=True, **kw)
    theirs = JaxMultiClip(jeng, make_mesh(1, axis="clips"))
    sm = sj = None
    for k in range(2):
        sl = slice(4 * k, 4 * k + 4)
        got, sm = mine.process(frames[:, sl], idx[:, sl], sm)
        want, sj = theirs.process(frames[:, sl], idx[:, sl], sj)
        mx, frac = lsb(got.numpy(), np.asarray(want))
        assert mx <= 1 and frac < 1e-3, f"step {k}: max {mx} LSB, {frac:.2e} off"
    np.testing.assert_allclose(sm.numpy(), np.asarray(sj), rtol=0, atol=1e-5)


# ---- process_videos, render_batch, the CLI -------------------------------

def write_clip(path, frames, fps=FPS):
    wr = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), fps,
                         (frames.shape[2], frames.shape[1]))
    for f in frames:
        wr.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
    wr.release()
    return path


def read_clip(path):
    cap = cv2.VideoCapture(str(path))
    frames = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        frames.append(f)
    cap.release()
    return np.stack(frames) if frames else np.zeros((0,))


@pytest.fixture
def clip_set(tmp_path):
    """Tiny clips of different lengths (ragged lockstep tails)."""
    return [write_clip(tmp_path / f"in{i}.mp4", synth_frames(n, H, W, seed=100 + i))
            for i, n in enumerate(LENGTHS)]


def params():
    # persistence exercises the per-clip carries, native-rng noise the
    # frame-index-keyed streams, the glitch its own draws
    return EffectParams(persistence=0.6, noise_strength=3.0, scanline_strength=0.5,
                        vignette_strength=0.2, glitch_amp_px=3, glitch_height_frac=0.3)


def test_process_videos_matches_sequential_renders(clip_set, tmp_path):
    outs = [tmp_path / f"mc{i}.mp4" for i in range(len(clip_set))]
    res = process_videos(clip_set, outs, params(), batch_size=3, device="cpu", report=False)
    assert all(r.ok for r in res), [r.error for r in res]
    assert [r.frames for r in res] == LENGTHS
    for i, src in enumerate(clip_set):
        ref = tmp_path / f"seq{i}.mp4"
        process_video(src, ref, params(), batch_size=3, device="cpu", report=False)
        a, b = read_clip(outs[i]), read_clip(ref)
        assert a.shape == (LENGTHS[i], H, W, 3)
        np.testing.assert_array_equal(a, b)


def test_process_videos_bad_clips_fail_alone(clip_set, tmp_path, monkeypatch):
    """A missing input, an unwritable output and a reader that fails to
    open each fail their clip; the others render every frame, and the
    clip whose reader failed leaves no output file."""
    import pythoncrt_tpu_torch.multiclip as mc

    blocker = tmp_path / "blocker"
    blocker.write_text("not a directory")
    ins = [clip_set[0], tmp_path / "missing.mp4", clip_set[1], clip_set[2], clip_set[0]]
    outs = [tmp_path / "b0.mp4", tmp_path / "b1.mp4", blocker / "sub" / "b2.mp4",
            tmp_path / "b3.mp4", tmp_path / "b4.mp4"]
    real_open = mc.vio.open_reader

    def flaky(path, *a, **k):
        if str(path) == str(clip_set[2]):
            raise RuntimeError("injected codec failure")
        return real_open(path, *a, **k)

    monkeypatch.setattr(mc.vio, "open_reader", flaky)
    res = process_videos(ins, outs, params(), batch_size=4, device="cpu", report=False)
    assert [r.ok for r in res] == [True, False, False, False, True]
    assert "probe" in res[1].error and res[2].error and "open reader" in res[3].error
    assert not outs[3].exists()
    assert read_clip(outs[0]).shape[0] == LENGTHS[0] == read_clip(outs[4]).shape[0]


def test_process_videos_refusals(clip_set, tmp_path):
    """yuv420p and precision fast render in lockstep now (yuv420p takes
    the OpenCV tier without an ffmpeg binary); an unknown pipe format and
    clips of different sizes without an explicit size are refused."""
    outs = [tmp_path / "r0.mp4", tmp_path / "r1.mp4"]
    for kw in (dict(pipe_format="yuv420p"), dict(precision="fast")):
        res = process_videos(clip_set[:2], outs, params(), batch_size=4, device="cpu",
                             report=False, **kw)
        assert all(r.ok for r in res), [r.error for r in res]
        assert [read_clip(o).shape[0] for o in outs] == list(LENGTHS[:2])
    with pytest.raises(ValueError, match="pipe_format"):
        process_videos(clip_set[:2], outs, params(), device="cpu", report=False,
                       pipe_format="gbrp")
    b = write_clip(tmp_path / "b.mp4", synth_frames(3, 32, 48))
    with pytest.raises(ValueError, match="sizes differ"):
        process_videos([clip_set[0], b], outs, params(), device="cpu", report=False)
    res = process_videos([clip_set[0], b], outs, params(), width=W, height=H, device="cpu",
                         report=False)
    assert all(r.ok for r in res) and read_clip(outs[1]).shape == (3, H, W, 3)


# passed on, as the CLI's jobs carry them: process_video and process_videos
# shard across the cards and run steps_per_call batches per device call
CARRIED = {"devices": 0, "steps_per_call": 0}


def fake_group(calls, bad=()):
    def run(ins, outs, p, **kw):
        assert kw.items() >= CARRIED.items()
        calls.append(("group", len(ins), kw.get("device")))
        return [ClipRenderResult(str(i), str(o), ok=k not in bad, frames=1,
                                 error="decode: x" if k in bad else "")
                for k, (i, o) in enumerate(zip(ins, outs))]
    return run


def jobs_for(paths, tmp_path, **kwargs):
    return [ClipJob(str(s), str(tmp_path / f"j{i}.mp4"), params(), kwargs=dict(kwargs))
            for i, s in enumerate(paths)]


@pytest.mark.parametrize("case", ["homogeneous", "group_fails", "clip_fails", "heterogeneous",
                                  "devices_differ", "wrong_length"])
def test_render_batch_grouping_and_fallback(clip_set, tmp_path, case):
    calls = []

    def single(inp, outp, p, **kw):
        assert kw.items() >= CARRIED.items()
        calls.append(("single", str(inp)))

    group = fake_group(calls)
    cli_kw = dict(device="cpu", devices=0, steps_per_call=0)  # as the CLI's jobs carry them
    jobs = jobs_for(clip_set, tmp_path, **cli_kw)
    if case == "group_fails":
        def group(*a, **k):
            raise RuntimeError("boom")
    elif case == "clip_fails":
        group = fake_group(calls, bad={1})
    elif case == "heterogeneous":
        jobs = jobs_for(clip_set, tmp_path, **cli_kw, assoc_scan=True)
    elif case == "devices_differ":
        jobs[0].kwargs["device"] = "cuda:1"
    elif case == "wrong_length":
        def group(ins, outs, p, **kw):
            calls.append(("group", len(ins), kw.get("device")))
            return []
    res = render_batch(jobs, process_fn=single, process_videos_fn=group)
    assert all(r.ok for r in res)
    want = {
        "homogeneous": [("group", 3, "cpu")],
        "group_fails": [("single", str(s)) for s in clip_set],
        "clip_fails": [("group", 3, "cpu"), ("single", str(clip_set[1]))],
        "heterogeneous": [("single", str(s)) for s in clip_set],
        "devices_differ": [("single", str(clip_set[0])), ("group", 2, "cpu")],
        "wrong_length": [("group", 3, "cpu")] + [("single", str(s)) for s in clip_set],
    }[case]
    assert sorted(calls, key=str) == sorted(want, key=str)


def test_render_batch_journal_resume(clip_set, tmp_path):
    journal = tmp_path / "j.jsonl"
    jobs = jobs_for(clip_set, tmp_path)
    res1 = render_batch(jobs, journal=journal, process_fn=lambda *a, **k: None, sharded=False)
    assert all(r.ok and not r.skipped for r in res1)
    res2 = render_batch(jobs, journal=journal, process_fn=lambda *a, **k: None, sharded=False)
    assert all(r.skipped for r in res2)
    changed = [ClipJob(j.input_path, j.output_path, EffectParams(persistence=0.1))
               for j in jobs]
    res3 = render_batch(changed, journal=journal, process_fn=lambda *a, **k: None,
                        sharded=False)
    assert not any(r.skipped for r in res3)


def manifest(tmp_path, jobs, name="jobs.json"):
    path = tmp_path / name
    path.write_text(json.dumps(jobs))
    return path


FLAGS = ["--persistence", "0.6", "--noise-strength", "3.0", "--glitch-amp", "3",
         "--glitch-height", "0.3", "--batch-size", "3", "--device", "cpu"]


def test_manifest_renders_and_resumes(clip_set, tmp_path, capsys):
    """Through cli.main: every clip's frames, bit for bit the single-clip
    CLI render, then a re-run resumes both from the journal."""
    m = manifest(tmp_path, [{"input": str(s), "output": str(tmp_path / f"cli{i}.mp4")}
                            for i, s in enumerate(clip_set[:2])])
    assert cli.main(["--batch-manifest", str(m), *FLAGS]) == 0
    assert "2/2 clips ok (0 resumed)" in capsys.readouterr().out
    assert cli.main(["--input", str(clip_set[1]), "--output", str(tmp_path / "one.mp4"),
                     *FLAGS]) == 0
    np.testing.assert_array_equal(read_clip(tmp_path / "cli1.mp4"),
                                  read_clip(tmp_path / "one.mp4"))
    assert read_clip(tmp_path / "cli0.mp4").shape[0] == LENGTHS[0]
    assert (tmp_path / "jobs.json.journal.jsonl").exists()
    assert cli.main(["--batch-manifest", str(m), *FLAGS]) == 0
    assert "2/2 clips ok (2 resumed)" in capsys.readouterr().out


def test_manifest_exit_codes(clip_set, tmp_path, capsys):
    """2 for a manifest that cannot be read or has a bad job, 5 when a
    clip failed (the others still render)."""
    dev = ["--device", "cpu"]
    assert cli.main(["--batch-manifest", str(tmp_path / "absent.json"), *dev]) == 2
    assert cli.main(["--batch-manifest", str(manifest(tmp_path, {}, "e.json")), *dev]) == 2
    bad = manifest(tmp_path, [{"input": "a.mp4", "width": "1920px"}], "w.json")
    assert cli.main(["--batch-manifest", str(bad), *dev]) == 2
    assert "manifest job 0" in capsys.readouterr().err
    bp = manifest(tmp_path, [{"input": str(clip_set[0]), "preset": str(tmp_path / "no.json")}],
                  "bp.json")
    assert cli.main(["--batch-manifest", str(bp), *dev]) == 2
    m = tmp_path / "m.json"
    m.write_text(json.dumps({"jobs": [
        {"input": str(clip_set[0]), "output": str(tmp_path / "m0.mp4")},
        {"input": str(tmp_path / "nope.mp4"), "output": str(tmp_path / "m1.mp4")}]}))
    capsys.readouterr()
    assert cli.main(["--batch-manifest", str(m), "--batch-retries", "0",
                     "--batch-journal", "none", *FLAGS]) == 5
    assert "1/2 clips ok" in capsys.readouterr().out
    assert read_clip(tmp_path / "m0.mp4").shape[0] == LENGTHS[0]
    assert not (tmp_path / "m.json.journal.jsonl").exists()


def test_manifest_per_job_preset(clip_set, tmp_path, capsys):
    """A job's preset replaces --preset as its base: that job decodes
    equal to a single-clip --preset render and differs from its plain
    sibling."""
    preset = tmp_path / "heavy.json"
    preset.write_text(json.dumps({"persistence": 0.7, "vignette": 0.8, "scanline": 0.4}))
    m = manifest(tmp_path, [
        {"input": str(clip_set[0]), "output": str(tmp_path / "plain.mp4")},
        {"input": str(clip_set[0]), "output": str(tmp_path / "heavy.mp4"), "preset": str(preset)},
    ])
    flags = ["--noise-strength", "0", "--batch-size", "4", "--device", "cpu"]
    assert cli.main(["--batch-manifest", str(m), "--batch-journal", "none", *flags]) == 0
    assert cli.main(["--input", str(clip_set[0]), "--output", str(tmp_path / "single.mp4"),
                     "--preset", str(preset), *flags]) == 0
    capsys.readouterr()
    heavy = read_clip(tmp_path / "heavy.mp4")
    np.testing.assert_array_equal(heavy, read_clip(tmp_path / "single.mp4"))
    assert np.abs(heavy.astype(int) - read_clip(tmp_path / "plain.mp4").astype(int)).max() > 4


def test_manifest_render_imports_no_jax(clip_set, tmp_path):
    m = manifest(tmp_path, [{"input": str(s), "output": str(tmp_path / f"f{i}.mp4")}
                            for i, s in enumerate(clip_set)])
    code = ("import sys, pythoncrt_tpu_torch.cli as c; "
            f"rc = c.main(['--batch-manifest', {str(m)!r}, '--device', 'cpu', "
            "'--batch-size', '4', '--persistence', '0.5']); "
            "bad = sorted(x for x in sys.modules if x.split('.')[0] in ('jax', 'pythoncrt_tpu')); "
            "print('rc', rc, 'loaded', bad); sys.exit(rc or (1 if bad else 0))")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "rc 0 loaded []" in res.stdout and "3/3 clips ok" in res.stdout
    assert [read_clip(tmp_path / f"f{i}.mp4").shape[0] for i in range(3)] == LENGTHS
