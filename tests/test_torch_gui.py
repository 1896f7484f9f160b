"""The Qt-free core of the port's GUI (pythoncrt_tpu_torch.gui_qt:
PreviewReader, _preview_size, the preview-engine LRU,
render_preview_frame, EFFECT_CONTROLS, run_render_job) against the JAX
package's (pythoncrt_tpu.gui_qt), on the CPU.

Contract: the engine preview (the port's CRTEngine on device "cpu", the
kernels' plain twins) is within 1 uint8 LSB of the JAX preview's oracle
path (use_engine=False) on six configurations at odd sizes, stateless
and stateful over three ticks; the LRU keeps the JAX semantics; an
engine failure raises (no oracle fallback, no negative cache)."""

import dataclasses

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from pythoncrt_tpu import gui_qt as jgui  # noqa: E402
from pythoncrt_tpu import params as jparams  # noqa: E402
from pythoncrt_tpu_torch import EffectParams, TextParams, gui_qt  # noqa: E402

from conftest import synth_frames  # noqa: E402
from test_fused import FULL  # noqa: E402

C4 = dict(scanline_strength=0.6, triad_strength=0.35, aberration_px=1, bloom_strength=0.25,
          fast_bloom=True, noise_strength=1.5, vignette_strength=0.25, persistence=0.6,
          pixel_size=1, glitch_amp_px=6, glitch_height_frac=0.3, scanline_speed_px_s=120.0)
CONFIGS = {  # name -> (EffectParams kwargs, text kwargs or None)
    "defaults": ({}, None),
    "c3": (FULL, None),
    "c4": (C4, None),
    "c3_angled": (dict(FULL, scanline_angle=5.0, scanline_thickness=1.5),
                  dict(text="CH 3", size=12, after=True)),
    "defaults_angled": (dict(scanline_angle=12.0, scanline_thickness=2.0), None),
    "c4_text": (C4, dict(text="PLAY", size=12, after=False)),
}


def params_pair(name):
    kw, text = CONFIGS[name]
    if text is not None:
        pytest.importorskip("PIL")
        return (EffectParams(**kw, text=TextParams(**text)).clamped(),
                jparams.EffectParams(**kw, text=jparams.TextParams(**text)).clamped())
    return EffectParams(**kw).clamped(), jparams.EffectParams(**kw).clamped()


def lsb(a, b):
    d = np.abs(a.astype(np.int32) - b.astype(np.int32))
    return int(d.max()), float((d > 0).mean())


@pytest.fixture(autouse=True)
def fresh_cache(monkeypatch):
    monkeypatch.delenv("PCRT_PREVIEW_ENGINE", raising=False)
    gui_qt._PREVIEW_ENGINES.clear()
    yield
    gui_qt._PREVIEW_ENGINES.clear()


def no_oracle(monkeypatch):
    """Make any oracle render inside the port's preview fail, so that a
    pass shows the engine rendered."""
    def refuse(*a, **k):
        raise AssertionError("the engine preview rendered through the oracle")

    monkeypatch.setattr(gui_qt.oracle, "apply_effects", refuse)


class TestPreviewSize:
    @pytest.mark.parametrize("w,h", [(320, 240), (3840, 2160), (1920, 1080), (1280, 720),
                                     (0, 0), (961, 541), (5000, 100), (67, 45)])
    def test_matches_jax(self, w, h):
        assert gui_qt._preview_size(w, h) == jgui._preview_size(w, h)
        assert (gui_qt.PREVIEW_MAX_W, gui_qt.PREVIEW_MAX_H) == (960, 540)

    def test_bounds(self):
        assert gui_qt._preview_size(1920, 1080) == (960, 540)
        assert gui_qt._preview_size(1280, 720) == (960, 540)  # 16:9 fits exactly
        assert gui_qt._preview_size(853, 480) == (853, 480)  # inside: untouched
        assert gui_qt._preview_size(1925, 1083) == (959, 540)
        assert gui_qt._preview_size(0, 0) == (1, 1)


class TestRenderPreviewFrame:
    @pytest.mark.parametrize("hw", [(45, 67), (33, 130)], ids=["45x67", "33x130"])
    @pytest.mark.parametrize("name", sorted(CONFIGS))
    def test_stateless_within_1_lsb_of_jax_oracle(self, name, hw, monkeypatch):
        p, jp = params_pair(name)
        frame = synth_frames(4, *hw, seed=21)[3]
        ref, ref_state = jgui.render_preview_frame(frame, jp, t=0.7, use_engine=False)
        no_oracle(monkeypatch)
        got, state = gui_qt.render_preview_frame(frame, p, t=0.7, device="cpu")
        assert got.shape == ref.shape == (*hw, 3) and got.dtype == np.uint8
        assert state is None and ref_state is None
        mx, frac = lsb(got, ref)
        assert mx <= 1 and frac < 1e-2, f"max {mx} LSB, {frac:.2e} off"

    @pytest.mark.parametrize("name", sorted(CONFIGS))
    def test_stateful_three_ticks_within_1_lsb(self, name, monkeypatch):
        """Three ticks with the persistence state carried on the host:
        the engine's uint8 output is blended (the preview-only deviation,
        which puts up to 0.5 LSB into every blended value, so the share
        of values 1 LSB off is not bounded here) and each tick stays
        within 1 LSB of the JAX oracle chain."""
        p, jp = params_pair(name)
        frames = synth_frames(3, 45, 67, seed=22)
        times = (0.0, 1 / 24.0, 2 / 24.0)
        refs, st = [], None
        for f, t in zip(frames, times):
            out, st = jgui.render_preview_frame(f, jp, t=t, prev_img=st, stateful=True,
                                                use_engine=False)
            refs.append(out)
        no_oracle(monkeypatch)
        st = None
        for f, t, ref in zip(frames, times, refs):
            out, st = gui_qt.render_preview_frame(f, p, t=t, prev_img=st, stateful=True,
                                                  device="cpu")
            assert st is not None and st.shape == (45, 67, 3) and st.dtype == np.float32
            mx, frac = lsb(out, ref)
            assert mx <= 1, f"t={t}: max {mx} LSB, {frac:.2e} off"

    def test_stateful_persistence_chains(self):
        frames = synth_frames(2, 48, 64, seed=8)
        p = EffectParams(noise_strength=0.0, persistence=0.6)
        _, s0 = gui_qt.render_preview_frame(frames[0], p, t=0.0, stateful=True, device="cpu")
        out1, _ = gui_qt.render_preview_frame(frames[1], p, t=1 / 24.0, prev_img=s0,
                                              stateful=True, device="cpu")
        free, _ = gui_qt.render_preview_frame(frames[1], p, t=1 / 24.0, device="cpu")
        assert not np.array_equal(out1, free)

    def test_state_at_persistence_zero_is_the_frame(self):
        frame = synth_frames(1, 48, 64, seed=9)[0]
        p = EffectParams(noise_strength=0.0, persistence=0.0)
        out, s = gui_qt.render_preview_frame(frame, p, t=0.0, prev_img=None, stateful=True,
                                             device="cpu")
        np.testing.assert_array_equal(np.round(s * 255).astype(np.uint8), out)

    def test_unblended_tick_shows_the_engines_frame(self):
        frame = synth_frames(1, 45, 67, seed=10)[0]
        p, _ = params_pair("c3")
        eng = gui_qt._get_preview_engine(p, 67, 45, "cpu")
        noise = np.random.default_rng(300).standard_normal(
            (45 // p.grain_size, 67 // p.grain_size), dtype=np.float32)
        want, _ = eng.process_at(frame[None], np.asarray([0.3]), noise[None])
        free, none = gui_qt.render_preview_frame(frame, p, t=0.3, device="cpu")
        held, s = gui_qt.render_preview_frame(frame, p, t=0.3, stateful=True, device="cpu")
        assert none is None and free.dtype == np.uint8
        np.testing.assert_array_equal(free, want[0].numpy())
        np.testing.assert_array_equal(held, free)
        np.testing.assert_array_equal(s, free.astype(np.float32) / 255.0)

    @pytest.mark.parametrize("persistence, steps", [
        (0.0, ["fit", "grain", "engine", "d2h"]),
        (0.6, ["fit", "grain", "engine", "d2h", "blend", "to_uint8"])])
    def test_steps_are_profiler_ranges(self, persistence, steps):
        from torch.profiler import ProfilerActivity, profile

        frame = synth_frames(1, 45, 67, seed=11)[0]
        p = EffectParams(persistence=persistence)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            gui_qt.render_preview_frame(frame, p, t=0.2, stateful=True, device="cpu")
        seen = [e.name[len("preview."):] for e in prof.events() if e.name.startswith("preview.")]
        assert seen == steps

    def test_mismatched_prev_state_is_resized(self):
        frame = synth_frames(1, 48, 64, seed=9)[0]
        p = EffectParams(noise_strength=0.0, persistence=0.6)
        bad_prev = np.full((24, 32, 3), 0.5, np.float32)
        out, s = gui_qt.render_preview_frame(frame, p, t=0.0, prev_img=bad_prev,
                                             stateful=True, device="cpu")
        assert s.shape == (48, 64, 3)
        free, _ = gui_qt.render_preview_frame(frame, p, t=0.0, device="cpu")
        assert not np.array_equal(out, free)  # blended with the resized carry

    def test_downscales_large_frames(self):
        frame = np.zeros((1083, 1925, 3), np.uint8)
        p = EffectParams(noise_strength=0.0, persistence=0.0)
        out, _ = gui_qt.render_preview_frame(frame, p, t=0.0, device="cpu")
        assert out.shape == (540, 959, 3)
        assert out.shape[:2][::-1] == jgui._preview_size(1925, 1083)

    def test_env_zero_selects_the_oracle(self, monkeypatch):
        frame = synth_frames(1, 45, 67, seed=23)[0]
        p, jp = params_pair("c4")
        monkeypatch.setenv("PCRT_PREVIEW_ENGINE", "0")
        got, _ = gui_qt.render_preview_frame(frame, p, t=0.4, device="no-such-device")
        ref, _ = jgui.render_preview_frame(frame, jp, t=0.4, use_engine=False)
        np.testing.assert_array_equal(got, ref)  # the same NumPy oracle, bit for bit
        assert not gui_qt._PREVIEW_ENGINES


class TestPreviewEngineCache:
    def test_reuses_and_evicts(self):
        p = EffectParams(noise_strength=0.0, persistence=0.0)
        e1 = gui_qt._get_preview_engine(p, 64, 48, "cpu")
        assert gui_qt._get_preview_engine(p, 64, 48, "cpu") is e1
        assert e1.engine == "preview" and e1.rng == "host" and e1.fps == 30.0
        assert (e1.h, e1.w, e1.device.type) == (48, 64, "cpu")
        for i in range(gui_qt._PREVIEW_ENGINES_MAX):
            gui_qt._get_preview_engine(
                EffectParams(scanline_strength=0.1 * (i + 1), noise_strength=0.0), 64, 48,
                "cpu")
        assert len(gui_qt._PREVIEW_ENGINES) == gui_qt._PREVIEW_ENGINES_MAX
        assert gui_qt._get_preview_engine(p, 64, 48, "cpu") is not e1  # evicted

    def test_key_holds_size_and_device(self):
        p = EffectParams(noise_strength=0.0)
        gui_qt._get_preview_engine(p, 64, 48, "cpu")
        gui_qt._get_preview_engine(p, 65, 48, "cpu")
        assert [k[1:] for k in gui_qt._PREVIEW_ENGINES] == [(64, 48, "cpu"), (65, 48, "cpu")]

    def test_persistence_slider_is_a_cache_hit(self):
        p = EffectParams(noise_strength=0.0, persistence=0.2)
        e1 = gui_qt._get_preview_engine(p, 64, 48, "cpu")
        assert not e1.params.persistence_on
        for v in (0.25, 0.5, 0.95, 0.0):
            assert gui_qt._get_preview_engine(dataclasses.replace(p, persistence=v), 64, 48,
                                              "cpu") is e1
        assert len(gui_qt._PREVIEW_ENGINES) == 1

    def test_lru_not_fifo(self):
        hot = EffectParams(noise_strength=0.0, persistence=0.0)
        e_hot = gui_qt._get_preview_engine(hot, 64, 48, "cpu")
        for i in range(gui_qt._PREVIEW_ENGINES_MAX - 1):
            gui_qt._get_preview_engine(
                EffectParams(scanline_strength=0.1 * (i + 1), noise_strength=0.0), 64, 48,
                "cpu")
        assert gui_qt._get_preview_engine(hot, 64, 48, "cpu") is e_hot
        gui_qt._get_preview_engine(EffectParams(vignette_strength=0.4, noise_strength=0.0),
                                   64, 48, "cpu")
        assert gui_qt._get_preview_engine(hot, 64, 48, "cpu") is e_hot  # survived

    def test_failing_build_raises_and_is_not_cached(self, monkeypatch):
        """The JAX core renders a failed build through the oracle and
        caches the failure for 60 s; the port raises, every time, and
        caches nothing."""
        from pythoncrt_tpu_torch import engine as eng_mod

        calls = []

        def boom(*a, **k):
            calls.append(1)
            raise RuntimeError("build failed")

        monkeypatch.setattr(eng_mod, "CRTEngine", boom)
        no_oracle(monkeypatch)
        p = EffectParams(noise_strength=0.0, persistence=0.0)
        for _ in range(2):
            with pytest.raises(RuntimeError, match="build failed"):
                gui_qt._get_preview_engine(p, 64, 48, "cpu")
        frame = synth_frames(1, 48, 64, seed=22)[0]
        with pytest.raises(RuntimeError, match="build failed"):
            gui_qt.render_preview_frame(frame, p, t=0.3, device="cpu")
        assert len(calls) == 3 and not gui_qt._PREVIEW_ENGINES
        assert not hasattr(gui_qt, "_PREVIEW_BUILD_FAILED")
        assert not hasattr(gui_qt, "_PREVIEW_FAIL_TTL_S")

    def test_failing_launch_raises(self, monkeypatch):
        p = EffectParams(noise_strength=0.0, persistence=0.0)
        eng = gui_qt._get_preview_engine(p, 64, 48, "cpu")

        def boom(*a, **k):
            raise RuntimeError("launch failed")

        monkeypatch.setattr(eng, "process_at", boom)
        no_oracle(monkeypatch)
        with pytest.raises(RuntimeError, match="launch failed"):
            gui_qt.render_preview_frame(synth_frames(1, 48, 64)[0], p, t=0.1, device="cpu")

    def test_cuda_without_a_card_raises(self):
        import torch

        if torch.cuda.is_available():
            pytest.skip("this host has CUDA")
        with pytest.raises((RuntimeError, AssertionError)):
            gui_qt.render_preview_frame(synth_frames(1, 48, 64)[0], EffectParams(), t=0.1)


class TestPreviewReader:
    @pytest.fixture
    def clip(self, tmp_path):
        frames = synth_frames(6, 32, 48, seed=4)
        path = tmp_path / "prev.mp4"
        wr = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 24, (48, 32))
        for f in frames:
            wr.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
        wr.release()
        return str(path)

    def test_metadata_and_frames_match_jax(self, clip):
        r, j = gui_qt.PreviewReader(clip), jgui.PreviewReader(clip)
        assert (r.size, r.fps, r.duration) == (j.size, j.fps, j.duration)
        assert r.size == (48, 32) and r.fps == pytest.approx(24, abs=0.5)
        seen = [r.read_next() for _ in range(8)]  # 6 frames, then the wrap
        want = [j.read_next() for _ in range(8)]
        assert all(f is not None and f.shape == (32, 48, 3) for f in seen)
        assert all(np.array_equal(a, b) for a, b in zip(seen, want))
        f0, f5 = r.frame_at(0.0), r.frame_at(5 / 24.0)
        assert not np.array_equal(f0, f5)
        np.testing.assert_array_equal(f5, j.frame_at(5 / 24.0))
        r.close()
        j.close()


class TestControlWiring:
    def test_table_equals_jax(self):
        assert gui_qt.EFFECT_CONTROLS == jgui.EFFECT_CONTROLS
        assert gui_qt.EFFECT_TABS == jgui.EFFECT_TABS

    def test_table_covers_the_port_params(self):
        fields = [row[1] for row in gui_qt.EFFECT_CONTROLS]
        assert len(fields) == len(set(fields))
        assert set(fields) == {f.name for f in dataclasses.fields(EffectParams)} - {"text"}
        d = EffectParams()
        for _attr, field, _tab, _label, kind, lo, hi, _step, dflt in gui_qt.EFFECT_CONTROLS:
            v = getattr(d, field)
            assert isinstance(v, {"b": bool, "i": int, "f": float}[kind]), field
            if kind != "b":
                assert lo <= (v if dflt is None else dflt) <= hi, field


class TestRenderJob:
    def test_success_reports_encoder(self, monkeypatch):
        from pythoncrt_tpu_torch import pipeline

        seen = {}

        def fake_process_video(progress_cb=None, **kw):
            seen.update(kw)
            progress_cb(0.5)
            progress_cb(1.0)
            return True

        monkeypatch.setattr(pipeline, "process_video", fake_process_video)
        prog, done = [], []
        gui_qt.run_render_job({"input_path": "x", "device": "cpu"}, prog.append,
                              lambda ok, msg: done.append((ok, msg)))
        assert prog == [0.5, 1.0] and done == [(True, "Hardware encoder")]
        assert seen == {"input_path": "x", "device": "cpu"}

    def test_failure_emits_done_false(self, monkeypatch):
        from pythoncrt_tpu_torch import pipeline

        def boom(**kw):
            raise RuntimeError("decode failed")

        monkeypatch.setattr(pipeline, "process_video", boom)
        done = []
        gui_qt.run_render_job({}, lambda v: None, lambda ok, msg: done.append((ok, msg)))
        assert done == [(False, "decode failed")]

    def test_renders_a_clip_on_the_cpu(self, tmp_path):
        """The worker's core drives the port's real process_video with the
        window's kwargs (export engine, device "cpu")."""
        inp, out = tmp_path / "in.mp4", tmp_path / "out.mp4"
        wr = cv2.VideoWriter(str(inp), cv2.VideoWriter_fourcc(*"mp4v"), 24, (64, 48))
        for f in synth_frames(5, 48, 64, seed=3):
            wr.write(f)
        wr.release()
        prog, done = [], []
        kwargs = dict(input_path=str(inp), output_path=str(out),
                      params=EffectParams(**C4), width=None, height=None, fps=None, crf=18,
                      target_bitrate_kbps=0, gpu=False, nvenc_preset="p4",
                      encoder_preference="auto", decoder_preference="auto", batch_size=2,
                      engine_mode="export", report=False, device="cpu")
        gui_qt.run_render_job(kwargs, prog.append, lambda ok, msg: done.append((ok, msg)))
        assert done == [(True, "CPU encoder")], done
        assert prog and prog[-1] == pytest.approx(1.0)
        cap = cv2.VideoCapture(str(out))
        assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == 5
        cap.release()
