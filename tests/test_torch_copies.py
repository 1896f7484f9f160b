"""The port's own copies of the JAX package's host modules (params and
its preset writers, oracle, the CLI parser, io.video's helpers and
encoder probes, the perf report, the text rasterizers (PIL, and Qt's
PIL path without an application), the batch journal, the multi-clip
helpers, the segment store, the dependency report, the native host I/O,
the parallel reader and compat's mask builders) against the
originals: the same flags and defaults, the same fields, clamps and
preset semantics, and equal results on seeded inputs (bitwise: the
copies run the same NumPy code)."""

import dataclasses
import json

import numpy as np
import pytest

import pythoncrt_tpu.batch as jbatch
import pythoncrt_tpu.cli as jcli
import pythoncrt_tpu.multiclip as jmulticlip
import pythoncrt_tpu.io.video as jvideo
import pythoncrt_tpu.params as jparams
import pythoncrt_tpu.text as jtext
from pythoncrt_tpu import oracle as joracle
from pythoncrt_tpu_torch import batch as tbatch
from pythoncrt_tpu_torch import cli as tcli
from pythoncrt_tpu_torch import multiclip as tmulticlip
from pythoncrt_tpu_torch import oracle as toracle
from pythoncrt_tpu_torch import params as tparams
from pythoncrt_tpu_torch import perf as tperf
from pythoncrt_tpu_torch import text as ttext
from pythoncrt_tpu_torch.io import video as tvideo


def options(parser):
    return {opt: (a.dest, a.default, a.type, tuple(a.choices or ()), a.nargs, a.const)
            for a in parser._actions for opt in a.option_strings if opt not in ("-h", "--help")}


def test_parser_has_the_jax_flags_and_defaults():
    mine, theirs = options(tcli.build_parser()), options(jcli.build_parser())
    assert set(mine) - set(theirs) == {"--device"}
    assert set(theirs) <= set(mine)
    for opt, spec in theirs.items():
        assert mine[opt] == spec, opt
    assert vars(tcli.build_parser().parse_args([])).keys() - {"device"} \
        == vars(jcli.build_parser().parse_args([])).keys()


@pytest.mark.parametrize("argv", [
    [],
    ["--persistence", "0.6", "--glitch-amp", "6", "--glitch-height", "0.3",
     "--no-fast-bloom", "--pixel-size", "1", "--scanline-speed", "120"],
    ["--persistence", "2.0", "--aberration-px", "-30", "--gamma", "0", "--warp-strength", "3"],
])
def test_params_from_args_match(argv):
    a_t, a_j = tcli.build_parser().parse_args(argv), jcli.build_parser().parse_args(argv)
    got = tcli.params_from_args(a_t, tcli.provided_flags(argv))
    want = jcli.params_from_args(a_j, jcli.provided_flags(argv))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_preset_precedence_matches(tmp_path):
    """A preset is the base, an explicit flag wins even at its default
    value, and an unpassed flag never overrides the preset."""
    preset = tmp_path / "p.json"
    preset.write_text(json.dumps({"persistence": 0.7, "fast_bloom": False, "glitch_amp": 3,
                                  "scanline": 0.2}))
    argv = ["--preset", str(preset), "--scanline-strength", "0.6"]
    got = tcli.params_from_args(tcli.build_parser().parse_args(argv), tcli.provided_flags(argv))
    want = jcli.params_from_args(jcli.build_parser().parse_args(argv), jcli.provided_flags(argv))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.persistence == 0.7 and not got.fast_bloom and got.scanline_strength == 0.6


def test_effect_params_fields_defaults_and_clamps():
    mine = {f.name: f.default for f in dataclasses.fields(tparams.EffectParams)}
    theirs = {f.name: f.default for f in dataclasses.fields(jparams.EffectParams)}
    assert mine.keys() == theirs.keys()
    for k in mine:
        if k != "text":
            assert mine[k] == theirs[k], k
    assert dataclasses.asdict(tparams.TextParams()) == dataclasses.asdict(jparams.TextParams())
    wild = dict(scanline_strength=3.0, triad_strength=-1.0, triad_gamma=0.0,
                aberration_px=40, persistence=1.5, pixel_size=0, glitch_amp_px=-2,
                glitch_height_frac=2.0, gamma=0.0, temperature=-5.0, flicker_strength=9.0,
                grain_size=0, scanline_thickness=0.0, warp_strength=-4.0)
    got = tparams.EffectParams(**wild).clamped()
    want = jparams.EffectParams(**wild).clamped()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    gates = [n for n in dir(jparams.EffectParams) if n.endswith("_on") or n == "scanlines_1d"]
    for p_t, p_j in ((got, want), (tparams.EffectParams(), jparams.EffectParams())):
        assert [getattr(p_t, g) for g in gates] == [getattr(p_j, g) for g in gates]


def test_text_preset_loads_the_same(tmp_path):
    f = tmp_path / "t.json"
    f.write_text(json.dumps({"text": "HELLO", "size": 20, "x": 5, "after": False}))
    assert dataclasses.asdict(tparams.load_text_preset(f)) \
        == dataclasses.asdict(jparams.load_text_preset(f))


def fx(rng, h=24, w=40):
    return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)


@pytest.mark.parametrize("name,kw", [
    ("defaults", {}),
    ("c4", dict(persistence=0.6, pixel_size=1, glitch_amp_px=6, glitch_height_frac=0.3,
                scanline_speed_px_s=120.0)),
    ("gauss_warp_grade", dict(fast_bloom=False, warp_strength=0.3, gamma=1.3, saturation=0.7,
                              temperature=0.3, grain_size=2, flicker_strength=0.3,
                              flicker_hz=2.0, bloom_threshold=0.2)),
    ("scan_2d_luma", dict(scanline_angle=10.0, scanline_thickness=2.0,
                          triad_preserve_luma=True)),
])
@pytest.mark.parametrize("engine", ["export", "preview"])
def test_oracle_apply_effects_is_the_same(name, kw, engine, rng):
    frame = fx(rng)
    p_t, p_j = tparams.EffectParams(**kw).clamped(), jparams.EffectParams(**kw).clamped()
    g = max(1, p_t.grain_size)
    noise = rng.standard_normal((24 // g, 40 // g), dtype=np.float32)
    a = toracle.apply_effects(frame, p_t, phase_px=3.25, time_sec=0.5, noise_field=noise,
                              engine=engine)
    b = joracle.apply_effects(frame, p_j, phase_px=3.25, time_sec=0.5, noise_field=noise,
                              engine=engine)
    np.testing.assert_array_equal(a, b)
    prev = rng.random(a.shape, dtype=np.float32)
    np.testing.assert_array_equal(toracle.persistence_blend(prev, a, 0.6),
                                  joracle.persistence_blend(prev, b, 0.6))
    np.testing.assert_array_equal(toracle.ops.to_uint8(a), joracle.ops.to_uint8(b))


def test_oracle_tables_are_the_same(rng):
    cases = [
        (lambda o: o.triad_mask(2, 50, 0.35, 0.5), None),
        (lambda o: o.barrel_warp_maps(30, 50, -0.4), None),
        (lambda o: o.pixelate_index_maps(45, 250, 3), None),
        (lambda o: o.glitch_rows(1080, 0.3), None),
        (lambda o: o.glitch_fields_export(1080, 1920, 37.5, 6, 0.3), None),
        (lambda o: o.glitch_offsets_preview(1080, 1920, 37.5, 6, 0.3), None),
        (lambda o: o.ops.bilinear_taps(1080, 540), None),
        (lambda o: o.ops.bilinear_taps(22, 45), None),
        (lambda o: o.ops.gaussian_kernel_1d(9, 1.2), None),
        (lambda o: o.ops.split_map(np.linspace(-2, 9, 31, dtype=np.float32)), None),
    ]
    for fn, _ in cases:
        a, b = fn(toracle), fn(joracle)
        for x, y in zip(a if isinstance(a, tuple) else (a,), b if isinstance(b, tuple) else (b,)):
            np.testing.assert_array_equal(x, y)
    img = rng.random((20, 30, 3), dtype=np.float32)
    np.testing.assert_array_equal(toracle.ops.resize_bilinear(img, 10, 15),
                                  joracle.ops.resize_bilinear(img, 10, 15))
    offs = rng.normal(0, 9, (8, 30)).astype(np.float32)
    np.testing.assert_array_equal(toracle.apply_glitch_gather(img, 12, offs),
                                  joracle.apply_glitch_gather(img, 12, offs))


def test_video_helpers_are_the_same():
    for preset in ("p1", "p4", "p7", "hq", "bogus", ""):
        assert tvideo.normalize_nvenc_preset(preset) == jvideo.normalize_nvenc_preset(preset)
    for pref in ("auto", "nvidia", "amd", "intel", "cpu", None):
        assert tvideo.map_decoder_to_hwaccel(pref) == jvideo.map_decoder_to_hwaccel(pref)
    for codec in ("libx264", "h264_nvenc", "h264_amf"):
        for kbps in (0, 8000):
            assert tvideo.encoder_ffparams(codec, 20, kbps, "p5") \
                == jvideo.encoder_ffparams(codec, 20, kbps, "p5")
    assert tvideo.find_ffmpeg() == jvideo.find_ffmpeg()


def test_video_roundtrip_through_cv2(tmp_path):
    """The port's writer and reader give the frames and clip info the
    JAX package's give (cv2 codecs: no ffmpeg binary here)."""
    pytest.importorskip("cv2")
    frames = np.random.default_rng(0).integers(0, 256, (5, 32, 48, 3), dtype=np.uint8)
    path = str(tmp_path / "c.mp4")
    wr, used_gpu = tvideo.open_writer(path, 48, 32, 24.0)
    for f in frames:
        wr.write_frame(f)
    wr.close()
    assert not used_gpu
    assert dataclasses.asdict(tvideo.probe_clip(path)) \
        == dataclasses.asdict(jvideo.probe_clip(path))
    got = []
    rd = tvideo.open_reader(path, 48, 32, 24.0)
    buf = np.empty((32, 48, 3), np.uint8)
    while rd.read_into(buf):
        got.append(buf.copy())
    rd.close()
    want = list(jvideo.open_reader(path, 48, 32, 24.0).iter_frames())
    assert len(got) == 5 and all(np.array_equal(a, b) for a, b in zip(got, want))


def test_perf_report_format():
    tperf.perf_reset()
    with tperf.timed("io.decode"):
        pass
    with tperf.timed("io.decode"):
        pass
    text = tperf.perf_report(total_frames=4, total_seconds=2.0, print_fn=None)
    lines = text.splitlines()
    assert lines[:3] == ["perf total 2.000s", "perf frames 4", "perf fps 2.0"]
    assert lines[3].startswith("io.decode total=") and "count=2" in lines[3]
    tperf.perf_reset()
    assert tperf.perf_report(0, 0.0, print_fn=None).splitlines() == [
        "perf total 0.000s", "perf frames 0"]


@pytest.mark.parametrize("color", ["#FF8000", "00ff7f", " #123456 ", "#12345", "red", ""])
def test_parse_hex_color_is_the_same(color):
    assert ttext.parse_hex_color(color) == jtext.parse_hex_color(color)


@pytest.mark.parametrize("kw", [
    dict(text="CH 3", size=24, color="#FFCC00", x=10, y=5),
    dict(text="PLAY", size=12, font="DejaVu Sans Mono", x=200, y=30, after=False),
    dict(text="", size=36),
])
def test_rasterize_text_is_the_same(kw):
    """The same RGBA canvas from the same PIL calls, and the same
    overlay_for (None when the text is off)."""
    pytest.importorskip("PIL")
    t_t, t_j = tparams.TextParams(**kw), jparams.TextParams(**kw)
    got, want = ttext.rasterize_text(256, 48, t_t), jtext.rasterize_text(256, 48, t_j)
    assert got.shape == (48, 256, 4) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    ov = ttext.overlay_for(256, 48, t_t)
    assert (ov is None) == (not t_t.enabled)
    if ov is not None:
        np.testing.assert_array_equal(ov, jtext.overlay_for(256, 48, t_j))
        assert ov[..., 3].any()


def seeded_jobs(seed, n=6):
    """The same jobs as the port's and the JAX package's ClipJobs, with
    the kwargs each CLI's --batch-manifest gives them (the port's adds
    its device)."""
    rng = np.random.default_rng(seed)
    base = vars(jcli.build_parser().parse_args([]))
    out = []
    for i in range(n):
        kw = dict(persistence=float(rng.choice([0.0, 0.2, 0.6])),
                  glitch_amp_px=int(rng.integers(0, 8)), fast_bloom=bool(rng.integers(2)),
                  text=dict(text=str(rng.choice(["", "CH 3"])), size=int(rng.integers(8, 40))))
        geo = dict(width=int(rng.choice([0, 1920])) or None, height=None,
                   fps=float(rng.choice([0.0, 24.0, 30000 / 1001])) or None)
        kwargs = dict(crf=18, target_bitrate_kbps=0, gpu=False, nvenc_preset="p4",
                      encoder_preference="auto", decoder_preference="auto",
                      batch_size=int(rng.choice([8, 16])), engine_mode="export",
                      rng=str(rng.choice(["native", "host"])), seed=int(rng.integers(9)),
                      precision="exact", pipe_format=base["pipe_format"], devices=0,
                      steps_per_call=0)
        if rng.integers(2):
            kwargs["assoc_scan"] = True
        text = kw.pop("text")
        jp = jparams.EffectParams(**kw, text=jparams.TextParams(**text))
        tp = tparams.EffectParams(**kw, text=tparams.TextParams(**text))
        paths = (f"/clips/in{i}.mp4", f"/clips/out{i}.mp4")
        out.append((tbatch.ClipJob(*paths, tp, **geo, kwargs={**kwargs, "device": "cuda"}),
                    jbatch.ClipJob(*paths, jp, **geo, kwargs=dict(kwargs))))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_batch_signatures_are_the_same(seed, tmp_path):
    """_group_key and _job_sig equal the JAX ones on seeded jobs, so a
    journal written by either CLI is read by the other."""
    jobs = seeded_jobs(seed)
    for mine, theirs in jobs:
        assert tbatch._group_key(mine) == jbatch._group_key(theirs)
        assert tbatch._job_sig(mine) == jbatch._job_sig(theirs)
    assert tbatch.MULTI_CLIP_KWARGS == jbatch.MULTI_CLIP_KWARGS | {"device"}
    j_theirs, j_mine = tmp_path / "jax.jsonl", tmp_path / "torch.jsonl"
    for mine, theirs in jobs[:4]:
        jbatch.RenderJournal(j_theirs).mark_done(theirs, 1.0)
        tbatch.RenderJournal(j_mine).mark_done(mine, 1.0)
    for k, (mine, theirs) in enumerate(jobs):
        assert tbatch.RenderJournal(j_theirs).is_done(mine) == (k < 4)
        assert jbatch.RenderJournal(j_mine).is_done(theirs) == (k < 4)


def test_multiclip_helpers_are_the_same():
    from types import SimpleNamespace

    for h, w in ((2160, 3840), (1080, 1920), (48, 64), (1081, 1920)):
        for clips in (1, 2, 4, 9):
            for batch in (1, 8, 16, 64):
                assert tmulticlip.auto_steps_per_call(h, w, clips, batch) \
                    == jmulticlip.auto_steps_per_call(h, w, clips, batch)
    ntsc = 30000 / 1001
    infos = [SimpleNamespace(fps=ntsc), None, SimpleNamespace(fps=29.97000001),
             SimpleNamespace(fps=0.0)]
    for live, fps in (([0, 2], None), ([0, 2], 24.0), ([3], None), ([0], 0.0)):
        assert tmulticlip._resolve_output_rate(infos, live, fps) \
            == jmulticlip._resolve_output_rate(infos, live, fps)
    for mod in (tmulticlip, jmulticlip):
        with pytest.raises(ValueError, match="differ"):
            mod._resolve_output_rate([SimpleNamespace(fps=24.0), SimpleNamespace(fps=25.0)],
                                     [0, 1], None)


def seeded_store_ops(store_cls, root, seed):
    """One seeded history of a segment journal, applied to a store of
    ``store_cls``: segments committed (some with a carry snapshot), a
    segment file removed, a torn last line; returns what resume() says."""
    rng = np.random.default_rng(seed)
    sig = {"w": 64, "params": {"persistence": float(rng.choice([0.0, 0.5]))}}
    st = store_cls(root / "o.mp4", sig)
    st.resume()
    n = int(rng.integers(1, 6))
    for i in range(n):
        st.seg_path(i).write_bytes(b"x")
        snap = rng.random((3, 4, 5), dtype=np.float32) if rng.integers(2) else None
        st.mark_done(i, int(rng.integers(1, 9)), snap)
    if rng.integers(2):
        st.seg_path(int(rng.integers(n))).unlink()
    if rng.integers(2):
        with open(st.journal, "a") as f:
            f.write('{"seg": ')
    nxt, skip, state = store_cls(root / "o.mp4", sig).resume()
    return nxt, skip, None if state is None else state.tolist()


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("module", ["segments", "bootstrap", "native", "parallel_reader"])
def test_copied_host_modules_agree(tmp_path, module, seed):
    """The port's copies of segments.py, bootstrap.py, native/ and io.video's
    ChunkedParallelReader against the originals on seeded inputs: the
    same resume of the same journal history, the same dependency report
    (torch in place of jax), the same converted bytes, the same batches."""
    rng = np.random.default_rng(seed)
    if module == "segments":
        from pythoncrt_tpu import segments as jseg
        from pythoncrt_tpu_torch import segments as tseg

        (tmp_path / "j").mkdir()
        (tmp_path / "t").mkdir()
        assert seeded_store_ops(tseg.SegmentStore, tmp_path / "t", seed) \
            == seeded_store_ops(jseg.SegmentStore, tmp_path / "j", seed)
    elif module == "bootstrap":
        from pythoncrt_tpu import bootstrap as jboot
        from pythoncrt_tpu_torch import bootstrap as tboot

        assert tboot._OPTIONAL == jboot._OPTIONAL
        assert [e if e[0] != "torch" else ("jax", "jax", "the TPU/XLA engine")
                for e in tboot._CORE] == list(jboot._CORE)
        pick = lambda entries: tuple(e for e in entries if rng.integers(2))  # noqa: E731
        core, opt = pick(jboot._CORE[:1] + jboot._CORE[2:]), pick(jboot._OPTIONAL)
        assert tboot.DepReport(core, opt).render() == jboot.DepReport(core, opt).render()
        assert tboot.DepReport(core, opt).ok == jboot.DepReport(core, opt).ok
    elif module == "native":
        from pythoncrt_tpu import native as jnative
        from pythoncrt_tpu_torch import native as tnative

        w, h = 2 * int(rng.integers(1, 40)), 2 * int(rng.integers(1, 30))
        src = rng.integers(0, 256, w * h * 3 // 2, dtype=np.uint8).tobytes()
        np.testing.assert_array_equal(tnative.yuv420p_to_rgb24(src, w, h),
                                      jnative.yuv420p_to_rgb24(src, w, h))
    else:
        pytest.importorskip("cv2")
        frames = rng.integers(0, 256, (int(rng.integers(5, 14)), 32, 48, 3), dtype=np.uint8)
        path = str(tmp_path / "c.mp4")
        wr, _ = tvideo.open_writer(path, 48, 32, 24.0)
        for f in frames:
            wr.write_frame(f)
        wr.close()
        b, start = int(rng.integers(1, 5)), int(rng.integers(0, 6))
        kw = dict(total_frames=len(frames) + int(rng.integers(-2, 3)), batch_size=b,
                  workers=int(rng.integers(1, 4)), chunk_batches=int(rng.integers(1, 3)),
                  start_frame=start)
        got, want = [], []
        for mod, out in ((tvideo, got), (jvideo, want)):
            par = mod.ChunkedParallelReader(path, 48, 32, 24.0, **kw)
            out += [(i, np.array(x)) for i, x in par.iter_batches(b)]
            par.close()
        assert [i for i, _ in got] == [i for i, _ in want]
        assert all(np.array_equal(x, y) for (_, x), (_, y) in zip(got, want))
        assert sum(len(x) for _, x in got) == len(frames) - start


@pytest.mark.parametrize("kw", [
    dict(text="CH 3", size=24, color="#FFCC00", x=10, y=5),
    dict(text="", size=36),
])
def test_rasterize_text_qt_without_qt_is_the_pil_path(kw):
    """Without PySide6 (or, tests/test_torch_gui_stubbed.py, without a
    QGuiApplication) the Qt rasterizer takes the PIL path, as the JAX
    package's does."""
    pytest.importorskip("PIL")
    import importlib.util

    if importlib.util.find_spec("PySide6") is not None:
        pytest.skip("PySide6 is installed here")
    t_t, t_j = tparams.TextParams(**kw), jparams.TextParams(**kw)
    got = ttext.rasterize_text_qt(64, 40, t_t)
    np.testing.assert_array_equal(got, ttext.rasterize_text(64, 40, t_t))
    np.testing.assert_array_equal(got, jtext.rasterize_text_qt(64, 40, t_j))


def test_encoder_probes_are_the_same():
    assert (tvideo.can_use_nvenc(), tvideo.can_use_amf()) \
        == (jvideo.can_use_nvenc(), jvideo.can_use_amf())


@pytest.mark.parametrize("seed", range(3))
def test_preset_writers_are_the_same(tmp_path, seed):
    """save_preset / save_text_preset write the JAX package's JSON (the
    GUI's Save Preset actions), and load back to the same params."""
    rng = np.random.default_rng(seed)
    kw = dict(scanline_strength=float(rng.uniform(0, 1)), persistence=float(rng.uniform(0, 0.9)),
              pixel_size=int(rng.integers(1, 5)), fast_bloom=bool(rng.integers(2)),
              glitch_amp_px=int(rng.integers(0, 9)), warp_strength=float(rng.uniform(-1, 1)))
    text = dict(text=str(rng.choice(["", "CH 3"])), size=int(rng.integers(8, 60)),
                x=int(rng.integers(0, 99)), after=bool(rng.integers(2)))
    codec = dict(crf=int(rng.integers(12, 29)), bitrate_kbps=int(rng.integers(0, 9000)),
                 nvenc_preset="p5", gpu=bool(rng.integers(2)), encoder="cpu")
    for mod, tag in ((tparams, "t"), (jparams, "j")):
        p = mod.EffectParams(**kw, text=mod.TextParams(**text))
        mod.save_preset(tmp_path / f"{tag}.json", p, **codec)
        mod.save_text_preset(tmp_path / f"{tag}_text.json", p.text)
    for name in ("{}.json", "{}_text.json"):
        assert json.loads((tmp_path / name.format("t")).read_text()) \
            == json.loads((tmp_path / name.format("j")).read_text())
    got, raw = tparams.load_preset(tmp_path / "t.json")
    assert raw["crf"] == codec["crf"] and got.pixel_size == kw["pixel_size"]
    assert dataclasses.asdict(tparams.load_text_preset(tmp_path / "t_text.json")) == text | dict(
        font="", color="#FFFFFF", y=32)


@pytest.mark.parametrize("seed", range(3))
def test_compat_mask_builders_are_the_same(seed):
    from pythoncrt_tpu import compat as jcompat
    from pythoncrt_tpu_torch import compat as tcompat

    rng = np.random.default_rng(seed)
    h, w = int(rng.integers(5, 60)), int(rng.integers(5, 90))
    s, per, ph = float(rng.uniform(0, 1)), float(rng.uniform(1, 5)), float(rng.uniform(-9, 9))
    ang, soft = float(rng.uniform(-30, 30)), float(rng.uniform(0, 2))
    for call in (lambda c: c.make_scanline_mask_dynamic(h, s, per, ph),
                 lambda c: c.make_scanline_mask_2d(h, w, s, per, ph, ang, 1.5),
                 lambda c: c.make_triad_mask(h, w, s, soft),
                 lambda c: c.make_vignette(h, w, s)):
        np.testing.assert_array_equal(call(tcompat), call(jcompat))
