"""The port's reference-compatible API (pythoncrt_tpu_torch.compat)
against the JAX package's (pythoncrt_tpu.compat): the same names and
signatures (process_video adds a keyword-only device), every single-frame
function bit for bit on seeded inputs (both run the NumPy oracle), and
process_video rendering a small clip on the CPU."""

import inspect

import numpy as np
import pytest

from pythoncrt_tpu import compat as jcompat
from pythoncrt_tpu_torch import compat as tcompat

from conftest import synth_frames

H, W = 37, 53
FUNCS = ("shift_channel", "make_scanline_mask_dynamic", "make_scanline_mask_2d",
         "make_triad_mask", "make_vignette", "apply_color_adjustments", "apply_barrel_warp",
         "apply_static_effects", "apply_crt_effect", "process_video",
         "normalize_nvenc_preset", "can_use_nvenc", "can_use_amf")


@pytest.mark.parametrize("name", FUNCS)
def test_same_names_and_signatures(name):
    mine, theirs = inspect.signature(getattr(tcompat, name)), \
        inspect.signature(getattr(jcompat, name))
    params = list(mine.parameters.values())
    if name == "process_video":
        assert params[-1].name == "device" and params[-1].kind is params[-1].KEYWORD_ONLY
        assert params[-1].default == "cuda"
        params = params[:-1]
    assert [(p.name, p.kind, p.default) for p in params] \
        == [(p.name, p.kind, p.default) for p in theirs.parameters.values()]


@pytest.mark.parametrize("seed", range(3))
def test_frame_helpers_are_the_same(seed):
    """shift_channel, the grade, the warp and the encoder helpers (the
    mask builders: tests/test_torch_copies.py)."""
    rng = np.random.default_rng(seed)
    img = rng.random((H, W, 3), dtype=np.float32)
    for dx, dy in ((0, 0), (3, -2), (-7, 5)):
        np.testing.assert_array_equal(tcompat.shift_channel(img, dx, dy),
                                      jcompat.shift_channel(img, dx, dy))
    grade = (float(rng.uniform(-0.2, 0.2)), float(rng.uniform(0.5, 1.5)),
             float(rng.uniform(0.5, 2.0)), float(rng.uniform(0, 2)), float(rng.uniform(-1, 1)))
    np.testing.assert_array_equal(tcompat.apply_color_adjustments(img, *grade),
                                  jcompat.apply_color_adjustments(img, *grade))
    for k in (0.0, float(rng.uniform(-1, 1))):
        np.testing.assert_array_equal(tcompat.apply_barrel_warp(img, k),
                                      jcompat.apply_barrel_warp(img, k))
    assert tcompat.apply_barrel_warp(img, 0.0) is img
    for preset in ("p1", "p7", "hq", "junk"):
        assert tcompat.normalize_nvenc_preset(preset) == jcompat.normalize_nvenc_preset(preset)
    assert (tcompat.can_use_nvenc(), tcompat.can_use_amf()) \
        == (jcompat.can_use_nvenc(), jcompat.can_use_amf())


def frame_args(rng, masks: bool):
    """Positional arguments of the reference's frame calls, seeded."""
    triad = rng.random((H, W, 3), dtype=np.float32) if masks else None
    vig = rng.random((H, W), dtype=np.float32) if masks else None
    return dict(scanline_strength=float(rng.uniform(0, 1)), triad_mask=triad, triad_gamma=2.2,
                triad_preserve_luma=bool(rng.integers(2)), aberration_px=int(rng.integers(-3, 4)),
                bloom_sigma=float(rng.uniform(0, 3)), bloom_strength=float(rng.uniform(0, 0.5)),
                bloom_threshold=float(rng.uniform(0, 0.3)), noise_strength=float(rng.uniform(0, 6)),
                vignette_mask=vig, scanline_period_px=2.0,
                scanline_phase_px=float(rng.uniform(0, 40)),
                fast_bloom=bool(rng.integers(2)), pixel_size=int(rng.integers(1, 4)),
                glitch_amp_px=int(rng.integers(0, 7)),
                glitch_height_frac=float(rng.uniform(0, 0.5)))


@pytest.mark.parametrize("masks", [False, True])
@pytest.mark.parametrize("seed", range(3))
def test_frame_chains_are_the_same(seed, masks):
    """apply_static_effects (export) and apply_crt_effect (preview, state
    carried over two frames) give the JAX compat's bytes."""
    rng = np.random.default_rng(10 + seed)
    frames = synth_frames(2, H, W, seed=seed)
    kw = frame_args(rng, masks)
    extra = dict(time_sec=0.4, brightness=0.03, contrast=1.1, gamma=1.2, saturation=0.8,
                 temperature=0.2, flicker_strength=0.3, flicker_hz=2.0,
                 grain_size=int(rng.integers(1, 3)), scanline_angle=float(rng.choice([0, 7])),
                 scanline_thickness=1.5, warp_strength=float(rng.uniform(-0.3, 0.3)))
    np.testing.assert_array_equal(tcompat.apply_static_effects(frames[0], **kw, **extra),
                                  jcompat.apply_static_effects(frames[0], **kw, **extra))
    crt = {k: v for k, v in kw.items()}
    st_t = st_j = None
    for f in frames:
        out_t, st_t = tcompat.apply_crt_effect(f, persistence=0.6, state_prev=st_t, **crt,
                                               **extra)
        out_j, st_j = jcompat.apply_crt_effect(f, persistence=0.6, state_prev=st_j, **crt,
                                               **extra)
        np.testing.assert_array_equal(out_t, out_j)
        np.testing.assert_array_equal(st_t, st_j)
    # a carried state of another size is resized, as in the reference
    small = rng.random((H // 2, W // 2, 3), dtype=np.float32)
    a = tcompat.apply_crt_effect(frames[0], persistence=0.5, state_prev=small, **crt)
    b = jcompat.apply_crt_effect(frames[0], persistence=0.5, state_prev=small, **crt)
    np.testing.assert_array_equal(a[0], b[0])
    assert a[1].shape == (H, W, 3)


def test_process_video_renders_on_the_cpu(tmp_path):
    """The reference's process_video signature, positional as the
    reference calls it, on device "cpu": every frame written."""
    import cv2

    from test_pipeline import write_clip

    src = write_clip(tmp_path / "in.mp4", synth_frames(6, 32, 48, seed=4))
    seen = []
    used_gpu = tcompat.process_video(
        src, tmp_path / "out.mp4", None, None, 0.6, 0.35, 2.2, False, 0.5, 1, 1.2, 0.25, 1.5,
        0.25, 0.6, None, 18, 0, 30.0, 2.0, True, 2, False, "p4", 6, 0.3,
        progress_cb=seen.append, device="cpu")
    assert used_gpu is False
    cap = cv2.VideoCapture(str(tmp_path / "out.mp4"))
    assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == 6
    cap.release()
    assert seen and seen[-1] == pytest.approx(1.0)


def test_process_video_defaults_to_the_card(tmp_path, monkeypatch):
    from pythoncrt_tpu_torch import pipeline

    seen = {}
    monkeypatch.setattr(pipeline, "process_video",
                        lambda *a, **k: seen.update(k) or True)
    assert tcompat.process_video("in.mp4", "out.mp4", None, None, 0.6, 0.35, 2.2, False, 0.5, 1,
                                 1.2, 0.25, 1.5, 0.25, 0.2, None, 18, 0, 30.0, 2.0, True, 2,
                                 False, "p4") is True
    assert seen["device"] == "cuda"
