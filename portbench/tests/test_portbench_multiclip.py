"""The c5.batch cell at a tiny size on the CPU: a sound run with a caption
composited after the effects, a run whose clips' frames come back in each
other's slots, its configuration, and the stage-13 reader on a synthetic
trace.

    python -m pytest portbench/tests
"""

import dataclasses
import os
from types import SimpleNamespace

import pytest

from portbench import run as prun
from portbench import trace as ptrace

ROOT = prun.ROOT
SMALL = dict(height=30, width=64)
CAPTION_AFTER = {"text": "PLAY", "size": 24, "after": True, "box": [4, 6, 12, 40]}


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread, as the benchmark's runs take (run.main): with
    torch's one per core, test workers side by side crowd the host until a
    run's window misses its compared calls."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small_run(seed=2**31 + 4321):
    # 4 s: the window must reach the compared call drawn from the seed
    # (up to the 12th) on a loaded host
    return prun.run("c5.batch", seed, 4.0, False, device="cpu", cfg_over=SMALL,
                    traffic_over=dict(batch=4, steps_per_call=2, ring=3,
                                      overlay=CAPTION_AFTER))


def test_a_sound_run_with_the_caption_inside_the_frame_is_correct():
    res = small_run()
    assert res["correct"] and res["checks"]["max_lsb"]["value"] == 0
    assert res["checks"]["off_share"]["value"] == 0.0 and len(res["compared_calls"]) == 3


def test_the_caption_is_composited_after_the_effects():
    """The overlay of the small run covers part of the frame, so stage 13
    runs in the engine the run builds."""
    import torch

    entry = prun.load_module("entries", "multiclip").Entry(
        prun.effective_cfg(dict(prun.cell_spec("c5.batch")[2], **SMALL),
                           {"overlay": CAPTION_AFTER}), dict(batch=4, steps_per_call=2))
    overlay = prun.overlay_for({"overlay": CAPTION_AFTER}, 30, 64, 5)
    entry.build(5, torch.device("cpu"), overlay)
    eng = entry.engine.engine
    assert eng.text_route == "after" and overlay[..., 3].any()
    assert entry.shape == (2, 2, 2, 3, 30, 64) and entry.frames == 8
    for c in range(2):  # (steps, clips, frames a step): each clip rises through 12-15
        assert entry.indices(3)[:, c].ravel().tolist() == [12, 13, 14, 15]


def test_clips_in_each_others_slots_are_not_correct(monkeypatch):
    from pythoncrt_tpu_torch.parallel import MultiClipEngine

    stack = MultiClipEngine.process_stack

    def swapped(self, frames, idx, states=None, out=None):
        out, states = stack(self, frames, idx, states, out)
        out[:, [0, 1]] = out[:, [1, 0]].clone()
        return out, states

    monkeypatch.setattr(MultiClipEngine, "process_stack", swapped)
    res = small_run()
    assert not res["correct"] and res["checks"]["max_lsb"]["value"] > 2


def test_the_configuration_is_the_c5_deployment_in_range():
    from pythoncrt_tpu_torch import EffectParams

    bench = prun.load_json(ROOT, "BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == "c5_batch_4k")
    cfg = prun.load_json(ROOT, conf["file"])
    c4 = prun.load_json(prun.HERE, "configs", "c4_temporal_1080p.json")
    fields = {f.name for f in dataclasses.fields(EffectParams)} - {"text"}
    assert set(cfg["params"]) == fields and cfg["params"] == c4["params"]
    p = EffectParams(**cfg["params"])
    assert p.clamped() == p
    assert (cfg["height"], cfg["width"], cfg["fps"]) == (2160, 3840, 30.0)
    assert conf["reduced"] == ["clips"] and cfg["clips"] == 2
    assert len(conf["source"]) <= 200
    traffic = prun.load_json(prun.HERE, "traffic", "manifest.json")
    assert traffic["batch"] % cfg["clips"] == 0 and traffic["overlay"]["after"]
    y0, x0, bh, bw = traffic["overlay"]["box"]
    assert 0 <= y0 and y0 + bh <= cfg["height"] and 0 <= x0 and x0 + bw <= cfg["width"]


def test_text_after_ms_reads_the_kernels_outside_the_library():
    read = prun.load_module("metrics", "text_after_ms").read
    library = ptrace.library_kernels(os.path.join(ROOT, "pythoncrt_tpu_torch", "csrc"))
    dev = [("void fused_strip_kernel<0, 4>(FusedArgs)", "kernel", 0.0, 300.0),
           ("void at::native::vectorized_elementwise_kernel<4>", "kernel", 300.0, 40.0),
           ("void at::native::elementwise_kernel<128, 2>", "kernel", 340.0, 24.0),
           ("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", 364.0, 5.0),
           ("glitch_kernel(GlitchArgs)", "kernel", 370.0, 20.0),
           ("void persist_kernel<true>(PersistArgs)", "kernel", 390.0, 100.0)]
    ctx = SimpleNamespace(trace=ptrace.Trace(device=dev, calls=1, frames=16), library=library)
    assert read(ctx) == pytest.approx(64e-3 / 16)
    ctx.trace = ptrace.Trace(device=[d for d in dev if "at::native" not in d[0]], calls=1,
                             frames=16)
    assert read(ctx) is None
    ctx.trace = None
    assert read(ctx) is None
