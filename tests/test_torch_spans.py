"""The port's ``crt.*`` spans (perf.span) under torch.profiler, on the CPU.

Each public call of an engine is one ``crt.call``; inside it the
per-frame inputs (``crt.aux``, ``crt.upload``) and one ``crt.step`` per
batch, which holds one span per kernel wrapper call (``crt.draws``,
``crt.fused``, ``crt.text``, ``crt.glitch``, ``crt.persist``), none
inside another. On the CPU the wrappers run their plain twins, so no
``crt.launch`` is recorded here (the card's test counts them against
the device's kernels: portbench/tests/test_portbench_spans.py). With no
profiler recording, a span records nothing.
"""

from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pythoncrt_tpu_torch import CRTEngine, EffectParams, MultiClipEngine, TextParams, perf
from pythoncrt_tpu_torch.parallel import DeviceMesh, ShardedCRTEngine

from conftest import synth_frames
from test_torch_engine import C4

H, W, B = 24, 32, 2
WRAPPERS = ("crt.draws", "crt.fused", "crt.warp", "crt.bloom", "crt.text", "crt.glitch",
            "crt.persist")
# per step of a call: the grain draw, fused, persistence; c4 adds the
# glitch offsets' draw and the shear, c5 the text after the effects
PER_STEP = {"defaults": {"crt.draws": 1, "crt.fused": 1, "crt.persist": 1},
            "c4": {"crt.draws": 2, "crt.fused": 1, "crt.glitch": 1, "crt.persist": 1},
            "c5": {"crt.draws": 2, "crt.fused": 1, "crt.text": 1, "crt.glitch": 1,
                   "crt.persist": 1}}
PARAMS = {"defaults": {}, "c4": C4, "c5": {**C4, "text": TextParams(text="T", after=True)}}


def spans(fn) -> list:
    """(name, start us, end us) of the crt.* spans ``fn`` records, by start."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    got = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
           if e.name.startswith("crt.")]
    return sorted(got, key=lambda s: (s[1], -s[2]))


def inside(a, b) -> bool:
    return b[1] <= a[1] and a[2] <= b[2]


def engine(name, layout="planar", **kw) -> CRTEngine:
    p = EffectParams(**PARAMS[name])
    if p.text.enabled:  # a caption over a box inside the frame
        kw["text_rgba"] = np.zeros((H, W, 4), np.uint8)
        kw["text_rgba"][5:15, 4:20] = np.random.default_rng(1).integers(0, 256, (10, 16, 4))
    return CRTEngine(p, H, W, 24.0, seed=7, layout=layout, device="cpu", **kw)


def frames(n, seed=3, layout="planar") -> torch.Tensor:
    x = torch.from_numpy(synth_frames(n, H, W, seed=seed))
    return x if layout == "nhwc" else x.permute(0, 3, 1, 2).contiguous()


@pytest.mark.parametrize("steps", [1, 2])
@pytest.mark.parametrize("name", sorted(PARAMS))
def test_a_call_carries_one_span_per_layer_and_wrapper_call(name, steps):
    check_call(name, steps, "planar")


@pytest.mark.parametrize("steps", [1, 2])
@pytest.mark.parametrize("name", sorted(PARAMS))
def test_an_nhwc_call_carries_the_same_spans(name, steps):
    check_call(name, steps, "nhwc")  # its steps hold the copy out of planar


def check_call(name, steps, layout):
    eng = engine(name, layout)
    x = frames(steps * B, layout=layout)
    state = eng.init_state()  # a carried state: the call is not a stream's first
    if steps == 1:
        got = spans(lambda: eng.process(x, np.arange(4, 4 + B), state))
    else:
        got = spans(lambda: eng.process_stack(x.reshape(steps, B, *x.shape[1:]),
                                              np.arange(4, 4 + steps * B).reshape(steps, B),
                                              state))
    want = Counter({"crt.call": 1, "crt.aux": 1, "crt.upload": 1, "crt.step": steps})
    want.update({k: v * steps for k, v in PER_STEP[name].items()})
    assert Counter(s[0] for s in got) == want
    call = next(s for s in got if s[0] == "crt.call")
    assert all(inside(s, call) for s in got)
    inputs = [s for s in got if s[0] in ("crt.aux", "crt.upload")]
    batches = [s for s in got if s[0] == "crt.step"]
    wrappers = [s for s in got if s[0] in WRAPPERS]
    assert [s[0] for s in inputs] == ["crt.aux", "crt.upload"]
    for st in batches:  # each step holds its batch's wrapper calls
        assert Counter(w[0] for w in wrappers if inside(w, st)) == PER_STEP[name]
    sibs = inputs + batches
    assert not any(a is not b and inside(a, b) for a in sibs for b in sibs)
    assert not any(a is not b and inside(a, b) for a in wrappers for b in wrappers + inputs)


def test_process_at_is_one_call_with_its_aux():
    eng = CRTEngine(EffectParams(**C4), H, W, 24.0, engine="preview", rng="host",
                    layout="planar", device="cpu")
    noise = np.zeros((1, H, W), np.float32)
    got = spans(lambda: eng.process_at(frames(1), np.asarray([0.25]), noise))
    names = Counter(s[0] for s in got)
    assert names["crt.call"] == 1 and names["crt.aux"] == 1 and names["crt.upload"] == 1
    assert names["crt.step"] == 1
    assert names["crt.draws"] == 0  # host rng: no draw kernel, the offsets as torch ops
    assert names["crt.fused"] == names["crt.glitch"] == names["crt.persist"] == 1


@pytest.mark.parametrize("kind", ["sharded", "multiclip"])
def test_the_mesh_engines_are_one_call_each(kind):
    eng = engine("c4")
    if kind == "sharded":
        runner = ShardedCRTEngine(eng, DeviceMesh(["cpu"] * 2))
        x, idx = frames(2 * B), np.arange(2 * B).reshape(2, B)
        calls = ((1, lambda: runner.process(x[:B], idx[0])),
                 (2, lambda: runner.process_stack(x.reshape(2, B, 3, H, W), idx)))
    else:
        runner = MultiClipEngine(eng)
        x, idx = frames(4 * B).reshape(2, 2, B, 3, H, W), np.tile(np.arange(B), (2, 2, 1))
        calls = ((1, lambda: runner.process(x[0], idx[0])),
                 (2, lambda: runner.process_stack(x, idx)))
    for steps, fn in calls:
        got = spans(fn)
        names = Counter(s[0] for s in got)
        assert names["crt.call"] == 1 and names["crt.aux"] == 1 and names["crt.step"] == steps
        # the multi-clip engine places its clips' states before the steps and
        # gathers them after
        assert names["crt.carry"] == (2 if kind == "multiclip" else 0)
        call = next(s for s in got if s[0] == "crt.call")
        assert all(inside(s, call) for s in got)
        wrappers = [s for s in got if s[0] in WRAPPERS]
        assert names["crt.persist"] >= 1
        assert not any(a is not b and inside(a, b) for a in wrappers for b in wrappers)


def test_a_span_records_only_under_a_recording_profiler():
    assert not torch.autograd.profiler._is_profiler_enabled
    with perf.span("crt.unrecorded") as v:
        pass
    assert v is None
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with perf.span("crt.recorded"):
            torch.ones(2).add_(1)
    names = [e.name for e in prof.events()]
    assert names.count("crt.recorded") == 1 and "crt.unrecorded" not in names
    assert not torch.autograd.profiler._is_profiler_enabled


def test_a_span_passes_an_exception_on():
    with pytest.raises(ValueError, match="inside"):
        with perf.span("crt.call"):
            raise ValueError("inside")
