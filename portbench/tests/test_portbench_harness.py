"""The harness: BENCHMARK.json and its files, the JAX guard, a run at a tiny
size on the CPU (sound, and with the timed path broken underneath), the
bfloat16 control, and the per-layer readers on a synthetic trace.

    python -m pytest portbench/tests
"""

import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import types
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from portbench import run as prun
from portbench import trace as ptrace

ROOT = prun.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SMALL = dict(height=30, width=64)
CAPTION = {"text": "PLAY", "size": 48, "after": False, "box": [3, 5, 10, 35]}


def bench() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def small_traffic(workload: str, **extra) -> dict:
    t = dict(batch=4, steps_per_call=2, ring=3, **extra)
    if bench_cell(workload)["traffic"] == "caption":
        t["overlay"] = CAPTION
    return t


def bench_cell(workload: str) -> dict:
    return next(c for c in bench()["workloads"] if c["name"] == workload)


CELLS = [c["name"] for c in bench()["workloads"]]


def test_benchmark_json_keeps_the_contract():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert b["paths"] == ["portbench"] and 1 <= b["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in b[k]]
    assert all(NAME.match(n) for n in names) and len(names) == len(set(names))
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and os.path.isfile(os.path.join(ROOT, c["file"]))
        assert any(w["config"] == c["name"] for w in b["workloads"])
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200 and (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        traffic = prun.load_json(prun.HERE, "traffic", f"{w['traffic']}.json")
        assert os.path.isfile(os.path.join(prun.HERE, "entries", f"{traffic['entry']}.py"))
        limits = prun.load_json(prun.HERE, "limits", f"{w['name']}.json")
        assert set(limits) == {"max_lsb", "off_share"}
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in b["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"] and len(m["layer"]) <= 200
        assert os.path.isfile(os.path.join(prun.HERE, "metrics", f"{m['name']}.py"))
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    assert len(json.dumps(b)) < 64 * 1024


@pytest.mark.parametrize("name", ["defaults_1080p", "c4_temporal_1080p"])
def test_configuration_states_every_parameter_in_its_legal_range(name):
    from pythoncrt_tpu_torch import EffectParams

    cfg = prun.load_json(prun.HERE, "configs", f"{name}.json")
    fields = {f.name for f in dataclasses.fields(EffectParams)} - {"text"}
    assert set(cfg["params"]) == fields
    p = EffectParams(**cfg["params"])
    assert p.clamped() == p


@pytest.mark.parametrize("names,found", [
    (["torch", "pythoncrt_tpu_torch", "pythoncrt_tpu_torch.engine", "numpy"], []),
    (["jax.numpy"], ["jax"]), (["jaxlib"], ["jaxlib"]), (["flax.linen"], ["flax"]),
    (["pythoncrt_tpu"], ["pythoncrt_tpu"]), (["pythoncrt_tpu.engine", "jax"],
                                             ["jax", "pythoncrt_tpu"]),
    (["pythoncrt_tpu_jax", "jaxtyping"], []),
])
def test_guard_compares_whole_top_level_names(names, found):
    assert prun.banned_modules(names) == found


def small_run(workload, seed=2**31 + 321, seconds=2.0, **extra):
    return prun.run(workload, seed, seconds, False, device="cpu", cfg_over=SMALL,
                    traffic_over=small_traffic(workload, **extra))


@pytest.mark.parametrize("workload", CELLS)
def test_a_sound_run_is_correct(workload):
    res = small_run(workload)
    assert res["correct"] and res["checks"]["max_lsb"]["value"] == 0
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res)[-1] == "checks" and len(res["compared_calls"]) == 3
    assert res["compared_calls"][-1] == prun.WARM_CALLS + res["attempted"] // 8 - 1
    assert {"fps", "batch_ms_p95", "setup_s"} == set(res["metrics"])


def test_the_step_entry_renders_the_same_frames():
    res = small_run("c4.export", entry="step")
    assert res["correct"] and res["checks"]["max_lsb"]["value"] == 0


class TwoClips:
    """An entry of two clips side by side in each batch, each through its own
    engine with its own seed: a call holds two streams."""

    keys = (0, 1)  # each clip's engine seed, after the run's

    def __init__(self, cfg, traffic):
        from portbench.entries import OneStream

        self.one = OneStream(cfg, traffic)
        self.cfg, self.steps, self.half = cfg, self.one.steps, self.one.batch // 2
        self.frames, self.shape, self.per = self.one.frames, self.one.shape, self.one.steps * (
            self.one.batch // 2)

    def indices(self, k):
        return np.arange(k * self.per, (k + 1) * self.per).reshape(self.steps, self.half)

    def build(self, seed, device, overlay):
        from portbench.entries import crt_engine

        self.engines = [crt_engine(self.cfg, seed + c, device, overlay) for c in self.keys]

    def release(self):
        self.engines = None

    def call(self, x, idx, state, out):
        state, new = state or [None, None], []
        for c, eng in enumerate(self.engines):
            sl = slice(c * self.half, (c + 1) * self.half)
            frames, st = eng.process_stack(x[:, sl].contiguous(), idx, state[c])
            out[:, sl].copy_(frames)
            new.append(st)
        return new

    def streams(self, ring, k, lead, seed, out=None):
        res = []
        for c in (0, 1):
            start, stop = max(0, k * self.per - lead), (k + 1) * self.per
            x = torch.stack([ring[(j // self.per) % ring.shape[0], (j % self.per) // self.half,
                                  c * self.half + j % self.half] for j in range(start, stop)])
            got = None if out is None else out[:, c * self.half:(c + 1) * self.half].reshape(
                self.per, *out.shape[2:])
            res.append({"seed": seed + c, "x": x, "idx": np.arange(start, stop), "n": self.per,
                        "got": got})
        return res


@pytest.mark.parametrize("same_seed", [False, True])
def test_an_entry_of_two_streams_is_judged_stream_by_stream(same_seed, monkeypatch):
    load = prun.load_module

    class Keyed(TwoClips):
        keys = (0, 0) if same_seed else (0, 1)  # (0, 0): the second clip drawn with the first's key

    monkeypatch.setattr(prun, "load_module", lambda kind, name: types.SimpleNamespace(
        Entry=Keyed) if (kind, name) == ("entries", "twoclips") else load(kind, name))
    res = small_run("c4.export", entry="twoclips")
    assert res["correct"] is not same_seed


def test_a_loaded_jax_module_ends_the_run(monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    with pytest.raises(SystemExit) as e:
        small_run("defaults.export", seconds=0.2)
    assert e.value.code == 3


def _state_unchanged(monkeypatch):
    from pythoncrt_tpu_torch.engine import CRTEngine

    finish = CRTEngine._finish

    def broken(self, imgs, state, first, dst=None):
        frames, _ = finish(self, imgs, state, first, dst)
        return frames, state

    monkeypatch.setattr(CRTEngine, "_finish", broken)


def _half_the_batch(monkeypatch):
    from pythoncrt_tpu_torch.engine import CRTEngine

    step = CRTEngine._step

    def broken(self, x, aux, state, first, dst=None):
        from pythoncrt_tpu_torch.engine import aux_slice

        half = x.shape[0] // 2
        got, state = step(self, x[:half], aux_slice(self.upload(aux), slice(0, half)), state,
                          first)
        frames = torch.zeros_like(x)  # the other half left out
        frames[:half] = got
        return frames, state

    monkeypatch.setattr(CRTEngine, "_step", broken)


def _value_altered(monkeypatch):
    from pythoncrt_tpu_torch.kernels import persist

    scan = persist.persistence_scan

    def broken(*a, **k):
        out, state = scan(*a, **k)
        out.view(-1)[out.numel() // 2] ^= 0x40
        return out, state

    monkeypatch.setattr(persist, "persistence_scan", broken)


def _draws_keyed_wrong(monkeypatch):
    from pythoncrt_tpu_torch.kernels import rng

    grain = rng.grain_normals
    monkeypatch.setattr(rng, "grain_normals", lambda seed, frames, gh, gw: grain(
        seed, frames + 1, gh, gw))


FAULTS = {"state_unchanged": _state_unchanged, "half_the_batch": _half_the_batch,
          "value_altered": _value_altered, "draws_keyed_wrong": _draws_keyed_wrong}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload", CELLS)
def test_a_broken_timed_path_is_not_correct(workload, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    assert not small_run(workload)["correct"]


@pytest.mark.parametrize("workload", CELLS)
def test_the_bfloat16_control_fails_the_limits(workload):
    from portbench import control

    r = control.control(workload, 2**31 + 77, 40, device="cpu", cfg_over=SMALL,
                        traffic_over=small_traffic(workload))
    assert r["limits_fail_it"]


def fake_trace() -> ptrace.Trace:
    dev = [("void fused_strip_kernel<0, 4>(FusedArgs)", "kernel", 0.0, 300.0),
           ("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", 310.0, 5.0),
           ("persist_kernel(PersistArgs)", "kernel", 320.0, 100.0),
           ("void at::native::vectorized_elementwise_kernel<4>", "kernel", 500.0, 50.0),
           ("void fused_strip_kernel<0, 4>(FusedArgs)", "kernel", 540.0, 300.0)]
    host = [("portbench.profiled", 0.0, 900.0), ("aten::copy_", 420.0, 60.0),
            ("cudaLaunchKernel", 430.0, 5.0)]
    return ptrace.Trace(device=dev, host=host, wall_s=0.0009, calls=2, frames=32)


def test_the_trace_reading():
    tr = fake_trace()
    assert tr.busy_s() == pytest.approx(745e-6) and tr.span_s() == pytest.approx(840e-6)
    bd = tr.breakdown()
    assert bd["device_ops"][0] == ["void fused_strip_kernel<0, 4>(FusedArgs)", 600e-6]
    assert bd["idle_gaps"][0] == ["aten::copy_", pytest.approx(80e-6)]
    assert len(tr.kernels("fused_strip_kernel")) == 2 and not tr.kernels("fused_strip")


def test_the_readers_on_a_synthetic_trace():
    cfg = prun.effective_cfg(prun.load_json(prun.HERE, "configs", "c4_temporal_1080p.json"),
                             {"overlay": None})
    ctx = SimpleNamespace(cfg=cfg, trace=fake_trace(), dispatch_s=[0.001, 0.003, 0.002],
                          library=ptrace.library_kernels(os.path.join(
                              ROOT, "pythoncrt_tpu_torch", "csrc")))
    read = {m["name"]: prun.load_module("metrics", m["name"]).read
            for m in bench()["per_layer"]}
    assert read["dispatch_ms"](ctx) == pytest.approx(2.0)
    assert read["launches_per_frame"](ctx) == 5 / 32
    assert read["idle_share"](ctx) == pytest.approx(100 * (1 - 745.0 / 840.0))
    assert read["torch_ops_ms"](ctx) == pytest.approx(0.05 / 32)
    from portbench import yardstick

    b, ops = yardstick.fused_work(cfg, 16)
    assert b == 16 * 3 * 1080 * 1920 * 5 + 16 * 1080 * 1920 * 4 + 16 * 1080 * 4 + \
        (1080 + 1920) * 4 + 3 * 1920 * 4
    assert read["fused_roofline"](ctx) == pytest.approx(
        100 * yardstick.bound_s(b, ops) / 300e-6)
    assert read["persist_roofline"](ctx) == pytest.approx(
        100 * yardstick.bound_s(*yardstick.persistence_work(cfg, 32)) / 100e-6)
    ctx.trace = ptrace.Trace(device=[("persist_kernel", "kernel", 0.0, 1.0)], frames=8, calls=1)
    assert read["fused_roofline"](ctx) is None and read["torch_ops_ms"](ctx) is None


def test_a_directory_without_the_port_gives_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(prun.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    r = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", CELLS[0],
                        "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, PYTHONPATH=""))
    assert r.returncode != 0 and not r.stdout.strip()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the run's timed path is the port's kernels")


@pytest.mark.cuda
def test_a_short_run_on_the_card(card):
    r = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "c4.export",
                        "--seed", str(2**31 + 5), "--seconds", "2", "--trace", "1"], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["busy_s"] > 0
    assert 0 < res["metrics"]["fused_roofline"]["value"] <= 100
