"""The readers of the port's crt.* spans (call_ms, inputs_ms, wrapper_us,
launch_us, portbench/spans.py) on a synthetic trace, and on the card each
cell's traced run: the four metrics, one crt.launch span per kernel of the
port's library, and the engine call held mostly by its layers' spans.

    python -m pytest portbench/tests/test_portbench_spans.py
    python -m pytest --noconftest -m cuda portbench/tests/test_portbench_spans.py  # on the card
"""

import json
import os
import re
import subprocess
import sys
from types import SimpleNamespace

import pytest
import torch

from portbench import run as prun
from portbench import spans
from portbench import trace as ptrace

ROOT = prun.ROOT
CELLS = [c["name"] for c in prun.load_json(ROOT, "BENCHMARK.json")["workloads"]]
READERS = ("call_ms", "inputs_ms", "wrapper_us", "launch_us")
LIBRARY = ptrace.library_kernels(os.path.join(ROOT, "pythoncrt_tpu_torch", "csrc"))

# two calls: the first with its inputs and one step of a draw, fused and
# persistence, each with its launch; the second with its inputs and a step
# of fused
HOST = [("portbench.profiled", 0.0, 1000.0),
        ("crt.call", 10.0, 400.0), ("crt.aux", 12.0, 30.0), ("aten::empty", 20.0, 2.0),
        ("crt.upload", 45.0, 50.0), ("crt.step", 98.0, 307.0),
        ("crt.draws", 100.0, 40.0), ("crt.launch", 110.0, 20.0),
        ("cudaLaunchKernel", 115.0, 10.0),
        ("crt.fused", 150.0, 60.0), ("crt.launch", 170.0, 25.0), ("aten::slice", 220.0, 10.0),
        ("crt.persist", 300.0, 100.0), ("crt.launch", 350.0, 15.0),
        ("crt.call", 500.0, 300.0), ("crt.aux", 505.0, 20.0), ("crt.upload", 530.0, 30.0),
        ("crt.step", 590.0, 110.0), ("crt.fused", 600.0, 50.0), ("crt.launch", 610.0, 20.0)]
DEVICE = [("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", 90.0, 2.0),
          ("grain_kernel(RngArgs)", "kernel", 125.0, 40.0),
          ("void fused_strip_kernel<1, 0>(FusedArgs)", "kernel", 190.0, 100.0),
          ("void persist_kernel<true>(PersistArgs)", "kernel", 360.0, 30.0),
          ("void at::native::vectorized_elementwise_kernel<4>", "kernel", 400.0, 10.0),
          ("void fused_strip_kernel<1, 0>(FusedArgs)", "kernel", 625.0, 100.0)]


def ctx_of(host, device=DEVICE):
    return SimpleNamespace(trace=ptrace.Trace(device=list(device), host=list(host), calls=2,
                                              frames=32), library=LIBRARY, cfg=None,
                           dispatch_s=[])


def readers() -> dict:
    return {m: prun.load_module("metrics", m).read for m in READERS}


def test_the_span_readers_on_a_synthetic_trace(capsys):
    read = readers()
    ctx = ctx_of(HOST)
    assert read["call_ms"](ctx) == pytest.approx(0.35)  # the median of 400 and 300 us
    assert read["inputs_ms"](ctx) == pytest.approx((30 + 50 + 20 + 30) / 2 / 1e3)  # 80, 50
    assert read["launch_us"](ctx) == pytest.approx(80 / 4)
    assert read["wrapper_us"](ctx) == pytest.approx((40 + 60 + 100 + 50 - 80) / 4)
    err = capsys.readouterr().err
    assert "4 crt.launch spans, 4 kernels of the port's library" in err
    low, mid = map(float, re.search(r"inside them: min (\S+), median (\S+)", err).groups())
    assert low == pytest.approx(160 / 300) and mid == pytest.approx((160 / 300 + 387 / 400) / 2)
    assert ("before the first device operation: crt.upload 45.0, crt.aux 30.0, harness 10.0, "
            "crt.call 5.0") in err
    assert "after the last device operation: harness 200.0, crt.call 75.0" in err
    assert ("idle gap 215.0 us: harness 90.0, crt.call 40.0, crt.upload 30.0, crt.aux 20.0, "
            "crt.launch 15.0, crt.step 10.0, crt.fused 10.0") in err


def test_the_call_is_split_by_its_innermost_spans():
    tr = ptrace.Trace(device=DEVICE, host=HOST)
    assert spans.call_coverage(tr) == pytest.approx([387 / 400, 160 / 300])
    assert spans.owners(tr, 0.0, 160.0) == {
        "harness": 10.0, "crt.call": 8.0, "crt.aux": 30.0, "crt.upload": 50.0,
        "crt.step": 12.0, "crt.draws": 20.0, "crt.launch": 20.0, "crt.fused": 10.0}
    # the gaps between device operations, longest first: 410-625 from the
    # first call's end through the harness into the second call's inputs
    # and step; 290-360 in the first call's step and persistence wrapper
    top = spans.gaps(tr, top=2)
    assert top[0] == (215.0, {"harness": 90.0, "crt.call": 40.0, "crt.aux": 20.0,
                              "crt.upload": 30.0, "crt.step": 10.0, "crt.fused": 10.0,
                              "crt.launch": 15.0})
    assert top[1] == (70.0, {"crt.step": 10.0, "crt.persist": 50.0, "crt.launch": 10.0})
    assert len(spans.own_kernels(tr, LIBRARY)) == 4


def test_without_launches_the_launch_readers_give_none():
    read = readers()
    ctx = ctx_of([h for h in HOST if h[0] != "crt.launch"])  # the CPU: the plain twins
    assert read["call_ms"](ctx) == pytest.approx(0.35)
    assert read["launch_us"](ctx) is None and read["wrapper_us"](ctx) is None


def test_a_trace_without_the_ports_spans_gives_no_reading():
    read = readers()
    ctx = ctx_of([h for h in HOST if not h[0].startswith("crt.")])  # an older tree
    assert all(read[m](ctx) is None for m in READERS)
    ctx.trace = None
    assert all(read[m](ctx) is None for m in READERS)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the spans' launches are the port's kernels")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_a_traced_run_reads_the_spans(card, workload):
    r = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", workload,
                        "--seed", str(2**31 + 11), "--seconds", "2", "--trace", "1"], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert res["correct"] and set(READERS) <= set(res["metrics"])
    n_spans, n_kernels = map(int, re.search(
        r"launch_us: (\d+) crt.launch spans, (\d+) kernels", r.stderr).groups())
    assert n_spans == n_kernels > 0
    # the layers' spans hold at least 90% of a call at the median (the rest:
    # the call's checks and views before its first step)
    mid = float(re.search(r"inside them: min \S+, median (\S+)", r.stderr).group(1))
    assert mid >= 0.9, r.stderr[-3000:]
