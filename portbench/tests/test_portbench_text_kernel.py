"""The stage-13 kernel's reader, ``text_kernel_ms``, on a synthetic trace,
and on the card a traced c5.batch run in which every device kernel is the
port's own: the text after the effects one launch a call of
``text_after_kernel``.

    python -m pytest portbench/tests/test_portbench_text_kernel.py
    python -m pytest --noconftest -m cuda portbench/tests/test_portbench_text_kernel.py
"""

import json
import os
import subprocess
import sys
from types import SimpleNamespace

import pytest

from portbench import run as prun
from portbench import trace as ptrace

ROOT = prun.ROOT


def test_text_kernel_ms_reads_the_stage_13_kernel(capsys):
    read = prun.load_module("metrics", "text_kernel_ms").read
    dev = [("void fused_strip_kernel<0, 4>(FusedArgs)", "kernel", 0.0, 300.0),
           ("text_after_kernel(TextArgs)", "kernel", 300.0, 6.0),
           ("glitch_kernel(GlitchArgs)", "kernel", 310.0, 20.0),
           ("void fused_strip_kernel<0, 4>(FusedArgs)", "kernel", 400.0, 300.0),
           ("text_after_kernel(TextArgs)", "kernel", 700.0, 4.0),
           ("text_after_kernel_probe(ProbeArgs)", "kernel", 710.0, 50.0)]
    ctx = SimpleNamespace(trace=ptrace.Trace(device=dev, calls=2, frames=32))
    assert read(ctx) == pytest.approx(10e-3 / 32)
    assert "2 launches of text_after_kernel over 2 calls (1.0 a call)" in capsys.readouterr().err
    ctx.trace = ptrace.Trace(device=[d for d in dev if not d[0].startswith("text_after_kernel(")],
                             calls=2, frames=32)
    assert read(ctx) is None  # a tree without the kernel
    ctx.trace = None
    assert read(ctx) is None


@pytest.mark.cuda
def test_c5_batch_runs_every_kernel_of_the_port():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the run's timed path is the port's kernels")
    r = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "c5.batch",
                        "--seed", str(2**31 + 23), "--seconds", "2", "--trace", "1"], cwd=ROOT,
                       capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-3000:]
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert res["correct"]
    m = {k: v["value"] for k, v in res["metrics"].items()}
    assert "text_after_ms" not in m and "torch_ops_ms" not in m
    assert 0 < m["text_kernel_ms"] < 0.01 and m["launches_per_frame"] == 0.5
    assert "(1.0 a call)" in r.stderr
    library = ptrace.library_kernels(os.path.join(ROOT, "pythoncrt_tpu_torch", "csrc"))
    assert "text_after_kernel" in library
