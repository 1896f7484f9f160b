"""The kernel library's build cache (kernels/_build.py), on the CPU.

A stand-in ``nvcc`` (a shell script: it writes each output file empty
and prints a ptxas line for each compile) and a stand-in loader take the
place of the CUDA toolkit and ``ctypes``, so these tests need neither.
They check that nvcc's log is kept beside the library and read back when
a later process finds the library built, which is where chip_smoke.py
reads each kernel's registers, stack frame and spill."""

import os
import re
import stat

import pytest

from pythoncrt_tpu_torch.kernels import _build

FAKE_NVCC = """#!/bin/sh
echo "$@" >> "$(dirname "$0")/calls.txt"
out=""; prev=""
for a in "$@"; do
  if [ "$prev" = "-o" ]; then out="$a"; fi
  prev="$a"
done
: > "$out"
case " $* " in
  *" -c "*) echo "ptxas info    : Compiling entry function 'k_$(basename "$out")'"
            echo "ptxas info    : Used 64 registers, 0 bytes stack frame";;
esac
"""


class FakeLib:
    """What the loader returns: any launcher name resolves."""

    class Fn:
        argtypes = restype = None

    def __getattr__(self, name):
        f = FakeLib.Fn()
        setattr(self, name, f)
        return f


@pytest.fixture
def fake_toolkit(tmp_path, monkeypatch):
    nvcc = tmp_path / "bin" / "nvcc"
    nvcc.parent.mkdir()
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setenv("NVCC", str(nvcc))
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: FakeLib())
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "build_log", "")
    monkeypatch.setattr(_build, "build_seconds", 0.0)

    def calls():
        f = nvcc.parent / "calls.txt"
        return f.read_text().splitlines() if f.exists() else []

    def new_process():
        _build._lib, _build.build_log, _build.build_seconds = None, "", 0.0
    return calls, new_process


def test_first_use_builds_and_keeps_the_log(fake_toolkit):
    calls, _ = fake_toolkit
    _build.library()
    assert len(calls()) == len(_build.SOURCES) + 1  # one compile per source, one link
    assert _build.build_log.count("Used 64 registers") == len(_build.SOURCES)
    out_dir = _build.BUILD_ROOT / _build._digest()
    assert (out_dir / "build.log").read_text() == _build.build_log
    assert sorted(os.listdir(out_dir)) == ["build.log", "libcrt_kernels.so"]


def test_cached_library_reads_its_log_back(fake_toolkit):
    """A second process finds the library built: nothing is compiled,
    and build_log is the build's, as chip_smoke.py [2] needs it."""
    calls, new_process = fake_toolkit
    _build.library()
    first, n = _build.build_log, len(calls())
    new_process()
    _build.library()
    assert len(calls()) == n
    assert _build.build_log == first and _build.build_seconds == 0.0
    assert "Compiling entry function" in _build.build_log


def test_library_without_its_log_is_rebuilt(fake_toolkit):
    """A library left by a build that kept no log is built again, so the
    log always belongs to the library beside it."""
    calls, new_process = fake_toolkit
    _build.library()
    n = len(calls())
    (_build.BUILD_ROOT / _build._digest() / "build.log").unlink()
    new_process()
    _build.library()
    assert len(calls()) == 2 * n
    assert _build.build_log.count("Used 64 registers") == len(_build.SOURCES)


@pytest.mark.parametrize("header", ["crt_common.cuh", "triad_pow.cuh"])
def test_included_headers_key_the_build(header, tmp_path, monkeypatch):
    """Every header a source includes is hashed with the sources: the
    direct-pow triad's pow sites (triad_pow.cuh, included by fused.cu and
    triad_sweep.cu) change the library's key when they change."""
    includes = {h for src in _build.SOURCES
                for h in re.findall(r'#include "([^"]+)"', (_build.CSRC / src).read_text())}
    assert includes == set(_build.HEADERS)
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in _build.SOURCES + _build.HEADERS:
        (csrc / name).write_bytes((_build.CSRC / name).read_bytes())
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = _build._digest()
    (csrc / header).write_text((csrc / header).read_text() + "\n// edited\n")
    assert _build._digest() != before
