"""The port's native host I/O (pythoncrt_tpu_torch.native: a copy of
pythoncrt_tpu/native built into the port's own build directory) and its
dependency report (pythoncrt_tpu_torch.bootstrap, ``--check-deps``): the
JAX package's tests (tests/test_native.py, tests/test_bootstrap.py) run
against the port, and the converter is held byte for byte against the
JAX package's, native and pure-Python fallback alike."""

import os
import threading

import numpy as np
import pytest

from pythoncrt_tpu import native as jnative
from pythoncrt_tpu_torch import bootstrap as tboot
from pythoncrt_tpu_torch import cli as tcli
from pythoncrt_tpu_torch import native as tnative

from test_native import _yuv_ref


def test_builds_into_the_ports_own_directory():
    assert tnative._cache_dir() != jnative._cache_dir()
    assert "pythoncrt_tpu_torch" in str(tnative._cache_dir())
    if tnative.get() is None:
        pytest.skip("no C compiler available on this host")
    assert hasattr(tnative.get(), "readinto_exact") and hasattr(tnative.get(), "yuv420p_to_rgb24")


@pytest.mark.parametrize("path", ["native", "fallback"])
@pytest.mark.parametrize("w,h", [(64, 48), (32, 16), (1920, 1080)])
def test_yuv420p_to_rgb24_matches_jax(monkeypatch, path, w, h):
    """Seeded planar 4:2:0 buffers: the port's converter (its C module,
    or its NumPy fallback) equals the JAX package's native converter and
    the BT.601 reference, byte for byte."""
    src = np.random.default_rng(w + h).integers(0, 256, w * h * 3 // 2, np.uint8).tobytes()
    want = jnative.yuv420p_to_rgb24(src, w, h)
    if path == "fallback":
        monkeypatch.setattr(tnative, "_mod", None)
        monkeypatch.setattr(tnative, "_tried", True)
    elif tnative.get() is None:
        pytest.skip("no C compiler available on this host")
    got = tnative.yuv420p_to_rgb24(src, w, h)
    np.testing.assert_array_equal(got, want)
    if w * h <= 64 * 48:
        np.testing.assert_array_equal(got, _yuv_ref(src, w, h))


@pytest.mark.parametrize("path", ["native", "fallback"])
def test_readinto_exact_pipe(monkeypatch, path):
    """A 64 KiB payload written in 4 KiB pieces arrives whole; a short
    stream reads what there is."""
    if path == "fallback":
        monkeypatch.setattr(tnative, "get", lambda: None)
    r, w = os.pipe()
    payload = os.urandom(1 << 16)

    def writer():
        for i in range(0, len(payload), 4096):
            os.write(w, payload[i:i + 4096])
        os.close(w)

    t = threading.Thread(target=writer)
    t.start()
    buf = bytearray(len(payload) + 10)
    with os.fdopen(r, "rb", buffering=0) as f:
        got = tnative.readinto_exact(f, memoryview(buf))
    t.join()
    assert got == len(payload) and bytes(buf[:got]) == payload


def test_readinto_oserror_propagates(monkeypatch):
    """A mid-read OSError from the C loop propagates (it may have consumed
    part of a frame: a silent retry would shift every later frame)."""

    class FakeMod:
        @staticmethod
        def readinto_exact(fd, buf):
            raise OSError(5, "injected I/O error")

    monkeypatch.setattr(tnative, "get", lambda: FakeMod)
    r, w = os.pipe()
    try:
        with os.fdopen(r, "rb", buffering=0) as f:
            with pytest.raises(OSError, match="injected"):
                tnative.readinto_exact(f, memoryview(bytearray(4)))
    finally:
        os.close(w)


def test_corrupt_cached_so_recovers(tmp_path, monkeypatch):
    """A corrupt cached library is deleted on the failed load, and the
    next load builds it again."""
    monkeypatch.setattr(tnative, "_cache_dir", lambda: tmp_path)
    path = tnative._build()
    if path is None:
        pytest.skip("no C compiler available on this host")
    path.write_bytes(b"not an ELF")
    monkeypatch.setattr(tnative, "_mod", None)
    monkeypatch.setattr(tnative, "_tried", False)
    assert tnative.get() is None and not path.exists()
    monkeypatch.setattr(tnative, "_mod", None)
    monkeypatch.setattr(tnative, "_tried", False)
    assert tnative.get() is not None


def test_core_deps_present_here():
    rep = tboot.check_deps()
    assert rep.ok, rep.render()
    assert [m for m, _, _ in tboot._CORE] == ["numpy", "torch", "cv2"]


def test_check_deps_reports_and_exits_0(capsys):
    assert tcli.main(["--check-deps"]) == 0
    out = capsys.readouterr().out
    assert "PySide6" in out or "all dependencies present" in out


def test_missing_core_dep_fails_with_guidance(monkeypatch, capsys):
    real = tboot.importlib.util.find_spec

    def fake(name, *a, **k):
        return None if name == "torch" else real(name, *a, **k)

    monkeypatch.setattr(tboot.importlib.util, "find_spec", fake)
    rep = tboot.check_deps()
    assert not rep.ok and "pip install torch" in rep.render()
    assert tcli.main(["--check-deps", "--gui"]) == 4  # before any other work
    assert "MISSING (required): torch — the PyTorch/CUDA engine" in capsys.readouterr().out
