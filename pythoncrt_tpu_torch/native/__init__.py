"""Native host-I/O extension: build-on-first-use with graceful fallback.

The port's copy of pythoncrt_tpu/native. The C module (_hostio.c)
provides GIL-released exact pipe reads and a BT.601 yuv420p->rgb24
converter for the decode path (``--pipe-format yuv420p``). It compiles
once (``cc``) into the port's own build directory,
``pythoncrt_tpu_torch/_build/hostio/``, keyed by the source, the Python
version and the platform; any failure (no compiler, sandbox, exotic
platform) falls back to pure-Python equivalents transparently: ``get()``
returns None and callers use the fallbacks in this module. This is host
I/O, not a device kernel.
"""

from __future__ import annotations

import hashlib
import importlib.util
import os
import subprocess
import sys
import sysconfig
from pathlib import Path

_SRC = Path(__file__).with_name("_hostio.c")
_mod = None
_tried = False


def _cache_dir() -> Path:
    return Path(__file__).resolve().parent.parent / "_build" / "hostio"


def _build() -> Path | None:
    src = _SRC.read_bytes()
    tag = hashlib.sha256(
        src + sys.version.encode() + sysconfig.get_platform().encode()
    ).hexdigest()[:16]
    ext = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    out = _cache_dir() / f"_hostio_{tag}{ext}"
    if out.exists():
        return out
    cc = os.environ.get("CC", "cc")
    include = sysconfig.get_path("include")
    out.parent.mkdir(parents=True, exist_ok=True)
    # per-process tmp: concurrent first-use builds (parallel batch jobs)
    # must not interleave writes into one tmp file; os.replace is atomic
    # and last-writer-wins with identical content
    tmp = out.with_suffix(out.suffix + f".tmp.{os.getpid()}")
    cmd = [
        cc, "-O3", "-shared", "-fPIC", "-std=c11",
        f"-I{include}", str(_SRC), "-o", str(tmp),
    ]
    try:
        res = subprocess.run(cmd, capture_output=True, timeout=120)
        if res.returncode != 0:
            return None
        os.replace(tmp, out)
        return out
    except (OSError, subprocess.TimeoutExpired):
        return None
    finally:
        try:
            if tmp.exists():
                os.unlink(tmp)
        except OSError:
            pass


def get():
    """The compiled _hostio module, or None if unavailable."""
    global _mod, _tried
    if _mod is not None or _tried:
        return _mod
    _tried = True
    if os.environ.get("PCRT_NO_NATIVE"):
        return None
    path = None
    try:
        path = _build()
        if path is None:
            return None
        # the loader resolves PyInit_<name>, which the C source defines
        # as PyInit__hostio
        spec = importlib.util.spec_from_file_location("_hostio", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _mod = mod
    except Exception:
        _mod = None
        # a corrupt cached .so (interrupted/raced build) must not
        # disable the native path forever: drop it so a later run
        # rebuilds instead of hitting the same broken file
        if path is not None:
            try:
                os.unlink(path)
            except OSError:
                pass
    return _mod


# ---------------- pure-Python fallbacks ----------------

def readinto_exact(f, buf: memoryview) -> int:
    """Exact-length read into ``buf`` from file object ``f``."""
    mod = get()
    if mod is not None:
        try:
            fd = f.fileno()
        except Exception:
            fd = None  # no real fd (BytesIO, ...): python fallback
        if fd is not None:
            # an OSError from the C read PROPAGATES: the native loop may
            # already have consumed a partial frame, and silently
            # restarting from the current pipe offset would shift every
            # later frame boundary (silent corruption, not an error)
            return mod.readinto_exact(fd, buf)
    got = 0
    n = len(buf)
    while got < n:
        r = f.readinto(buf[got:])
        if not r:
            break
        got += r
    return got


def yuv420p_to_rgb24(src: bytes, w: int, h: int):
    """Planar YUV 4:2:0 -> (h, w, 3) uint8 RGB, BT.601 limited range."""
    import numpy as np

    mod = get()
    out = np.empty((h, w, 3), np.uint8)
    if mod is not None:
        try:
            mod.yuv420p_to_rgb24(src, memoryview(out.reshape(-1)).cast("B"), w, h)
            return out
        except (ValueError, AttributeError):
            pass
    # vectorized NumPy fallback with identical integer arithmetic
    a = np.frombuffer(src, np.uint8)
    yp = a[: w * h].reshape(h, w).astype(np.int32)
    up = a[w * h: w * h + w * h // 4].reshape(h // 2, w // 2).astype(np.int32)
    vp = a[w * h + w * h // 4: w * h * 3 // 2].reshape(h // 2, w // 2).astype(np.int32)
    u = up.repeat(2, 0).repeat(2, 1)
    v = vp.repeat(2, 0).repeat(2, 1)
    c = 298 * (yp - 16)
    d = u - 128
    e = v - 128
    out[..., 0] = np.clip((c + 409 * e + 128) >> 8, 0, 255)
    out[..., 1] = np.clip((c - 100 * d - 208 * e + 128) >> 8, 0, 255)
    out[..., 2] = np.clip((c + 516 * d + 128) >> 8, 0, 255)
    return out
