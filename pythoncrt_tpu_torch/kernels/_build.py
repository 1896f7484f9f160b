"""Build and load the CUDA kernels under ``pythoncrt_tpu_torch/csrc``.

The ``.cu`` files have a plain C interface. At first use each is
compiled by its own ``nvcc`` process for Hopper (``sm_90a``), all started
together, and the objects are linked into one shared library under
``pythoncrt_tpu_torch/_build/<hash>/``, keyed by a hash of the sources,
the headers they include and the flags, and loaded with ``ctypes``. Nothing is built when the
package is imported: the CPU tests import every module on hosts without
``nvcc``. nvcc's output (ptxas's registers, stack and spill per kernel)
is kept beside the library as ``build.log`` and read back with it, so
``build_log`` holds it whether or not this process built the library.

Flags: ``-fmad=false`` keeps every multiply and add separately rounded,
as the reference's f32 chain is (the triad's 1024-bin quantize turns a
contracted ulp into a visible step). No ``--use_fast_math``: divisions
stay IEEE (``-prec-div=true`` is nvcc's default).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

from .. import perf

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_ROOT = PKG / "_build"
SOURCES = ("fused.cu", "warp.cu", "persist.cu", "glitch.cu", "bloom_walk.cu", "triad_sweep.cu",
           "rng.cu", "rng_sweep.cu", "text.cu")
# included by the sources: hashed with them
HEADERS = ("crt_common.cuh", "triad_pow.cuh", "box_muller.cuh")
KERNELS = ("crt_fused", "crt_warp", "crt_persist", "crt_glitch", "crt_walk", "crt_triad_sweep",
           "crt_rng", "crt_rng_sweep", "crt_text")
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-fmad=false",
    "-Xptxas", "-v",
)

_lock = threading.Lock()
_lib = None
build_log = ""       # nvcc's output of the build of the loaded library
build_seconds = 0.0  # 0.0 when the library was already built


def find_nvcc() -> str:
    for cand in (os.environ.get("NVCC"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(set CUDA_HOME or NVCC)")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def library() -> ctypes.CDLL:
    """The loaded kernel library, building it on first use."""
    global _lib, build_log, build_seconds
    with _lock:
        if _lib is not None:
            return _lib
        out_dir = BUILD_ROOT / _digest()
        so, log = out_dir / "libcrt_kernels.so", out_dir / "build.log"
        if so.exists() and log.exists():
            build_log = log.read_text()
        else:
            out_dir.mkdir(parents=True, exist_ok=True)
            nvcc, tag = find_nvcc(), os.getpid()
            objs = [out_dir / f"{Path(src).stem}.{tag}.o" for src in SOURCES]
            t0 = time.perf_counter()
            procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj),
                                       str(CSRC / src)], stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)
                     for src, obj in zip(SOURCES, objs)]
            logs = [p.communicate()[0] for p in procs]
            build_log = "".join(logs)
            for src, p in zip(SOURCES, procs):
                if p.returncode != 0:
                    raise RuntimeError(f"nvcc failed on {src} ({p.returncode}):\n{build_log}")
            tmp = out_dir / f"libcrt_kernels.{tag}.tmp.so"
            res = subprocess.run([nvcc, *ARCH, "-shared", "-o", str(tmp), *map(str, objs)],
                                 capture_output=True, text=True)
            build_seconds = time.perf_counter() - t0
            build_log += res.stdout + res.stderr
            if res.returncode != 0:
                raise RuntimeError(f"nvcc link failed ({res.returncode}):\n{build_log}")
            tmp_log = out_dir / f"build.{tag}.tmp.log"
            tmp_log.write_text(build_log)
            os.replace(tmp, so)
            os.replace(tmp_log, log)  # after the library: a log means a whole build
            for obj in objs:
                obj.unlink()
        lib = ctypes.CDLL(str(so))
        for k in KERNELS:
            f = getattr(lib, k + "_launch")
            f.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
            f.restype = ctypes.c_int
            getattr(lib, k + "_args_bytes").argtypes = []
            getattr(lib, k + "_args_bytes").restype = ctypes.c_int
        _lib = lib
        return lib


def launch(fn_name: str, args: ctypes.Structure, device) -> None:
    """Call a C launcher with its argument struct on the current stream of
    ``device`` (the operands' CUDA device) and raise if the launch was
    refused (the C side returns cudaGetLastError()). The device is made
    current around the call: a launch goes to the current device's
    context, and the launchers' cudaFuncSetAttribute (dynamic shared
    memory above 48 KB) acts on the current device only."""
    import torch

    with perf.span("crt.launch"):
        lib = library()
        size = getattr(lib, fn_name.replace("_launch", "_args_bytes"))()
        if size != ctypes.sizeof(args):
            raise RuntimeError(f"{fn_name}: argument struct is {ctypes.sizeof(args)} "
                               f"bytes in Python but {size} in C")
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            rc = getattr(lib, fn_name)(ctypes.byref(args), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"{fn_name} failed with CUDA error {rc}")
