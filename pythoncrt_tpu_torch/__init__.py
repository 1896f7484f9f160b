"""pythoncrt_tpu_torch — the CRT video effect renderer in PyTorch and CUDA.

A port of pythoncrt_tpu (JAX/Pallas for TPU) to one NVIDIA H100: the
same effect chain, CLI and parity contract (<= 1 uint8 LSB against the
NumPy oracle), with the TPU's Pallas kernels rewritten as CUDA C++
kernels for Hopper (csrc/). It imports neither JAX nor anything of
pythoncrt_tpu: the parameter core, oracle, CLI parser, media I/O and perf
report are the port's own copies (params.py, oracle/, cli.py, io/,
perf.py).
"""

__version__ = "0.1.0"

from .params import EffectParams, TextParams  # noqa: F401


def __getattr__(name):
    # Lazy imports keep `import pythoncrt_tpu_torch` light (no torch
    # import) for --help and preset tooling.
    import importlib

    if name in ("CRTEngine", "FrameAux"):
        return getattr(importlib.import_module(".engine", __name__), name)
    if name in ("process_video", "render_stream"):
        return getattr(importlib.import_module(".pipeline", __name__), name)
    if name == "process_videos":
        return getattr(importlib.import_module(".multiclip", __name__), name)
    if name == "MultiClipEngine":
        return getattr(importlib.import_module(".parallel", __name__), name)
    if name == "oracle":
        return importlib.import_module(".oracle", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
