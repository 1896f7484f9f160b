"""Dependency checking (reference crt_filter.py:17-47, redesigned).

The port's copy of pythoncrt_tpu/bootstrap.py, with PyTorch in place of
JAX among the core modules. The reference pip-installs its requirements
at import time; here one call reports exactly what is missing and how
to get it, as an explicit diagnostic and never a side effect.

`python -m pythoncrt_tpu_torch --check-deps` prints the report and exits 0/4.
"""

from __future__ import annotations

import importlib.util
from dataclasses import dataclass

# (module, pip name, needed for)
_CORE = (
    ("numpy", "numpy", "everything"),
    ("torch", "torch", "the PyTorch/CUDA engine"),
    ("cv2", "opencv-python-headless", "video decode/encode fallback"),
)
_OPTIONAL = (
    ("PIL", "Pillow", "text overlay rasterization"),
    ("PySide6", "PySide6", "the Qt GUI (CLI works without it)"),
)


@dataclass(frozen=True)
class DepReport:
    missing_core: tuple
    missing_optional: tuple

    @property
    def ok(self) -> bool:
        return not self.missing_core

    def render(self) -> str:
        lines = []
        if self.ok and not self.missing_optional:
            return "all dependencies present"
        for mod, pip, why in self.missing_core:
            lines.append(f"MISSING (required): {mod} — {why}; install with "
                         f"`pip install {pip}`")
        for mod, pip, why in self.missing_optional:
            lines.append(f"missing (optional): {mod} — {why}; install with "
                         f"`pip install {pip}`")
        return "\n".join(lines)


def check_deps() -> DepReport:
    """Report missing dependencies without importing them (find_spec
    only: no import-time side effects, unlike the reference)."""

    def missing(entries):
        return tuple(e for e in entries
                     if importlib.util.find_spec(e[0]) is None)

    return DepReport(missing(_CORE), missing(_OPTIONAL))
