"""Qt GUI guard (reference crt_filter.py:1272-2349).

The GUI requires PySide6, which headless GPU hosts typically lack; the
CLI is the primary surface. When PySide6 is importable the window is
provided by pythoncrt_tpu_torch.gui_qt; otherwise launch_gui reports the
situation and exits with status 3 instead of crashing.
"""

from __future__ import annotations

import sys


def qt_available() -> bool:
    try:
        import PySide6  # noqa: F401

        return True
    except ImportError:
        return False


def launch_gui(device: str = "cuda") -> int:
    if not qt_available():
        print(
            "GUI unavailable: PySide6 is not installed on this host.\n"
            "Use the CLI instead:  python -m pythoncrt_tpu_torch --input in.mp4 [flags]\n"
            "Run with --help for the full flag list (reference-compatible).",
            file=sys.stderr,
        )
        return 3
    from .gui_qt import run_app

    return run_app(device=device)
