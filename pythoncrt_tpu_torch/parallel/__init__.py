"""Clip-axis lockstep on one GPU (multi-GPU sharding: ROADMAP.md queue 1)."""

from .mesh import MultiClipEngine

__all__ = ["MultiClipEngine"]
