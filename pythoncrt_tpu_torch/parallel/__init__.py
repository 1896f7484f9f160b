"""Frame-axis and clip-axis sharding across CUDA devices (parallel/mesh.py)."""

from .mesh import (
    CLIP_AXIS,
    FRAME_AXIS,
    DeviceMesh,
    MultiClipEngine,
    ShardedCRTEngine,
    make_mesh,
    may_shard,
)

__all__ = [
    "CLIP_AXIS",
    "FRAME_AXIS",
    "DeviceMesh",
    "MultiClipEngine",
    "ShardedCRTEngine",
    "make_mesh",
    "may_shard",
]
