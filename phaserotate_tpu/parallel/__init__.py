"""Sharded batch/fleet processing over device meshes."""

from .batch import (
    batch_find_min_peak_angles,
    batch_rotate,
    batch_sweep_peaks,
    angle_sharded_sweep_peaks,
    sharded_rotate,
    sharded_sweep_peaks,
)
from .mesh import file_mesh, grid_mesh, shard_files

__all__ = [
    "batch_find_min_peak_angles",
    "batch_rotate",
    "batch_sweep_peaks",
    "file_mesh",
    "grid_mesh",
    "shard_files",
    "angle_sharded_sweep_peaks",
    "sharded_rotate",
    "sharded_sweep_peaks",
]
