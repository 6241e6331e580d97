"""Device mesh helpers.

The reference's only parallelism is one pthread per audio channel
(cli/phase-rotate.cc:437-444).  The equivalents here are axes of a
``jax.sharding.Mesh``:

* ``files`` — data parallelism over a fleet of files/stems (replaces the
  thread fan-out; no collectives needed).
* ``samples`` — sequence parallelism *within* one long file: shards of the
  sample axis with a ``ppermute`` halo exchange for the convolution
  overlap and a ``pmax`` tree for the peak table (parallel/batch.py).

The mesh is built flat from ``jax.devices()``: every card reaches every
other at the same rate, so the mesh follows the algorithm alone.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec

__all__ = ["file_mesh", "grid_mesh", "shard_files"]


def file_mesh(n_devices: Optional[int] = None) -> Mesh:
    """1-D mesh over ``files`` (pure data parallelism).

    Raises if fewer than ``n_devices`` devices are visible — silently
    shrinking the mesh would shard the fleet differently than the caller
    laid it out.
    """
    devs = jax.devices()
    n = n_devices or len(devs)
    if n > len(devs):
        raise ValueError(
            f"requested a {n}-device mesh but only {len(devs)} "
            f"device(s) are visible"
        )
    return Mesh(np.array(devs[:n]), axis_names=("files",))


def grid_mesh(files: int, samples: int) -> Mesh:
    """2-D mesh: data parallel over files x sequence parallel over
    samples."""
    devs = jax.devices()
    if files * samples > len(devs):
        raise ValueError(
            f"requested a {files}x{samples} mesh but only {len(devs)} "
            f"device(s) are visible"
        )
    grid = np.array(devs[: files * samples]).reshape(files, samples)
    return Mesh(grid, axis_names=("files", "samples"))


def shard_files(x, mesh: Mesh):
    """Place a (files, ...) batch with the files axis sharded."""
    spec = PartitionSpec("files", *([None] * (x.ndim - 1)))
    return jax.device_put(x, NamedSharding(mesh, spec))
