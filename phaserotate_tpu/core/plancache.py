"""Compilation planning and cache management.

The reference guards FFTW's planner with a global mutex and plans every
transform at instantiate time so the real-time path never plans
(src/phaserotate.c:43, 358-365 — "planning is not thread-safe, execute
is").  The XLA equivalent of "planning" is jit compilation: it is
thread-safe and cached per (function, shapes, static args), but the first
trace costs tens of milliseconds to seconds — unacceptable inside a
real-time callback.  This module provides the same discipline:

* :func:`warmup_stream` / :func:`warmup_offline` — compile every kernel a
  session will need *before* entering the processing loop (the plugin's
  instantiate-time planning);
* :func:`enable_persistent_cache` — on-disk compilation cache so plans
  survive process restarts (FFTW wisdom's role);
* :func:`enable_compile_cache` — the rule every entry point applies
  first: ``JAX_COMPILATION_CACHE_DIR`` when the environment sets it,
  otherwise one fixed directory inside the checkout.
"""

from __future__ import annotations

import os
from typing import Iterable, Optional, Tuple

import jax
import numpy as np

from .sizes import OfflineGeometry, StreamGeometry

__all__ = ["warmup_stream", "warmup_offline", "enable_persistent_cache",
           "enable_compile_cache", "CHECKOUT_CACHE_DIR"]

# fixed, never per-process: the cache key includes nothing that moves
CHECKOUT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def warmup_stream(geom: StreamGeometry, channels: int = 1,
                  bulk_frames: tuple = (2, 4, 8, 16, 32)) -> None:
    """Pre-compile the streaming step (and meter update) for ``geom``.

    Call before the first real-time block, like the plugin plans FFTs in
    instantiate (src/phaserotate.c:358-401); afterwards ``stream_step``
    dispatches from cache with no compile stalls.

    ``bulk_frames``: frame counts of the hosts' bulk scan path to warm
    (the shells bucket large blocks to powers of two; each distinct
    count is its own XLA program).  The default covers host blocks up
    to 32 frames (8192 samples @48k); trim it for faster warmup or
    extend for larger blocks.
    """
    import jax.numpy as jnp

    from ..meter import MeterConfig, init_meter_state, meter_block, meter_falloff
    from ..stream.engine import (
        init_state,
        stream_process_batched,
        stream_step_batched,
    )

    # the host shells dispatch the channel-batched step — warm that shape
    state = init_state(geom, (channels,))
    frames = jnp.zeros((channels, geom.parsiz), jnp.float32)
    st, out = stream_step_batched(
        state, frames, jnp.zeros(channels, jnp.float32), geom)
    out.block_until_ready()
    for k in bulk_frames:
        _, yk = stream_process_batched(
            state, jnp.zeros((channels, int(k), geom.parsiz), jnp.float32),
            jnp.zeros(channels, jnp.float32), geom)
        yk.block_until_ready()

    cfg = MeterConfig(rate=geom.rate, latency=geom.latency)
    m = init_meter_state(cfg)
    blk = np.zeros(geom.parsiz, np.float32)
    meter_block(m, blk, blk, meter_falloff(geom.rate, geom.parsiz),
                cfg.hold_samples, False)


def warmup_offline(
    geom: OfflineGeometry,
    lengths: Iterable[int],
    channels: int = 1,
) -> None:
    """Pre-compile the sweep/apply pipeline for each signal length.

    XLA compiles per shape; batch jobs with known file lengths warm them
    all up front (pad lengths to a common bucket to share one plan).
    """
    import jax.numpy as jnp

    from ..search.sweep import _apply_impl, _sweep_impl

    for n in lengths:
        x = jnp.zeros((channels, int(n)), jnp.float32)
        t, r = _sweep_impl(x, geom)
        t.block_until_ready()
        _apply_impl(x, jnp.zeros((channels,), jnp.int32), geom)


def enable_persistent_cache(path: str) -> None:
    """Persist compiled executables in ``path`` across processes (FFTW
    wisdom role)."""
    p = os.path.expanduser(path)
    os.makedirs(p, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", p)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)


def enable_compile_cache() -> str:
    """Apply the compile-cache rule of the entry points; returns the
    directory in use.

    With ``JAX_COMPILATION_CACHE_DIR`` set, JAX reads it itself and this
    sets nothing.  Otherwise the cache goes to :data:`CHECKOUT_CACHE_DIR`.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR", "").strip()
    if env:
        return env
    enable_persistent_cache(CHECKOUT_CACHE_DIR)
    return CHECKOUT_CACHE_DIR
