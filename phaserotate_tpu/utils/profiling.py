"""Tracing / profiling hooks.

The reference ships none (SURVEY.md §5) — only commented-out compiler
vectorization reports.  Here the device pipeline gets first-class
observability: ``jax.profiler`` trace capture around any stage, and a
lightweight wall-clock stage timer with readback barriers (a scalar
readback, so a stage's time covers its device work, not the enqueue).
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Iterator, Optional

import jax
import jax.numpy as jnp

__all__ = ["StageTimer", "device_trace", "sync"]


def sync(*arrays) -> None:
    """Barrier that actually waits: force a scalar readback."""
    for a in arrays:
        if hasattr(a, "block_until_ready"):
            a.block_until_ready()
    if arrays:
        leaves = jax.tree_util.tree_leaves(arrays)
        if leaves:
            jnp.asarray(leaves[0]).sum().item()


class StageTimer:
    """Accumulating per-stage wall-clock timer.

    Example::

        t = StageTimer()
        with t.stage("hilbert"):
            h = hilbert_offline(x, geom); sync(h)
        print(t.report())
    """

    def __init__(self) -> None:
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            t = self.totals[name]
            c = self.counts[name]
            lines.append(f"{name:24s} {t * 1e3:9.2f} ms  ({c}x, "
                         f"{t / c * 1e3:.2f} ms avg)")
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(log_dir: str) -> Iterator[None]:
    """Capture a jax.profiler trace (TensorBoard format) for the scope."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
