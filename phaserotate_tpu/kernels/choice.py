"""The one place that decides which implementation a device operation runs.

The decision is made from what the code can observe, the backend JAX
runs on, and never from a user option:

* ``gpu`` — the angle sweep runs the compiled Pallas/Triton kernel
  (kernels/rotate_peak.py);
* any other backend (the CPU) — the plain XLA sweep
  (ops/peak.rotated_peak_sweep_tiled).

No backend gets the Pallas interpreter: it is reachable only through the
kernel's explicit ``interpret=True`` argument, which only tests pass.
The convolutions (ops/convolve.py) are plain XLA on every backend, where
the GPU lowers ``jnp.fft`` to cuFFT.
"""

from __future__ import annotations

from typing import Optional

import jax

__all__ = ["sweep_implementation", "rotate_peak_sweep"]

TRITON = "triton"
XLA = "xla"


def sweep_implementation(platform: Optional[str] = None) -> str:
    """Name of the sweep implementation for ``platform`` (default: the
    backend JAX runs on)."""
    platform = platform or jax.default_backend()
    return TRITON if platform == "gpu" else XLA


def rotate_peak_sweep(b0, b1, cos_sin):
    """``peaks[..., a] = max_m |cos[a]*b0[..., m] + sin[a]*b1[..., m]|``
    with the implementation chosen for the current backend."""
    if sweep_implementation() == TRITON:
        from .rotate_peak import rotate_peak_sweep_kernel

        return rotate_peak_sweep_kernel(b0, b1, cos_sin)
    from ..ops.peak import rotated_peak_sweep_tiled

    return rotated_peak_sweep_tiled(b0, b1, cos_sin)
