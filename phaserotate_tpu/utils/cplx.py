"""Real/imag-pair complex representation.

The framework never lets complex values cross the host<->device
boundary: spectra live as float32 arrays with a trailing [real, imag] axis
("ri" format) and are combined with ``lax.complex`` only inside jit, where
XLA decomposes them back into real arithmetic anyway.  Complex64 thus only
ever exists as an intermediate inside a compiled program.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["from_ri", "to_ri", "np_to_ri"]


def from_ri(ri: jnp.ndarray) -> jnp.ndarray:
    """(..., 2) float32 -> (...) complex64.  Use only inside jit."""
    return jax.lax.complex(ri[..., 0], ri[..., 1])


def to_ri(c: jnp.ndarray) -> jnp.ndarray:
    """(...) complex -> (..., 2) float32.  Safe to return from jit."""
    return jnp.stack([jnp.real(c), jnp.imag(c)], axis=-1)


def np_to_ri(c: np.ndarray) -> np.ndarray:
    """Host-side complex -> (..., 2) float32."""
    return np.stack([c.real, c.imag], axis=-1).astype(np.float32)
