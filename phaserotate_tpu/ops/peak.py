"""Peak scanning and level math.

XLA-level equivalents of the reference's hand-written SIMD peak kernels
(cli/dsp_peak_calc.h — AVX/SSE2/NEON/vDSP ``dsp_compute_peak``) and of the
rotated-peak evaluator (cli/phase-rotate.cc:98-121).
:func:`rotated_peak_sweep` is the plain reference every sweep
implementation is tested against; :func:`rotated_peak_sweep_tiled` is the
XLA implementation the sweep runs where no kernel is chosen
(kernels/choice.py); kernels/rotate_peak.py is the fused GPU kernel.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["compute_peak", "rotated_peak", "rotated_peak_sweep",
           "rotated_peak_sweep_tiled", "coeff_to_db"]

# bound on the (rows, angles, tile) product one scan step materializes
_TILE_ELEMS = 1 << 24


def compute_peak(buf: jnp.ndarray, current=0.0) -> jnp.ndarray:
    """max(|buf|) folded with a running peak (dsp_peak_calc.h:27)."""
    buf = jnp.asarray(buf)
    peak = jnp.max(jnp.abs(buf), axis=-1) if buf.size else jnp.float32(0)
    return jnp.maximum(jnp.asarray(current, jnp.float32), peak)


def rotated_peak(b0: jnp.ndarray, b1: jnp.ndarray, sa, ca, current=0.0):
    """Peak of ``ca*b0 + sa*b1`` (cli/phase-rotate.cc:98-121)."""
    x = jnp.asarray(ca) * b0 + jnp.asarray(sa) * b1
    return compute_peak(x, current)


def rotated_peak_sweep(
    b0: jnp.ndarray,
    b1: jnp.ndarray,
    cos_sin: jnp.ndarray,
    chunk: int = 65536,
) -> jnp.ndarray:
    """Peak of ``cos[a]*b0 + sin[a]*b1`` for every angle ``a`` at once.

    Args:
      b0, b1: (n,) float32 — aligned input and Hilbert signals.
      cos_sin: (2, A) float32 — stacked [cos; sin] rows
        (core/angles.all_angle_cos_sin).
      chunk: samples per tile; the (chunk, 2) x (2, A) product and its
        abs-max reduce stay fused so the (n, A) rotation matrix is never
        materialized in HBM.

    Returns (A,) float32 peaks — the whole 720-angle sweep of
    cli/phase-rotate.cc:409-428 in one batched pass.
    """
    n = b0.shape[-1]
    n_chunks = -(-n // chunk)
    pad = n_chunks * chunk - n
    if pad:
        b0 = jnp.pad(b0, (0, pad))
        b1 = jnp.pad(b1, (0, pad))
    stacked = jnp.stack([b0, b1], axis=-1).reshape(n_chunks, chunk, 2)

    def body(carry, xs):
        prod = jnp.dot(
            xs, cos_sin, preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )
        return jnp.maximum(carry, jnp.max(jnp.abs(prod), axis=0)), None

    init = jnp.zeros((cos_sin.shape[-1],), jnp.float32)
    peaks, _ = jax.lax.scan(body, init, stacked)
    return peaks


def rotated_peak_sweep_tiled(
    b0: jnp.ndarray,
    b1: jnp.ndarray,
    cos_sin: jnp.ndarray,
) -> jnp.ndarray:
    """Batched sweep in plain XLA: ``max_m |cos[a]*b0[..., m] +
    sin[a]*b1[..., m]|`` as a broadcast multiply-add and abs-max over
    sample tiles, exact float32 (no ``dot``, so no reduced-precision
    matrix unit is involved).

    Args:
      b0, b1: (..., n) float32.
      cos_sin: (2, A) float32.

    Returns (..., A) float32.  The tile length adapts to the batch so one
    scan step holds at most ``_TILE_ELEMS`` products.
    """
    batch_shape = b0.shape[:-1]
    n = b0.shape[-1]
    a = cos_sin.shape[-1]
    rows = int(np.prod(batch_shape, dtype=np.int64))
    tile = 1 << max(7, min(13, (_TILE_ELEMS // max(1, rows * a))
                           .bit_length() - 1))
    n_tiles = max(1, -(-n // tile))
    pad = [(0, 0)] * len(batch_shape) + [(0, n_tiles * tile - n)]
    # zero padding is exact: |0| never exceeds a peak
    s = jnp.stack([jnp.pad(b0, pad), jnp.pad(b1, pad)])
    s = jnp.moveaxis(s.reshape(2, rows, n_tiles, tile), 2, 0)
    ca = cos_sin[0][:, None]
    sa = cos_sin[1][:, None]

    def body(acc, xs):  # xs: (2, rows, tile)
        prod = ca * xs[0][:, None, :] + sa * xs[1][:, None, :]
        return jnp.maximum(acc, jnp.max(jnp.abs(prod), axis=-1)), None

    init = jnp.zeros((rows, a), jnp.float32)
    peaks, _ = jax.lax.scan(body, init, s)
    return peaks.reshape(*batch_shape, a)


def coeff_to_db(coeff) -> jnp.ndarray:
    """Linear coefficient -> dBFS; -inf below 1e-15
    (cli/phase-rotate.cc:76-83)."""
    coeff = jnp.asarray(coeff, jnp.float32)
    return jnp.where(
        coeff < 1e-15,
        jnp.float32(-np.inf),
        20.0 * jnp.log10(jnp.maximum(coeff, 1e-30)),
    )
