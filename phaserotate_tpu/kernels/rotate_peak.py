"""Fused rotate-and-peak sweep: a Pallas kernel lowered through Triton.

The counterpart of the reference's hand-written SIMD peak scans
(cli/dsp_peak_calc.h ``dsp_compute_peak``) and of the fused rotate+scan
inner loop (``calc_rotated_peak``, cli/phase-rotate.cc:98-121): one pass
over the samples computes ``ca*b0 + sa*b1`` for a block of candidate
angles and folds the abs-max in registers, never materializing the
(samples x angles) rotation matrix in device memory.

Grid: (signal, angle block, sample split).  Program instances run in
parallel and in no order, so nothing carries between them: each walks its
own span of sample tiles with a ``fori_loop`` (masked loads for the ragged
tail) and writes one partial maximum; XLA reduces the split axis.  Abs-max
is exact and order-free, so the table is reproducible bit for bit.

The product stays exact float32 on the CUDA cores: it is an elementwise
multiply-add, not a K=2 ``dot`` (which could run in TF32).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

__all__ = ["rotate_peak_sweep_kernel", "sweep_splits"]

# enough program instances to fill 132 SMs a few times over
_TARGET_PROGRAMS = 1024
# 4 warps measured fastest at the default block on the H100; 8 warps with
# 128-angle blocks spill registers
_NUM_WARPS = 4


def sweep_splits(signals: int, angle_blocks: int, n_tiles: int) -> int:
    """Sample splits per signal: enough programs to fill the device when
    the batch is small, never fewer than 4 tiles of work per program."""
    want = -(-_TARGET_PROGRAMS // max(1, signals * angle_blocks))
    return max(1, min(want, n_tiles // 4))


def _sweep_body(ca_ref, sa_ref, b0_ref, b1_ref, out_ref, *, n, tile,
                span_tiles):
    s = pl.program_id(2)
    ca = ca_ref[...][:, None]  # (BA, 1)
    sa = sa_ref[...][:, None]
    base = s * (span_tiles * tile)

    def body(i, acc):
        idx = base + i * tile + jnp.arange(tile)
        mask = idx < n
        x0 = pltriton.load(b0_ref.at[idx], mask=mask, other=0.0)
        x1 = pltriton.load(b1_ref.at[idx], mask=mask, other=0.0)
        prod = ca * x0[None, :] + sa * x1[None, :]  # (BA, T)
        return jnp.maximum(acc, jnp.abs(prod))

    acc = jax.lax.fori_loop(
        0, span_tiles, body, jnp.zeros((ca.shape[0], tile), jnp.float32))
    out_ref[...] = jnp.max(acc, axis=1)


@functools.partial(jax.jit, static_argnames=(
    "block_angles", "tile_len", "interpret"))
def rotate_peak_sweep_kernel(
    b0: jnp.ndarray,
    b1: jnp.ndarray,
    cos_sin: jnp.ndarray,
    block_angles: int = 32,
    tile_len: int = 512,
    interpret: bool = False,
) -> jnp.ndarray:
    """Fused angle-sweep peak: ``peaks[..., a] = max_m |cos[a]*b0[..., m]
    + sin[a]*b1[..., m]|``.

    Args:
      b0, b1: (..., n) float32 aligned dry/Hilbert signals; leading dims
        (files, channels, ...) flatten onto the grid's signal axis.
      cos_sin: (2, A) float32 stacked [cos; sin] — the full MAXSAMPLE
        table, or an angle SLICE (the angle-parallel mesh path).
      block_angles: angles per program (a power of two).
      tile_len: samples per loop step (a power of two).
      interpret: run the Pallas interpreter instead of compiling for the
        GPU — for CPU tests only; no caller passes it implicitly.

    Returns (..., A) float32 — the candidates of the reference's serial
    sweep (cli/phase-rotate.cc:409-428) for the whole batch.
    """
    batch_shape = b0.shape[:-1]
    n = b0.shape[-1]
    rows = 1
    for d in batch_shape:
        rows *= d
    b0 = b0.reshape(rows, n).astype(jnp.float32)
    b1 = b1.reshape(rows, n).astype(jnp.float32)

    a = cos_sin.shape[-1]
    n_ab = -(-a // block_angles)
    a_pad = n_ab * block_angles
    cs = jnp.pad(cos_sin.astype(jnp.float32), ((0, 0), (0, a_pad - a)))

    n_tiles = max(1, -(-n // tile_len))
    splits = sweep_splits(rows, n_ab, n_tiles)
    span_tiles = -(-n_tiles // splits)

    kernel = functools.partial(_sweep_body, n=n, tile=tile_len,
                               span_tiles=span_tiles)
    sig_spec = pl.BlockSpec((None, n), lambda r, j, s: (r, 0))
    ang_spec = pl.BlockSpec((block_angles,), lambda r, j, s: (j,))
    part = pl.pallas_call(
        kernel,
        grid=(rows, n_ab, splits),
        in_specs=[ang_spec, ang_spec, sig_spec, sig_spec],
        out_specs=pl.BlockSpec((None, None, block_angles),
                               lambda r, j, s: (r, s, j)),
        out_shape=jax.ShapeDtypeStruct((rows, splits, a_pad), jnp.float32),
        compiler_params=pltriton.CompilerParams(num_warps=_NUM_WARPS,
                                                num_stages=2),
        interpret=interpret,
        name="rotate_peak_sweep",
    )(cs[0], cs[1], b0, b1)
    return jnp.max(part, axis=1)[:, :a].reshape(*batch_shape, a)
