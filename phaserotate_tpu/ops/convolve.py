"""Batched fast convolution primitives.

Two batched realizations of the reference's uniformly-partitioned
overlap-add convolution engine (src/phaserotate.c:615-662):

* :func:`fft_convolve` — one large real FFT over the whole (batched) signal.
  Best when the signal fits in HBM comfortably; XLA's FFT keeps the whole
  pipeline fused.

* :func:`partitioned_convolve` — frame the signal into ``parsiz`` blocks,
  run *batched* small FFTs over all frames at once, accumulate the per-
  partition complex products with a short shift-and-add over the segment
  axis, inverse-FFT all frames, overlap-add.  This is the same arithmetic as
  the reference's serial per-block loop, but every frame's transform runs in
  a single batched XLA FFT — the serial dependency of the C ring buffer is
  gone because overlap-add is associative.

Both compute the full linear convolution and agree to float32 roundoff.

``partitioned_convolve`` is jitted at this level: besides fusing, this
keeps its complex-valued intermediates inside compiled programs, so
callers never depend on eager complex support.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["fft_convolve", "partitioned_convolve", "next_pow2"]


def next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def fft_convolve(x: jnp.ndarray, fir: jnp.ndarray) -> jnp.ndarray:
    """Linear convolution of ``x`` (..., n) with ``fir`` (taps,) via one FFT.

    Returns shape (..., n + taps - 1), float32.
    """
    n = x.shape[-1]
    taps = fir.shape[-1]
    out_len = n + taps - 1
    fftlen = next_pow2(out_len)
    X = jnp.fft.rfft(x, n=fftlen, axis=-1)
    F = jnp.fft.rfft(fir, n=fftlen)
    y = jnp.fft.irfft(X * F, n=fftlen, axis=-1)
    return y[..., :out_len].astype(x.dtype)


def _frame(x: jnp.ndarray, parsiz: int) -> jnp.ndarray:
    """Split (..., n) into (..., n_frames, parsiz), zero-padding the tail."""
    n = x.shape[-1]
    n_frames = -(-n // parsiz)
    pad = n_frames * parsiz - n
    if pad:
        x = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, pad)])
    return x.reshape(*x.shape[:-1], n_frames, parsiz)


import functools


@functools.partial(jax.jit, static_argnames=("parsiz",))
def partitioned_convolve(
    x: jnp.ndarray,
    fir_spectra: jnp.ndarray,
    parsiz: int,
) -> jnp.ndarray:
    """Uniformly-partitioned OLA convolution.

    Args:
      x: (..., n) float32 signal.
      fir_spectra: (n_segm, parsiz+1, 2) float32 ri-format partitioned FIR
        spectra from :func:`phaserotate_tpu.core.fir.partition_fir_spectra`.
      parsiz: partition size (FFT length is 2*parsiz).

    Returns (..., (ceil(n/parsiz) + n_segm)*parsiz + parsiz): the full
    linear convolution of ``x`` with the ``n_segm*parsiz``-tap FIR, zero
    padded to whole frames (callers slice to the alignment they need).
    """
    from ..utils.cplx import from_ri

    fir_c = from_ri(fir_spectra)
    n_segm = fir_c.shape[0]
    fftlen = 2 * parsiz
    frames = _frame(x, parsiz)  # (..., B, parsiz)
    # flush frames so delayed partitions drain: full linear convolution
    frames = jnp.pad(
        frames, [(0, 0)] * (frames.ndim - 2) + [(0, n_segm), (0, 0)]
    )
    n_frames = frames.shape[-2]

    # Batched forward FFTs of every frame, zero-padded to fftlen.
    X = jnp.fft.rfft(frames, n=fftlen, axis=-1)  # (..., B, parsiz+1) c64

    # freq_sum[b] = sum_s X[b-s] * F[s]  (src/phaserotate.c:640-655) —
    # a short causal convolution along the frame axis, unrolled over the
    # at-most-12 segments; XLA fuses the adds.
    pad_cfg = [(0, 0)] * (X.ndim - 2) + [(n_segm - 1, 0), (0, 0)]
    Xp = jnp.pad(X, pad_cfg)  # (..., B + n_segm - 1, parsiz+1)
    freq_sum = jnp.zeros_like(X)
    for s in range(n_segm):
        start = n_segm - 1 - s
        freq_sum = freq_sum + (
            jax.lax.slice_in_dim(Xp, start, start + n_frames, axis=-2)
            * fir_c[s]
        )

    y = jnp.fft.irfft(freq_sum, n=fftlen, axis=-1)  # (..., B, fftlen)

    # Overlap-add: out[b*parsiz + i] = y[b, i] + y[b-1, parsiz + i]
    # (src/phaserotate.c:633, 660-662).
    head = y[..., :parsiz].reshape(*y.shape[:-2], n_frames * parsiz)
    tail = y[..., parsiz:].reshape(*y.shape[:-2], n_frames * parsiz)
    zeros = jnp.zeros((*y.shape[:-2], parsiz), y.dtype)
    out = jnp.concatenate([head, zeros], axis=-1) + jnp.concatenate(
        [zeros, tail], axis=-1
    )
    return out.astype(x.dtype)
