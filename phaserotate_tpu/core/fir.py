"""Hilbert-transformer FIR design.

The reference designs its FIR at instantiate time (src/phaserotate.c:374-401
for the plugin, cli/phase-rotate.cc:144-164 for the CLI): an ideal
90-degree-shift frequency response ``(0, ±1)`` with alternating imaginary
sign, brought to the time domain with an unnormalized inverse real FFT and
shaped with a Hann window.

All of FFTW's normalization constants in the reference (``0.5/firlen`` at
src/phaserotate.c:387, ``0.5/parsiz`` at :393 and cli/phase-rotate.cc:142)
algebraically cancel against FFTW's unnormalized transforms; expressed with
numpy-normalized FFTs the whole design reduces to::

    fir[n] = irfft(j * (-1)^k, n=L)[n] * 0.5 * (1 - cos(2*pi*n/L))

which is what we compute here (verified to < 1e-7 against an independent
closed-form series in tests/test_fir.py).

The alternating sign ``(-1)^k = e^{-j*pi*k}`` is a circular shift of L/2:
the impulse response is centered at L/2 (group delay L/2), and it is the
*negative* of the ideal Hilbert transformer, delayed — the rotation mixer's
negated-angle convention (core/angles.py) compensates.
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np

from .sizes import OfflineGeometry, StreamGeometry

__all__ = [
    "design_hilbert_fir",
    "partition_fir_spectra",
    "stream_fir_spectra",
    "offline_fir_spectrum",
]


@functools.lru_cache(maxsize=32)
def _design_hilbert_fir_np(length: int) -> np.ndarray:
    """Hann-windowed Hilbert FIR of ``length`` taps, float32, as numpy.

    Computed once per length in float64 and rounded to float32, matching the
    reference's double-precision windowing (src/phaserotate.c:387-391 does
    the window math in double).
    """
    if length % 2:
        raise ValueError(f"FIR length must be even, got {length}")
    half = length // 2
    k = np.arange(half + 1)
    # Ideal response: purely imaginary, alternating sign (src/phaserotate.c:375-379).
    spec = 1j * np.where(k & 1, -1.0, 1.0)
    # Imaginary parts of DC/Nyquist bins are discarded by the real inverse
    # transform, exactly as FFTW's c2r does.
    fir = np.fft.irfft(spec, n=length)
    n = np.arange(length)
    hann = 0.5 * (1.0 - np.cos(2.0 * np.pi * n / length))
    return (fir * hann).astype(np.float32)


def design_hilbert_fir(length: int) -> jnp.ndarray:
    """Return the windowed Hilbert FIR (``length`` taps, float32).

    Group delay is ``length/2`` samples.  ``-fir`` approximates the ideal
    Hilbert transformer delayed by ``length/2``: convolving ``x`` with
    ``fir`` yields ``-H(x)`` delayed, where ``H(cos) = sin``.
    """
    return jnp.asarray(_design_hilbert_fir_np(length))


@functools.lru_cache(maxsize=32)
def _partition_fir_spectra_np(length: int, parsiz: int) -> np.ndarray:
    """FIR split into uniform partitions, each zero-padded to ``2*parsiz``
    and forward-FFT'd: shape ``(n_segm, parsiz+1)`` complex64.

    Equivalent to the reference's per-segment r2c transforms
    (src/phaserotate.c:396-401), minus FFTW's normalization constant which
    cancels against the inverse transform in the convolution engine.
    """
    fir = _design_hilbert_fir_np(length)
    if length % parsiz:
        raise ValueError(f"FIR length {length} not divisible by parsiz {parsiz}")
    n_segm = length // parsiz
    segments = fir.reshape(n_segm, parsiz)
    padded = np.concatenate(
        [segments, np.zeros((n_segm, parsiz), np.float32)], axis=1
    )
    return np.fft.rfft(padded, axis=1).astype(np.complex64)


def partition_fir_spectra(length: int, parsiz: int) -> jnp.ndarray:
    """Partitioned FIR spectra ``(n_segm, parsiz+1, 2)`` float32 ri-format.

    Real/imag are stacked on the last axis because complex64 must never
    cross the host<->device boundary (utils/cplx.py);
    combine with :func:`phaserotate_tpu.utils.from_ri` inside jit.
    """
    c = _partition_fir_spectra_np(length, parsiz)
    return jnp.asarray(
        np.stack([c.real, c.imag], axis=-1).astype(np.float32)
    )


def stream_fir_spectra(geom: StreamGeometry) -> jnp.ndarray:
    """Partitioned ri-format spectra for the streaming engine's geometry."""
    return partition_fir_spectra(geom.firlen, geom.parsiz)


def offline_fir_spectrum(geom: OfflineGeometry) -> jnp.ndarray:
    """Single-partition ri-format FIR spectrum for the offline engine.

    The offline FIR support is ``parsiz`` taps with group delay ``parsiz/2``
    (cli/phase-rotate.cc:144-164); one partition of the full FFT size.
    """
    return partition_fir_spectra(geom.parsiz, geom.parsiz)[0]
