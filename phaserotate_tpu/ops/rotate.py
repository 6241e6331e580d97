"""Offline (whole-buffer) phase rotation.

Public semantics match the reference end to end: rotating by ``d`` degrees
multiplies every positive-frequency component by ``e^{-j*theta}``
(``theta = 2*pi*d/360``), i.e. ``cos(w t) -> cos(w t - theta)``; sound and
loudness are unchanged, the waveform shape (and digital peak) moves.  See
core/angles.py for how this composes from the reference's negated-angle and
negated-FIR conventions (src/phaserotate.c:564-571, 700).

Two methods:

* ``spectral`` — ideal, zero-latency: one whole-signal real FFT, per-bin
  complex rotation, inverse FFT.  DC and Nyquist bins scale by cos(theta)
  (the exact limit of ``cos*x + sin*H(x)`` since H kills both).

* ``fir`` — the reference's windowed-FIR approximation (plugin geometry,
  src/phaserotate.c:374-401 + 640-717): for bit-close parity with the C
  plugin.  Output is time-aligned (the FIR group delay is compensated).

Both accept batched input ``(..., n)`` and broadcastable ``degrees`` so a
whole batch of stems/channels rotates at independent angles in one XLA call
(in place of the reference's thread-per-channel fan-out,
cli/phase-rotate.cc:437-444).
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core import angles as _angles
from ..core import fir as _fir
from ..core import sizes as _sizes
from .convolve import fft_convolve

__all__ = ["rotate", "rotate_spectral", "rotate_fir", "hilbert_fir"]


def _theta(degrees) -> jnp.ndarray:
    """Degrees -> rotation angle theta (radians), via the reference's
    clamped negated-turns representation so out-of-range inputs behave
    identically (src/phaserotate.c:564-571)."""
    turns = _angles.degrees_to_turns(degrees)
    return -_angles.turns_to_radians(turns)


@functools.partial(jax.jit, static_argnames=("n",))
def _rotate_spectral_impl(x: jnp.ndarray, theta: jnp.ndarray, n: int):
    X = jnp.fft.rfft(x, axis=-1)  # (..., n//2+1)
    nbins = X.shape[-1]
    theta = jnp.asarray(theta, jnp.float32)[..., None]
    rot = jnp.exp(-1j * theta.astype(jnp.complex64))
    # DC (and Nyquist for even n) are their own conjugate mirror: the
    # rotation operator cos*I + sin*H degenerates to cos there.
    k = jnp.arange(nbins)
    edge = (k == 0) | ((n % 2 == 0) & (k == nbins - 1))
    coef = jnp.where(edge, jnp.cos(theta).astype(jnp.complex64), rot)
    y = jnp.fft.irfft(X * coef, n=n, axis=-1)
    return y.astype(x.dtype)


def rotate_spectral(audio, degrees) -> jnp.ndarray:
    """Exact spectral phase rotation of ``audio`` (..., n) by ``degrees``
    (scalar or broadcastable to the leading dims)."""
    x = jnp.asarray(audio, jnp.float32)
    return _rotate_spectral_impl(x, _theta(degrees), x.shape[-1])


def hilbert_fir(
    audio,
    firlen: int,
) -> jnp.ndarray:
    """Apply the reference's windowed Hilbert FIR, time-aligned.

    Returns ``g(x)`` where ``g`` approximates the *negative* Hilbert
    transformer (the reference's FIR sign, core/fir.py); the group delay of
    ``firlen/2`` is already compensated.  Edge samples (within firlen/2 of
    either end) see the zero-padded boundary exactly as a freshly-activated
    plugin instance would.

    Single-partition OLA (partition == FIR support) as batched XLA FFTs.
    """
    x = jnp.asarray(audio, jnp.float32)
    lat = firlen // 2
    from ..core.fir import partition_fir_spectra
    from .convolve import partitioned_convolve

    spectra = partition_fir_spectra(firlen, firlen)
    full = partitioned_convolve(x, spectra, firlen)
    return full[..., lat : lat + x.shape[-1]]


@functools.partial(jax.jit, static_argnames=("firlen",))
def _rotate_fir_impl(x: jnp.ndarray, turns: jnp.ndarray, firlen: int):
    sa, ca = _angles.sin_cos_turns(turns)
    h = hilbert_fir(x, firlen)
    return (ca[..., None] * x + sa[..., None] * h).astype(x.dtype)


def rotate_fir(audio, degrees, rate: float = 48000.0,
               firlen: Optional[int] = None) -> jnp.ndarray:
    """FIR phase rotation with the plugin's filter (parity path).

    Matches the steady-state output of the LV2 plugin at sample rate
    ``rate`` after its ``parsiz + firlen/2`` latency is trimmed
    (src/phaserotate.c:297); tested to <1e-5 max-abs against the streaming
    engine in tests/test_rotate.py.
    """
    x = jnp.asarray(audio, jnp.float32)
    if firlen is None:
        firlen = _sizes.stream_geometry_for_rate(rate).firlen
    turns = _angles.degrees_to_turns(jnp.asarray(degrees, jnp.float32))
    return _rotate_fir_impl(x, turns, firlen)


def rotate(audio, degrees, method: str = "spectral", rate: float = 48000.0,
           firlen: Optional[int] = None) -> jnp.ndarray:
    """Rotate the phase of every frequency component of ``audio`` by
    ``degrees``.

    Args:
      audio: (..., n) float array — any leading batch/channel dims.
      degrees: scalar or broadcastable to ``audio.shape[:-1]``; positive
        values delay component phases (90 turns sin into -cos... see tests).
      method: ``"spectral"`` (exact, default) or ``"fir"`` (plugin parity).
      rate: sample rate, used only to pick the FIR geometry for ``"fir"``.
      firlen: explicit FIR length override for ``"fir"``.

    Returns the rotated signal, same shape and dtype float32, time-aligned
    (zero latency).
    """
    if method == "spectral":
        return rotate_spectral(audio, degrees)
    if method == "fir":
        return rotate_fir(audio, degrees, rate=rate, firlen=firlen)
    raise ValueError(f"unknown method {method!r}; expected 'spectral' or 'fir'")
