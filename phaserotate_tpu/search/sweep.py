"""Batched min-peak angle sweep.

The reference CLI walks the file block by block, computes the Hilbert
transform once per block, then serially evaluates ~720 candidate angles per
block with SIMD peak scans (cli/phase-rotate.cc:389-428).  Here the whole
file's Hilbert signal is computed in one batched partitioned convolution and
*all* candidate angles are evaluated together by the rotate+peak sweep
(kernels/choice.py picks the fused GPU kernel or the tiled XLA version) —
no serial angle loop, no serial block loop, no (samples x angles)
materialization.

Alignment map (derived from cli/phase-rotate.cc:181-232, 389-428):

* stream position ``m`` of block ``k``, offset ``i``: ``m = k*parsiz + i``
* Hilbert output ``hil[i]`` of block ``k`` is the linear convolution
  ``(fir * x)[m]`` (fir support ``parsiz`` taps, group delay ``firlen =
  parsiz/2``)
* the paired "dry" sample is ``x[m - firlen]`` (``&tdc[firlen]``)
* evaluated sample set per angle != 0:
  - first block (``start`` flag): pairs ``hil[firlen..parsiz)`` with
    *pre-file zeros* (``tdc[firlen+i]`` lands in the zeroed previous
    block), i.e. contributes ``|sa|*max|h[m]|, m in [firlen, parsiz)``
  - all later blocks (including one final all-zero flush block,
    cli/phase-rotate.cc:585-586): aligned pairs for
    ``m in [parsiz, (B+1)*parsiz)``
* angle == 0 is special-cased to the raw input peak
  (cli/phase-rotate.cc:413-414).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..core.angles import MAXSAMPLE, all_angle_cos_sin
from ..core.fir import offline_fir_spectrum
from ..core.sizes import OfflineGeometry
from ..kernels.choice import rotate_peak_sweep
from ..ops.convolve import partitioned_convolve

__all__ = ["sweep_peaks", "sweep_peaks_aux", "sweep_peaks_aux_pcm16",
           "pack_pcm16", "apply_angles", "hilbert_offline"]


def _offline_frames(x: jnp.ndarray, parsiz: int) -> int:
    """Number of data blocks the CLI would read (silence-padded)."""
    return -(-x.shape[-1] // parsiz)


def hilbert_offline(x: jnp.ndarray, geom: OfflineGeometry) -> jnp.ndarray:
    """Full-stream Hilbert-FIR signal ``h[m] = (fir * x)[m]`` with the
    offline geometry, length ``(B+1)*parsiz`` (one flush block).

    Single-partition OLA, batched over all blocks at once — identical
    arithmetic to PhaseRotateProc::hilbert (cli/phase-rotate.cc:181-212).
    """
    parsiz = geom.parsiz
    n_blocks = _offline_frames(x, parsiz)
    spectra = offline_fir_spectrum(geom)[None]  # (1, parsiz+1, 2)
    full = partitioned_convolve(x, spectra, parsiz)
    return full[..., : (n_blocks + 1) * parsiz]


def aligned_pair(x: jnp.ndarray, geom: OfflineGeometry):
    """The evaluation operands of the CLI sweep (alignment map in the
    module docstring): returns ``(b0, b1, h_start, x_peak)`` where
    ``(b0, b1)`` are the aligned dry/Hilbert pairs for the post-start
    stream positions, ``h_start`` the start-block Hilbert peak and
    ``x_peak`` the raw input peak over every read block."""
    parsiz = geom.parsiz
    firlen = geom.firlen
    n_blocks = _offline_frames(x, parsiz)
    total = (n_blocks + 1) * parsiz

    pad = n_blocks * parsiz - x.shape[-1]
    x_pad = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, pad + parsiz)])

    h = hilbert_offline(x, geom)  # (..., total)

    # aligned pairs for m in [parsiz, total)
    b0 = x_pad[..., parsiz - firlen : total - firlen]  # x[m - firlen]
    b1 = h[..., parsiz:total]
    # start-block region: |sin| * max|h[firlen:parsiz]|
    # (cli/phase-rotate.cc:418-419)
    h_start = jnp.max(jnp.abs(h[..., firlen:parsiz]), axis=-1)
    x_peak = jnp.max(jnp.abs(x_pad), axis=-1)
    return b0, b1, h_start, x_peak


@functools.partial(jax.jit, static_argnames=("geom",))
def _sweep_impl(x: jnp.ndarray, geom: OfflineGeometry) -> tuple:
    b0, b1, h_start, x_peak = aligned_pair(x, geom)
    cs = all_angle_cos_sin()  # (2, 360)

    # every angle x every sample, batched over all leading dims, with the
    # implementation chosen for the backend (kernels/choice.py)
    peaks = rotate_peak_sweep(b0, b1, cs)
    peaks = jnp.maximum(peaks, jnp.abs(cs[1]) * h_start[..., None])
    # aux: the "rotated by 0" peak (max|b0| over the aligned region) —
    # what a fine window crossing 360 writes into table slot 0 via the
    # non-special-cased path (cli/phase-rotate.cc:415-422 with a == 0)
    rot0 = peaks[..., 0]
    # angle 0 proper: raw input peak over every read block incl.
    # silence pad (cli/phase-rotate.cc:413-414)
    peaks = peaks.at[..., 0].set(x_peak)
    return peaks, rot0


def sweep_peaks(audio, geom: OfflineGeometry) -> jnp.ndarray:
    """Peak level per candidate rotation angle.

    Args:
      audio: (..., n) float32 — channels/files in leading dims.
      geom: offline geometry (CLI block size).

    Returns (..., MAXSAMPLE) float32: ``peaks[..., a]`` is the digital peak
    after rotating by ``a`` half-degrees — the complete peak table that the
    CLI accumulates per block and per angle (cli/phase-rotate.cc:409-428),
    for *all* 360 table entries in one pass.
    """
    x = jnp.asarray(audio, jnp.float32)
    return _sweep_impl(x, geom)[0]


def sweep_peaks_aux(audio, geom: OfflineGeometry):
    """Like :func:`sweep_peaks` but also returns the (...,) "rotated at 0"
    aux peak needed for bit-exact fine-pass parity (see minimize.py)."""
    x = jnp.asarray(audio, jnp.float32)
    return _sweep_impl(x, geom)


def pack_pcm16(x16: np.ndarray) -> np.ndarray:
    """Bitcast int16 PCM to int32 pairs for device transport.

    The ingest path ships the raw 16-bit samples (half the bytes of
    float32) as int32 words and bitcasts back in-graph
    (:func:`_unpack_pcm16`).  Odd lengths get one zero pad sample
    (dropped again on device via the static true length)."""
    x16 = np.ascontiguousarray(x16, np.int16)
    if x16.shape[-1] % 2:
        pad = [(0, 0)] * (x16.ndim - 1) + [(0, 1)]
        x16 = np.pad(x16, pad)
    return x16.view(np.int32)


def _unpack_pcm16(packed: jnp.ndarray, n: int) -> jnp.ndarray:
    """(..., m) int32 -> (..., n) float32 in [-1, 1), in-graph."""
    x16 = jax.lax.bitcast_convert_type(packed, jnp.int16)
    x16 = x16.reshape(*packed.shape[:-1], -1)[..., :n]
    # dequantize (int16/32768, the PCM convention of _pcm_to_float in
    # io/wav.py) — fuses into the consumer's first convolution
    return x16.astype(jnp.float32) * (1.0 / 32768.0)


@functools.partial(jax.jit, static_argnames=("n", "geom"))
def _sweep_impl_pcm16(packed, n: int, geom: OfflineGeometry):
    return _sweep_impl(_unpack_pcm16(packed, n), geom)


def sweep_peaks_aux_pcm16(audio_i16, geom: OfflineGeometry):
    """:func:`sweep_peaks_aux` over raw int16 PCM.

    Fleet ingest path: ships HALF the bytes of float32 over the
    host->device link (as bit-packed int32 — see :func:`pack_pcm16`)
    and dequantizes on device, where the cast fuses into the sweep's
    first convolution.  Pair with ``io.read_audio_pcm16`` so a 16-bit
    file goes disk -> device without ever materializing host floats.
    """
    x = np.asarray(audio_i16)
    if x.dtype != np.int16:
        raise TypeError(f"expected int16 PCM, got {x.dtype}")
    return _sweep_impl_pcm16(jnp.asarray(pack_pcm16(x)), x.shape[-1],
                             geom)


@functools.partial(jax.jit, static_argnames=("geom",))
def _apply_impl(x, angle_units, geom: OfflineGeometry):
    parsiz = geom.parsiz
    firlen = geom.firlen
    n = x.shape[-1]
    n_blocks = _offline_frames(x, parsiz)
    total = (n_blocks + 1) * parsiz
    pad = n_blocks * parsiz - n
    x_pad = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, pad + parsiz)])

    h = hilbert_offline(x, geom)
    # y[m] = ca*x[m - firlen] + sa*h[m]; file output = y[firlen : firlen+n]
    # (write path skips blksiz/2 frames, cli/phase-rotate.cc:963-991)
    sin_t, cos_t = _lut_lookup(angle_units)
    x_del = x_pad[..., : total - firlen]
    x_del = jnp.pad(x_del, [(0, 0)] * (x.ndim - 1) + [(firlen, 0)])
    y = cos_t[..., None] * x_del + sin_t[..., None] * h
    return y[..., firlen : firlen + n]


def _lut_lookup(angle_units):
    from ..core.angles import sincos_lut

    s, c = sincos_lut()
    a = jnp.mod(jnp.asarray(angle_units) + MAXSAMPLE, MAXSAMPLE)
    return s[a], c[a]


def apply_angles(audio, angle_units, geom: OfflineGeometry) -> jnp.ndarray:
    """Apply per-channel rotations with the CLI's offline engine semantics.

    ``angle_units`` are integer half-degrees, broadcastable to the leading
    dims of ``audio``; negative values wrap modulo 180 degrees exactly like
    PhaseRotate::thr_apply (cli/phase-rotate.cc:463) — i.e. -10 deg applies
    as 170 deg (the peak-equivalent negated waveform).

    Returns the rotated file, same length, latency already compensated.
    """
    x = jnp.asarray(audio, jnp.float32)
    return _apply_impl(x, jnp.asarray(angle_units, jnp.int32), geom)
