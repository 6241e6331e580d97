"""Streaming phase-rotation engine.

Functional re-design of the plugin's real-time path
(src/phaserotate.c:538-772).  The C version keeps a mutable input ring
(``buf_src``), re-FFTs every FIR partition's input segment on every block
(12 forward FFTs per 256 samples at 48 kHz), and overlap-adds into
``buf_out``.  Here the state is an explicit pytree carried through
``lax.scan`` and the engine keeps a *frequency delay line*: each input frame
is transformed once and its spectrum retained for the next ``n_segm``
blocks, so a block costs exactly one forward and one inverse FFT plus
``n_segm`` complex multiply-adds — strictly less work than the reference,
with identical arithmetic (the FFT of a frame does not depend on when it is
taken).

Latency and block semantics match the plugin exactly: output lags input by
``parsiz + firlen/2`` samples, the mix happens one ``parsiz`` block after
the input completes, and per-sample angle interpolation follows
src/phaserotate.c:673-709 (rate clamp ``parsiz*1e-6`` turns/sample,
wrap-around at +-180 deg).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import jax
import jax.numpy as jnp

from ..core.angles import degrees_to_turns
from ..core.fir import stream_fir_spectra
from ..core.sizes import StreamGeometry, stream_geometry_for_rate

__all__ = [
    "StreamState",
    "init_state",
    "host_angle_step",
    "stream_step",
    "stream_step_batched",
    "stream_process",
    "stream_process_bulk",
    "stream_process_batched",
    "rotate_streamed",
]


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class StreamState:
    """Per-channel streaming carry.

    Attributes:
      spec_hist: (n_segm, parsiz+1, 2) float32 — ri-format spectra of the
        last n_segm input frames, newest first (frequency delay line).
        Real/imag pairs rather than complex64 so the state pytree can cross
        the host<->device boundary (utils/cplx.py).
      time_hist: (n_segm//2 + 1, parsiz) float32 — recent input frames,
        newest first; row n_segm//2 is the FIR-group-delay-aligned input
        (the reference reads it from the ring at src/phaserotate.c:664-670).
      tail: (parsiz,) float32 — overlap-add tail of the previous inverse
        FFT (``time_data[parsiz:]``, src/phaserotate.c:633).
      angle: () float32 — current angle in negated turns
        (src/phaserotate.c:54).
    """

    spec_hist: jnp.ndarray
    time_hist: jnp.ndarray
    tail: jnp.ndarray
    angle: jnp.ndarray


def init_state(geom: StreamGeometry, channels: Tuple[int, ...] = ()) -> StreamState:
    """Zeroed state — the plugin's ``activate`` (src/phaserotate.c:511-520).

    ``channels`` prepends batch dims, e.g. ``(2,)`` for stereo; all engine
    functions broadcast over leading state dims via vmap.
    """
    shape = tuple(channels)
    return StreamState(
        spec_hist=jnp.zeros(
            (*shape, geom.n_segm, geom.parsiz + 1, 2), jnp.float32
        ),
        time_hist=jnp.zeros((*shape, geom.n_segm // 2 + 1, geom.parsiz), jnp.float32),
        tail=jnp.zeros((*shape, geom.parsiz), jnp.float32),
        angle=jnp.zeros(shape, jnp.float32),
    )


def _angle_step(
    angle: jnp.ndarray,
    target: jnp.ndarray,
    geom: StreamGeometry,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """One block's angle-ramp bookkeeping (src/phaserotate.c:673-709).

    Returns ``(new_angle, da, interpolating)`` — the per-sample slope
    ``da`` (0 when steady) and the post-block angle.  Shared by the
    sequential step and the bulk path so both mix with *identical*
    arithmetic."""
    parsiz = geom.parsiz
    da = target - angle
    # wrap around at +-180 deg (src/phaserotate.c:676-683)
    da = jnp.where(jnp.abs(da) > 0.5, da - jnp.sign(da) * 1.0, da)
    da = da * jnp.float32(geom.interp_nm)
    thresh = jnp.float32(geom.interp_th)
    clipped = jnp.abs(da) > thresh
    da = jnp.clip(da, -thresh, thresh)
    interpolating = target != angle
    new_angle = jnp.where(
        interpolating,
        jnp.where(clipped, angle + da * parsiz, target),
        angle,
    )
    return new_angle, jnp.where(interpolating, da, 0.0), interpolating


def host_angle_step(angle: "np.ndarray", target: "np.ndarray",
                    geom: StreamGeometry) -> "np.ndarray":
    """Numpy twin of :func:`_angle_step` (same float32 arithmetic).

    The pipelined plugin shell tracks the per-block angle recursion on
    the host so it never has to read ``state.angle`` back from the
    device mid-stream (a synchronous round trip that would defeat the
    dispatch pipeline).  Only feeds the metering ``angle_changed``
    flag (src/phaserotate.c:497-509); the device keeps its own carry.
    """
    import numpy as np

    angle = np.asarray(angle, np.float32)
    target = np.asarray(target, np.float32)
    da = (target - angle).astype(np.float32)
    da = np.where(np.abs(da) > np.float32(0.5),
                  (da - np.sign(da) * np.float32(1.0)).astype(np.float32),
                  da)
    da = (da * np.float32(geom.interp_nm)).astype(np.float32)
    thresh = np.float32(geom.interp_th)
    clipped = np.abs(da) > thresh
    da = np.clip(da, -thresh, thresh).astype(np.float32)
    interpolating = target != angle
    stepped = (angle + da * np.float32(geom.parsiz)).astype(np.float32)
    return np.where(interpolating,
                    np.where(clipped, stepped, target),
                    angle).astype(np.float32)


def _mix_apply(
    delayed_in: jnp.ndarray,
    hilb: jnp.ndarray,
    angle: jnp.ndarray,
    da: jnp.ndarray,
    interpolating: jnp.ndarray,
    parsiz: int,
) -> jnp.ndarray:
    """Apply the rotation mix given the block's angle/slope
    (src/phaserotate.c:700, 710-717)."""
    twopi = jnp.float32(2.0 * jnp.pi)
    idx = jnp.arange(parsiz, dtype=jnp.float32)
    rad = (angle + da * idx) * twopi  # sample i: pre-increment angle
    out_interp = jnp.cos(rad) * delayed_in + jnp.sin(rad) * hilb
    # steady state: constant coefficients (src/phaserotate.c:710-717)
    rad0 = angle * twopi
    out_const = jnp.cos(rad0) * delayed_in + jnp.sin(rad0) * hilb
    out = jnp.where(interpolating, out_interp, out_const)
    return out.astype(jnp.float32)


def _mix_block(
    delayed_in: jnp.ndarray,
    hilb: jnp.ndarray,
    angle: jnp.ndarray,
    target: jnp.ndarray,
    geom: StreamGeometry,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Rotation mix with click-free per-sample interpolation
    (src/phaserotate.c:673-717).  Returns (out_block, new_angle)."""
    new_angle, da, interpolating = _angle_step(angle, target, geom)
    out = _mix_apply(delayed_in, hilb, angle, da, interpolating,
                     geom.parsiz)
    return out, new_angle


@functools.partial(jax.jit, static_argnames=("geom",))
def stream_step(
    state: StreamState,
    frame: jnp.ndarray,
    target_degrees: jnp.ndarray,
    geom: StreamGeometry,
) -> Tuple[StreamState, jnp.ndarray]:
    """Process one ``parsiz``-sample input frame; returns the output frame
    that the plugin would emit while the *next* frame streams in.

    The block body mirrors src/phaserotate.c:629-719 with the FFT schedule
    hoisted into the frequency delay line.
    """
    from ..utils.cplx import from_ri, to_ri

    fir_spectra = from_ri(stream_fir_spectra(geom))
    target = degrees_to_turns(target_degrees)

    spec = jnp.fft.rfft(frame, n=geom.fftlen)  # zero-padded to fftlen
    spec_hist_c = jnp.concatenate(
        [spec[None], from_ri(state.spec_hist[:-1])], axis=0
    )
    spec_hist = to_ri(spec_hist_c)
    time_hist = jnp.concatenate([frame[None], state.time_hist[:-1]], axis=0)

    # sum_s X[s] * FIR[s]  (src/phaserotate.c:640-655)
    freq_sum = jnp.sum(spec_hist_c * fir_spectra, axis=0)
    y = jnp.fft.irfft(freq_sum, n=geom.fftlen)

    hilb = state.tail + y[: geom.parsiz]  # overlap-add (:660-662)
    tail = y[geom.parsiz :]

    delayed_in = time_hist[geom.n_segm // 2]  # firlen/2 delay (:664-670)
    out, new_angle = _mix_block(delayed_in, hilb, state.angle, target, geom)

    return (
        StreamState(spec_hist=spec_hist, time_hist=time_hist, tail=tail,
                    angle=new_angle),
        out,
    )


@functools.partial(jax.jit, static_argnames=("geom",))
def stream_step_batched(
    state: StreamState,
    frames: jnp.ndarray,
    target_degrees: jnp.ndarray,
    geom: StreamGeometry,
) -> Tuple[StreamState, jnp.ndarray]:
    """:func:`stream_step` vmapped over a leading channel/batch axis.

    One device dispatch advances every channel — in place of the
    reference's thread-per-channel fan-out
    (cli/phase-rotate.cc:437-444): channels ride the batch axis of the
    same FFTs instead of separate threads.

    Args:
      state: batched state from ``init_state(geom, (channels,))``.
      frames: (channels, parsiz) float32.
      target_degrees: (channels,) float32.
    """
    return jax.vmap(
        lambda s, f, t: stream_step(s, f, t, geom)
    )(state, frames, jnp.asarray(target_degrees, jnp.float32))


@functools.partial(jax.jit, static_argnames=("geom",))
def stream_process(
    state: StreamState,
    frames: jnp.ndarray,
    target_degrees: jnp.ndarray,
    geom: StreamGeometry,
) -> Tuple[StreamState, jnp.ndarray]:
    """Scan :func:`stream_step` over ``frames`` (n_frames, parsiz).

    ``target_degrees`` is per-frame (n_frames,) — the control-port value the
    plugin would read at each block boundary.
    """

    def body(carry, xs):
        frame, tgt = xs
        return stream_step(carry, frame, tgt, geom)

    return jax.lax.scan(body, state, (frames, target_degrees))


@functools.partial(jax.jit, static_argnames=("geom",))
def stream_process_batched(
    state: StreamState,
    frames: jnp.ndarray,
    target_degrees: jnp.ndarray,
    geom: StreamGeometry,
) -> Tuple[StreamState, jnp.ndarray]:
    """Scan over frames AND vmap over channels in one dispatch.

    Args:
      state: batched state from ``init_state(geom, (channels,))``.
      frames: (channels, n_frames, parsiz) float32.
      target_degrees: (channels,) float32 — one control read per host
        block, shared by every frame in it (src/phaserotate.c:564 reads
        the port once per run()).

    Returns (new_state, (channels, n_frames, parsiz) outputs).  The host
    shells use this to advance any number of complete frames in a single
    device round trip (a 256-sample-frame stream pushed in 8192-sample
    host blocks costs 1 dispatch instead of 32).
    """
    targets = jnp.asarray(target_degrees, jnp.float32)

    def per_channel(st, fr, tgt):
        return stream_process(
            st, fr, jnp.full((fr.shape[0],), tgt), geom)

    return jax.vmap(per_channel)(state, frames, targets)


@functools.partial(jax.jit, static_argnames=("geom",))
def angle_sequence(
    angle0: jnp.ndarray,
    target_degrees: jnp.ndarray,
    geom: StreamGeometry,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Unroll the per-block angle-ramp recursion for a frame sequence.

    The angle carry (src/phaserotate.c:673-709) is the only sequential
    dependency of the streaming engine that feeds the *output values*;
    it is scalar, so a whole bulk call's worth is resolved with one tiny
    scan.  Returns ``(angles, das, interpolating, final_angle)`` — the
    pre-block angle and slope each frame mixes with.
    """
    targets = degrees_to_turns(
        jnp.asarray(target_degrees, jnp.float32))

    def body(angle, tgt):
        new_angle, da, interp = _angle_step(angle, tgt, geom)
        return new_angle, (angle, da, interp)

    final_angle, (angles, das, interps) = jax.lax.scan(
        body, angle0, targets)
    return angles, das, interps, final_angle


@functools.partial(jax.jit, static_argnames=("geom",))
def stream_process_bulk(
    state: StreamState,
    frames: jnp.ndarray,
    target_degrees: jnp.ndarray,
    geom: StreamGeometry,
) -> Tuple[StreamState, jnp.ndarray]:
    """Vectorized equivalent of :func:`stream_process`: every frame's FFT
    in one batched transform instead of a sequential scan.

    The scan in :func:`stream_process` serializes what is almost entirely
    parallel work: the frequency delay line only *reads* past spectra, the
    OLA tail reaches back exactly one block, and the angle carry is scalar
    (resolved by :func:`angle_sequence` up front).  So the whole bulk call
    becomes: one batched rfft over all frames, a block-axis FIR MAC
    (static slices of the extended spectrum sequence), one batched irfft,
    a shifted add for the OLA, and the vmapped rotation mix — batched
    shapes for XLA, with identical per-block arithmetic.

    Same signature/semantics as :func:`stream_process` including the
    returned mid-stream state (bit-matching continuation; parity-tested).
    """
    from ..utils.cplx import from_ri, to_ri

    parsiz, n_segm = geom.parsiz, geom.n_segm
    fir_spectra = from_ri(stream_fir_spectra(geom))  # (n_segm, nbins)
    frames = jnp.asarray(frames, jnp.float32)
    n_frames = frames.shape[0]

    angles, das, interps, final_angle = angle_sequence(
        state.angle, target_degrees, geom)

    # ---- spectra of every frame in one transform ----
    spec = jnp.fft.rfft(frames, n=geom.fftlen)  # (n_frames, nbins)
    # extended sequence: E[j] = spectrum of global frame j - (n_segm-1)
    # (history rows are newest-first in the state)
    hist = from_ri(state.spec_hist)[n_segm - 2 :: -1] if n_segm > 1 \
        else spec[:0]
    E = jnp.concatenate([hist, spec], axis=0)

    # ---- frequency delay line MAC (src/phaserotate.c:640-655) ----
    freq_sum = E[n_segm - 1 : n_segm - 1 + n_frames] * fir_spectra[0]
    for s in range(1, n_segm):
        freq_sum = freq_sum + (
            E[n_segm - 1 - s : n_segm - 1 - s + n_frames] * fir_spectra[s])

    y = jnp.fft.irfft(freq_sum, n=geom.fftlen)  # (n_frames, fftlen)

    # ---- overlap-add: tail reaches back exactly one block ----
    tails = jnp.concatenate([state.tail[None], y[:-1, parsiz:]], axis=0)
    hilb = y[:, :parsiz] + tails

    # ---- group-delay-aligned dry signal (src/phaserotate.c:664-670) ----
    t_hist = state.time_hist[n_segm // 2 - 1 :: -1]
    ext_time = jnp.concatenate([t_hist, frames], axis=0)
    delayed_in = ext_time[:n_frames]

    out = jax.vmap(_mix_apply, in_axes=(0, 0, 0, 0, 0, None))(
        delayed_in, hilb, angles, das, interps, parsiz)

    new_state = StreamState(
        spec_hist=to_ri(jnp.flip(E, axis=0)[:n_segm]),
        time_hist=jnp.flip(ext_time, axis=0)[: n_segm // 2 + 1],
        tail=y[-1, parsiz:],
        angle=final_angle,
    )
    return new_state, out


def rotate_streamed(
    audio,
    degrees,
    rate: float = 48000.0,
    geom: StreamGeometry | None = None,
    trim_latency: bool = True,
    chunk_frames: int = 16384,
):
    """Rotate a whole signal through the streaming engine.

    Convenience wrapper reproducing exactly what an LV2 host pushing the
    full file through the plugin would get.  With ``trim_latency`` the
    ``parsiz + firlen/2`` delay is removed so the result aligns with
    :func:`phaserotate_tpu.ops.rotate`.

    Runs the vectorized bulk engine (:func:`stream_process_bulk`) in
    ``chunk_frames`` slices — the state carry between slices is exact, so
    arbitrarily long signals stream through at O(chunk) device memory
    (SURVEY.md §5 long-context posture).
    """
    if geom is None:
        geom = stream_geometry_for_rate(rate)
    x = jnp.asarray(audio, jnp.float32)
    n = x.shape[-1]
    parsiz = geom.parsiz
    # pad with latency worth of silence so the tail flushes
    pad_frames = -(-(n + geom.latency) // parsiz)
    total = pad_frames * parsiz
    x_pad = jnp.pad(x, (0, total - n))
    frames = x_pad.reshape(pad_frames, parsiz)
    targets = jnp.full((pad_frames,), jnp.float32(degrees))

    state = init_state(geom)
    outs = []
    for start in range(0, pad_frames, chunk_frames):
        state, out_frames = stream_process_bulk(
            state, frames[start : start + chunk_frames],
            targets[start : start + chunk_frames], geom)
        outs.append(out_frames.reshape(-1))
    y = jnp.concatenate(outs)
    if trim_latency:
        # the scan output already absorbs the parsiz pipeline delay (frame k
        # of the output is computed from input frame k); only the FIR group
        # delay remains.
        return y[geom.firlat : geom.firlat + n]
    return jnp.concatenate([jnp.zeros(parsiz, jnp.float32), y])[: n + geom.latency]
