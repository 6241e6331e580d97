"""Sharded batch processing: fleet rotation and distributed angle search.

Two parallelization regimes (SURVEY.md §5 "distributed communication
backend"):

* **files axis** (data parallel): a batch of stems sharded over the mesh,
  every device sweeping/rotating its own files — in place of the
  reference's thread-per-channel fan-out.  No collectives; XLA's
  sharding propagation keeps everything local.

* **samples axis** (sequence parallel): one long file sharded across
  devices.  The partitioned convolution needs a ``parsiz``-sample left
  halo from the neighboring shard — fetched with one ``ppermute`` hop —
  and the per-angle peak table is combined with ``pmax``, replacing
  the reference's thread-join + std::max reduction
  (cli/phase-rotate.cc:295-298).  This is how hour-long masters are
  analyzed at O(shard) memory per device.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.angles import MAXSAMPLE, all_angle_cos_sin
from ..core.fir import offline_fir_spectrum
from ..core.sizes import OfflineGeometry
from ..kernels.choice import rotate_peak_sweep
from ..ops.convolve import partitioned_convolve
from ..ops.rotate import rotate_fir
from ..search.minimize import SearchResult, select_min_peak_angles_batch
from ..search.sweep import _sweep_impl

__all__ = [
    "batch_rotate",
    "batch_sweep_peaks",
    "batch_find_min_peak_angles",
    "sharded_sweep_peaks",
    "sharded_rotate",
    "angle_sharded_sweep_peaks",
]


def batch_rotate(audio, degrees, mesh: Mesh, rate: float = 48000.0):
    """Rotate a (files, ..., n) batch at per-file angles, files-sharded.

    Pure data parallelism: XLA keeps every file's FFTs on its own device.
    """
    x = jnp.asarray(audio, jnp.float32)
    d = jnp.asarray(degrees, jnp.float32)
    xspec = P("files", *([None] * (x.ndim - 1)))
    dspec = P("files", *([None] * (d.ndim - 1)))
    f = jax.jit(
        functools.partial(rotate_fir, rate=rate),
        in_shardings=(NamedSharding(mesh, xspec), NamedSharding(mesh, dspec)),
        out_shardings=NamedSharding(mesh, xspec),
    )
    return f(x, d)


def batch_sweep_peaks(audio, geom: OfflineGeometry, mesh: Mesh):
    """Peak tables for a (files, ..., n) batch, files-sharded.

    Returns (tables, rot0) exactly like search.sweep_peaks_aux, computed
    device-local per file shard.
    """
    x = jnp.asarray(audio, jnp.float32)
    xspec = P("files", *([None] * (x.ndim - 1)))
    f = jax.jit(
        lambda x: _sweep_impl(x, geom),
        in_shardings=(NamedSharding(mesh, xspec),),
        out_shardings=(
            NamedSharding(mesh, P("files", *([None] * (x.ndim - 1)))),
            NamedSharding(mesh, P("files", *([None] * (x.ndim - 2)))),
        ),
    )
    return f(x)


def batch_find_min_peak_angles(
    audio,
    geom: OfflineGeometry,
    mesh: Mesh,
    stride: int = 24,
    link_channels: bool = False,
    max_files_per_call: Optional[int] = None,
) -> list:
    """Full fleet search: sharded sweep on device, CLI-parity selection on
    host per file.

    Args:
      audio: (files, channels, n) float32.
      max_files_per_call: HBM-safe chunking — process at most this many
        files per device dispatch (rounded down to a mesh-divisible
        count); a fleet larger than device memory streams through in
        slices (SURVEY.md §5 failure-detection posture: OOM-safe
        chunking instead of elastic retry).

    Returns a list of :class:`SearchResult`, one per file.
    """
    audio = np.asarray(audio, np.float32)
    n_files = audio.shape[0]
    n_dev = mesh.shape["files"]
    if max_files_per_call is None:
        chunk_files = n_files
    else:
        chunk_files = max(n_dev, (max_files_per_call // n_dev) * n_dev)
    out = []
    for start in range(0, n_files, chunk_files):
        part = audio[start : start + chunk_files]
        # pad the last slice up to a mesh-divisible file count
        pad = (-len(part)) % n_dev
        if pad:
            part = np.concatenate(
                [part, np.zeros((pad, *part.shape[1:]), np.float32)])
        tables, rot0 = batch_sweep_peaks(part, geom, mesh)
        keep = len(part) - pad
        out.extend(select_min_peak_angles_batch(
            np.asarray(tables)[:keep], stride=stride,
            link_channels=link_channels, rot0=np.asarray(rot0)[:keep]))
    return out


def sharded_sweep_peaks(
    x,
    geom: OfflineGeometry,
    mesh: Mesh,
    axis: str = "samples",
    file_axis: Optional[str] = None,
):
    """Angle sweep of long signal(s) sharded along the sample axis.

    With ``file_axis`` set and 2-D input ``(files, n)``, composes sequence
    parallelism with data parallelism over a 2-D mesh: each mesh row owns
    a file shard, each column a sample shard; the halo/pmax collectives
    run over ``axis`` only.

    Implements the whole-file evaluation map of search/sweep.py with the
    stream positions split across devices:

    * each device holds ``S`` output positions and fetches a
      ``parsiz``-sample left halo from its neighbor via ``ppermute``
      (device 0 receives zeros — exactly the pre-file zero history);
    * device 0 masks its first ``parsiz`` positions out of the aligned
      sweep (the reference's start block pairs them with zeros) and
      contributes the start-region term instead;
    * per-device partial tables reduce with ``pmax`` — every device
      returns the full replicated (MAXSAMPLE,) table.

    The input must be padded so the flush block is included:
    total = (ceil(n/parsiz)+1)*parsiz, divisible by the mesh axis size.
    """
    parsiz = geom.parsiz
    firlen = geom.firlen
    n_dev = mesh.shape[axis]
    x = jnp.asarray(x, jnp.float32)
    squeeze = x.ndim == 1
    if squeeze:
        x = x[None]
    n = x.shape[-1]
    n_blocks = -(-n // parsiz)
    total = (n_blocks + 1) * parsiz
    # pad total up so each device owns a whole number of parsiz blocks
    per_dev_blocks = -(-(total // parsiz) // n_dev)
    total = per_dev_blocks * parsiz * n_dev
    x_pad = jnp.pad(x, ((0, 0), (0, total - n)))

    spectra = offline_fir_spectrum(geom)[None]
    cs = all_angle_cos_sin()

    def one_signal(x_local):  # (S,) local sample shard of one file
        S = x_local.shape[-1]
        idx = jax.lax.axis_index(axis)
        # left halo: last parsiz samples of the left neighbor
        left_tail = x_local[-parsiz:]
        halo = jax.lax.ppermute(
            left_tail, axis, [(i, i + 1) for i in range(n_dev - 1)]
        )  # device 0 gets zeros
        xa = jnp.concatenate([halo, x_local])  # (parsiz + S,)

        # h[m] for local m: linear conv of xa sliced to the owned range
        h_full = partitioned_convolve(xa, spectra, parsiz)
        h_local = h_full[parsiz : parsiz + S]
        b0_local = xa[parsiz - firlen : parsiz - firlen + S]

        # device 0: first parsiz positions belong to the start block -> out
        # of the aligned sweep (they pair with pre-file zeros)
        mask = jnp.where(
            (idx == 0) & (jnp.arange(S) < parsiz), 0.0, 1.0
        ).astype(jnp.float32)
        peaks = rotate_peak_sweep(b0_local * mask, h_local * mask, cs)

        # start-region contribution (device 0 only):
        # |sin| * max|h[firlen:parsiz]|
        h_start = jnp.where(
            idx == 0, jnp.max(jnp.abs(h_local[firlen:parsiz])), 0.0)
        peaks = jnp.maximum(peaks, jnp.abs(cs[1]) * h_start)

        peaks = jax.lax.pmax(peaks, axis)
        rot0 = peaks[0]
        peaks = peaks.at[0].set(
            jax.lax.pmax(jnp.max(jnp.abs(x_local)), axis))
        return peaks, rot0

    def shard_fn(x_local):  # (F_local, S)
        return jax.vmap(one_signal)(x_local)

    fn = jax.jit(
        jax.shard_map(
            shard_fn,
            mesh=mesh,
            in_specs=P(file_axis, axis),
            out_specs=(P(file_axis), P(file_axis)),
            check_vma=False,
        )
    )
    peaks, rot0 = fn(x_pad)
    if squeeze:
        return peaks[0], rot0[0]
    return peaks, rot0


def sharded_rotate(
    x,
    degrees,
    mesh: Mesh,
    firlen: int = 3072,
    axis: str = "samples",
    file_axis: Optional[str] = None,
):
    """Sequence-parallel whole-file FIR rotation: one long signal's sample
    axis sharded across the mesh, each device convolving its shard with a
    two-sided ``firlen/2`` halo (``ppermute`` in both directions), then
    mixing locally.  Output stays sample-sharded —
    a multi-hour master rotates at O(shard) memory per device with zero
    host round trips.

    Matches :func:`phaserotate_tpu.ops.rotate_fir` exactly (edge devices'
    zero halos reproduce its zero-padded boundary); parity-tested on the
    virtual CPU mesh (tests/test_parallel.py).

    Args:
      x: (n,) or (files, n) float32.
      degrees: scalar or (files,) rotation angle(s).
      firlen: FIR taps (the stream geometry of the target rate).
      file_axis: mesh axis name for the files dim (2-D mesh composition).

    Returns the rotated signal(s), same shape, time-aligned.
    """
    from ..core.angles import degrees_to_turns, sin_cos_turns
    from ..core.fir import partition_fir_spectra

    lat = firlen // 2
    n_dev = mesh.shape[axis]
    x = jnp.asarray(x, jnp.float32)
    squeeze = x.ndim == 1
    if squeeze:
        x = x[None]
    n = x.shape[-1]
    n_files = x.shape[0]
    S = -(-n // n_dev)
    if S < lat:
        raise ValueError(
            f"shard size {S} < halo {lat}; use fewer devices or a "
            "longer signal")
    x_pad = jnp.pad(x, ((0, 0), (0, S * n_dev - n)))
    turns = jnp.broadcast_to(
        degrees_to_turns(jnp.asarray(degrees, jnp.float32)), (n_files,))

    spectra = partition_fir_spectra(firlen, firlen)

    def one_signal(x_local, t):  # (S,) local shard
        sa, ca = sin_cos_turns(t)
        right_perm = [(i, i + 1) for i in range(n_dev - 1)]
        left_perm = [(i + 1, i) for i in range(n_dev - 1)]
        left_halo = jax.lax.ppermute(
            x_local[-lat:], axis, right_perm)  # from left neighbor
        right_halo = jax.lax.ppermute(
            x_local[:lat], axis, left_perm)  # from right neighbor
        xa = jnp.concatenate([left_halo, x_local, right_halo])
        conv = partitioned_convolve(xa, spectra, firlen)
        h = conv[2 * lat : 2 * lat + x_local.shape[-1]]
        return ca * x_local + sa * h

    def shard_fn(x_local, t):  # (F_local, S), (F_local,)
        return jax.vmap(one_signal)(x_local, t)

    fn = jax.jit(
        jax.shard_map(
            shard_fn,
            mesh=mesh,
            in_specs=(P(file_axis, axis), P(file_axis)),
            out_specs=P(file_axis, axis),
            check_vma=False,
        )
    )
    y = fn(x_pad, turns)[..., :n]
    return y[0] if squeeze else y


def angle_sharded_sweep_peaks(
    x,
    geom: OfflineGeometry,
    mesh: Mesh,
    axis: str = "files",
):
    """Peak table with the ANGLE grid sharded across the mesh — the
    domain's tensor parallelism, completing the axes inventory next to
    data parallelism over files and sequence parallelism over samples.

    The signal is replicated; each device sweeps its MAXSAMPLE/n_dev
    slice of the 0.5-degree candidate grid (the sweep's work scales with
    the slice), and the slices ``all_gather`` into the full
    replicated table.  Right for short single files where neither the
    file nor the sample axis offers enough parallelism.

    Returns ``(peaks (..., MAXSAMPLE), rot0)`` exactly like
    :func:`phaserotate_tpu.search.sweep.sweep_peaks_aux` (parity-tested).
    """
    from ..search.sweep import aligned_pair

    n_dev = mesh.shape[axis]
    if MAXSAMPLE % n_dev:
        raise ValueError(
            f"{MAXSAMPLE} angles not divisible by {n_dev} devices")
    a_loc = MAXSAMPLE // n_dev
    x = jnp.asarray(x, jnp.float32)
    squeeze = x.ndim == 1
    if squeeze:
        x = x[None]
    cs_full = all_angle_cos_sin()  # (2, MAXSAMPLE)

    def shard_fn(x_rep):  # replicated signal on every device
        idx = jax.lax.axis_index(axis)
        cs = jax.lax.dynamic_slice_in_dim(
            cs_full, idx * a_loc, a_loc, axis=1)
        b0, b1, h_start, x_peak = aligned_pair(x_rep, geom)
        part = rotate_peak_sweep(b0, b1, cs)
        part = jnp.maximum(part, jnp.abs(cs[1]) * h_start[..., None])
        table = jax.lax.all_gather(part, axis, axis=-1, tiled=True)
        rot0 = table[..., 0]
        table = table.at[..., 0].set(x_peak)
        return table, rot0

    fn = jax.jit(
        jax.shard_map(
            shard_fn,
            mesh=mesh,
            in_specs=P(),
            out_specs=(P(), P()),
            check_vma=False,
        )
    )
    peaks, rot0 = fn(x)
    if squeeze:
        return peaks[0], rot0[0]
    return peaks, rot0
