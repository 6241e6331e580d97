"""Fleet CLI: minimum-peak analysis/apply over MANY files at once.

The reference processes one file per invocation (cli/phase-rotate.cc
main); batch jobs shell-loop over it, paying a full coarse+fine pass per
file serially.  On an accelerator the economics invert — the sweep
batches hundreds of files into one device pass — so the framework ships
a first-class fleet front end:

    phase-rotate-fleet *.wav                     # analyze, print angles
    phase-rotate-fleet -l --checkpoint s.npz *.flac
    phase-rotate-fleet --apply --outdir out/ *.wav

Pipeline per batch: read -> decode straight to int16 PCM
(io.read_audio_pcm16 — no host floats for 16-bit sources) -> ship
bit-packed to the device -> batched sweep (all 360 angle-table entries
at once) -> vectorized CLI-parity selection.  Decode of batch k+1
overlaps the device pass of batch k, exactly like the serving pipeline.

Files bucket by (rate, channels, padded length); padding with silence
is EXACT for the peak table: beyond the flush block the Hilbert FIR has
fully rung out (its support is one partition), so zero blocks
contribute zero pairs — same tables as per-file runs (tested).

Sweeps persist via --checkpoint (utils/checkpoint.SweepCheckpoint):
interrupted fleets resume, and selection reruns (different stride/-l)
reuse stored tables without touching the device.
"""

from __future__ import annotations

import argparse
import sys
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .core.angles import SUBSAMPLE
from .core.sizes import offline_geometry
from .search.minimize import SearchResult, select_min_peak_angles_batch

__all__ = ["analyze_paths", "apply_paths", "main"]


def _bucket_key(rate: int, channels: int, n: int, parsiz: int):
    """Pad the block count to the next power of two: homogeneous
    fleets compile ONE device program per (rate, channels) group."""
    blocks = max(1, -(-n // parsiz))
    padded = 1 << (blocks - 1).bit_length()
    return rate, channels, padded * parsiz


def _probe(path: str) -> Tuple[int, int, int]:
    """(rate, channels, samples) from headers where possible — pass 1
    must not hold (or even produce) decoded audio for the whole fleet:
    a 1k-file job would pin ~10 GB, and lossy inputs would pay their
    decode twice (probe + stage).  io.probe_audio reads WAV/FLAC chunk
    headers and Ogg Vorbis/Opus identification + final-granule data;
    only headerless formats fall back to a decode."""
    from .io.audio import probe_audio

    return probe_audio(path)


def analyze_paths(
    paths: Sequence[str],
    blksiz: int = 0,
    stride: int = 12 * SUBSAMPLE,
    link_channels: bool = False,
    batch: int = 64,
    checkpoint: Optional[str] = None,
    progress=None,
    transport: str = "auto",
) -> Dict[str, Tuple[SearchResult, int]]:
    """Analyze many files -> {path: (SearchResult, rate)}.

    Files are decoded to int16 PCM on a background thread (overlapped
    with the device sweep of the previous batch), bucketed by geometry,
    zero-padded to the bucket length, and swept ``batch`` files per
    device dispatch.

    ``transport`` picks the host->device wire format: "pcm16" ships the
    raw 16-bit bitcast; "packed" ships the lossless residual transport
    (search/packed.py); "auto" packs on the staging thread and ships
    whichever is smaller per batch — compressible masters ride the
    packed wire, noisy ones skip the overhead.  All three are
    value-identical (the unpack is bit-exact).
    """
    from .io import read_audio_pcm16
    from .search.packed import (
        pack_adaptive,
        pack_residual,
        sweep_peaks_aux_packed,
    )
    from .search.sweep import sweep_peaks_aux_pcm16
    from .utils.checkpoint import SweepCheckpoint

    if transport not in ("auto", "pcm16", "packed"):
        raise ValueError(f"unknown transport {transport!r}")

    ckpt = None
    results: Dict[str, Tuple[SearchResult, int]] = {}

    # pass 1: header probes only — audio decodes lazily per batch, so
    # fleet memory stays O(batch), not O(fleet)
    buckets: Dict[tuple, List[str]] = {}
    meta: Dict[str, tuple] = {}
    for p in paths:
        rate, channels, n = _probe(p)
        geom = offline_geometry(rate, blksiz)
        if ckpt is None and checkpoint:
            ckpt = SweepCheckpoint(checkpoint, blksiz=geom.blksiz)
        key = _bucket_key(rate, channels, n, geom.parsiz)
        meta[p] = (rate, geom)
        if ckpt is not None and p in ckpt:
            table, rot0 = ckpt.get(p)
            results[p] = (select_min_peak_angles_batch(
                table[None], stride=stride, link_channels=link_channels,
                rot0=rot0[None])[0], rate)
            if progress:
                progress(p, results[p][0], cached=True)
            continue
        buckets.setdefault(key, []).append(p)

    pool = ThreadPoolExecutor(1)

    def stage(group: List[str], key):
        """Decode a batch; returns the transport object to dispatch —
        an int16 array (pcm16) or a PackedChunk.  Runs on the staging
        thread, so the pack overlaps the previous batch's device pass."""
        rate, channels, n_pad = key
        buf = np.zeros((len(group), channels, n_pad), np.int16)
        for i, p in enumerate(group):
            audio = read_audio_pcm16(p)[0]
            buf[i, :, : min(audio.shape[1], n_pad)] = \
                audio[:, :n_pad]
        if transport == "packed":
            return pack_residual(buf)
        if transport == "auto":
            scratch = np.empty(
                max(1 << 16, buf.size * 16 // 32), np.int32)
            pk = pack_adaptive(buf, scratch)
            if pk is not None:
                return pk
        return buf

    def dispatch(obj, geom):
        from .search.packed import PackedChunk

        if isinstance(obj, PackedChunk):
            return sweep_peaks_aux_packed(obj, geom)
        return sweep_peaks_aux_pcm16(obj, geom)

    def finish(pending, rate) -> None:
        """Force one in-flight sweep and emit its selections."""
        names, handles, _buf = pending
        tables = np.asarray(handles[0])
        rot0 = np.asarray(handles[1])
        sel = select_min_peak_angles_batch(
            tables, stride=stride, link_channels=link_channels,
            rot0=rot0)
        for i, p in enumerate(names):
            results[p] = (sel[i], rate)
            if ckpt is not None:
                ckpt.put(p, tables[i], rot0[i])
            if progress:
                progress(p, sel[i], cached=False)

    try:
        for key, group in buckets.items():
            rate, channels, n_pad = key
            geom = meta[group[0]][1]
            batches = [group[i : i + batch]
                       for i in range(0, len(group), batch)]
            fut = pool.submit(stage, batches[0], key)
            # one batch of readback slack: batch k's sweep is forced
            # only after batch k+1's transfer+sweep were dispatched, so
            # on a slow host->device link the wire streams continuously
            # instead of stalling on each readback (the staging buffer
            # rides in `pending` — device_put may read it async)
            pending = None
            for bi, names in enumerate(batches):
                obj = fut.result()
                if bi + 1 < len(batches):
                    fut = pool.submit(stage, batches[bi + 1], key)
                handles = dispatch(obj, geom)
                if pending is not None:
                    finish(pending, rate)
                pending = (names, handles, obj)
            if pending is not None:
                finish(pending, rate)
    finally:
        pool.shutdown()
    return results


def _apply_one(path: str, outdir: str, result: SearchResult,
               blksiz: int) -> str:
    import os

    from .io import read_audio, write_audio
    from .search.sweep import apply_angles

    audio, rate, meta = read_audio(path)
    geom = offline_geometry(rate, blksiz)
    y = np.asarray(apply_angles(
        np.atleast_2d(np.asarray(audio, np.float32)),
        np.asarray(result.angles_units), geom))
    dst = os.path.join(outdir, os.path.basename(path))
    write_audio(dst, y, rate, meta, like=path)
    return dst


def apply_paths(
    paths: Sequence[str],
    results: Dict[str, Tuple[SearchResult, int]],
    outdir: str,
    blksiz: int = 0,
    batch: int = 16,
    progress=None,
) -> Dict[str, str]:
    """Write rotated copies of many files with BATCHED device passes.

    The analyze pass is batched (analyze_paths); a per-file apply would
    undo that — one small dispatch and one fresh XLA compile per unique
    file length.  Here files bucket by (rate, channels, padded length)
    exactly like the sweep (zero-padding is EXACT for apply too: the
    Hilbert FIR is causal with one-partition support, so outputs at
    m < n never see the pad — parity-tested against per-file
    apply_angles), decode/encode ride a staging thread, and one device
    pass rotates ``batch`` files.

    Returns {path: written path}.
    """
    import os

    from .io import read_audio, write_audio
    from .search.sweep import apply_angles

    os.makedirs(outdir, exist_ok=True)
    written: Dict[str, str] = {}

    buckets: Dict[tuple, List[str]] = {}
    meta: Dict[str, tuple] = {}
    for p in paths:
        rate, channels, n = _probe(p)
        geom = offline_geometry(rate, blksiz)
        key = _bucket_key(rate, channels, n, geom.parsiz)
        meta[p] = (rate, geom)
        buckets.setdefault(key, []).append(p)

    pool = ThreadPoolExecutor(1)

    def stage(group: List[str], key):
        rate, channels, n_pad = key
        buf = np.zeros((len(group), channels, n_pad), np.float32)
        lens = []
        metas = []
        for i, p in enumerate(group):
            audio, _rate, m = read_audio(p)
            audio = np.atleast_2d(np.asarray(audio, np.float32))
            lens.append(audio.shape[1])
            metas.append(m)
            buf[i, :, : min(audio.shape[1], n_pad)] = audio[:, :n_pad]
        units = np.stack([
            np.broadcast_to(
                np.asarray(results[p][0].angles_units, np.int32),
                (channels,))
            for p in group])
        return buf, units, lens, metas

    def finish(pending, rate) -> None:
        names, handle, lens, metas = pending
        y = np.asarray(handle)
        for i, p in enumerate(names):
            dst = os.path.join(outdir, os.path.basename(p))
            write_audio(dst, y[i, :, : lens[i]], rate, metas[i],
                        like=p)
            written[p] = dst
            if progress:
                progress(p, dst)

    try:
        for key, group in buckets.items():
            rate, _channels, _n_pad = key
            geom = meta[group[0]][1]
            parts = [group[i : i + batch]
                     for i in range(0, len(group), batch)]
            fut = pool.submit(stage, parts[0], key)
            pending = None
            for bi, names in enumerate(parts):
                buf, units, lens, metas = fut.result()
                if bi + 1 < len(parts):
                    fut = pool.submit(stage, parts[bi + 1], key)
                handle = apply_angles(buf, units, geom)
                if pending is not None:
                    finish(pending, rate)
                pending = (names, handle, lens, metas)
            if pending is not None:
                finish(pending, rate)
    finally:
        pool.shutdown()
    return written


def main(argv=None) -> int:
    from .core.plancache import enable_compile_cache
    from .utils.platform import apply_platform_env

    apply_platform_env()
    enable_compile_cache()
    ap = argparse.ArgumentParser(
        prog="phase-rotate-fleet",
        description="Batched minimum-peak analysis over many files "
                    "(one device pass sweeps a whole batch).")
    ap.add_argument("files", nargs="+")
    ap.add_argument("-f", "--fftlen", type=int, default=0,
                    help="block size (as phase-rotate -f; 0 = rate/8)")
    ap.add_argument("-s", "--stride", type=int, default=12 * SUBSAMPLE,
                    help="coarse step in half-degrees (default 24)")
    ap.add_argument("-l", "--link", action="store_true",
                    help="link channels (cross-channel max)")
    ap.add_argument("--batch", type=int, default=64,
                    help="files per device dispatch (default 64)")
    ap.add_argument("--checkpoint", default=None,
                    help="sweep-table store for resumable fleets")
    ap.add_argument("--transport", default="auto",
                    choices=("auto", "pcm16", "packed"),
                    help="host->device wire format (auto: ship the "
                         "smaller of packed residuals / raw pcm16)")
    ap.add_argument("--apply", action="store_true",
                    help="write rotated copies of every file")
    ap.add_argument("--outdir", default=None,
                    help="output directory for --apply")
    args = ap.parse_args(argv)
    if args.apply and not args.outdir:
        ap.error("--apply requires --outdir")

    def show(path, res: SearchResult, cached: bool):
        note = "  (cached sweep)" if cached else ""
        for c, (deg, found) in enumerate(zip(res.angles_deg, res.found)):
            if found:
                print(f"{path}  ch {c + 1}: {deg:+.2f} deg{note}")
            else:
                print(f"{path}  ch {c + 1}: no improvement{note}")

    results = analyze_paths(
        args.files, blksiz=args.fftlen, stride=args.stride,
        link_channels=args.link, batch=args.batch,
        checkpoint=args.checkpoint, progress=show,
        transport=args.transport)

    if args.apply:
        apply_paths(
            args.files, results, args.outdir, blksiz=args.fftlen,
            batch=args.batch,
            progress=lambda _p, dst: print(f"wrote {dst}",
                                           file=sys.stderr))
    return 0


if __name__ == "__main__":
    sys.exit(main())
