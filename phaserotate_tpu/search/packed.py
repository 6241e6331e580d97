"""Packed lossless wire transport for fleet ingest.

The raw-PCM ingest path (sweep.pack_pcm16) ships 16 bits/sample; where
the host->device link binds the from-disk fleet, every bit shipped is
wall clock.  This module breaks the 16-bit floor *losslessly*:

  host side   fixed-order residual (iterated first difference, orders
              0..3 — the same family as FLAC's fixed predictors) +
              per-4096-sample-block minimal bit width, packed little-
              endian into an int32 word stream (vectorized numpy; the
              pack rides the fleet's decode thread, hidden under the
              wire transfer of the previous chunk)
  device side unpack IN-GRAPH with shifts/masks (a 2-word gather per
              sample), reconstruct with jnp.cumsum (the exact inverse
              of the k-th difference is k prefix sums — log-depth on
              the device, fully parallel), dequantize to float32

Reconstruction is bit-exact: residuals of int16 data stay within int32
at every order <= 3, and each prefix sum of a k-th difference is again
a (k-1)-th difference of the original, so no intermediate overflows.
The transport therefore feeds sweep/apply with values identical to the
pcm16 path (tests/test_packed.py asserts bitwise equality).

Why not Rice/arithmetic coding: their decode is bit-serial (unary
prefixes), which cannot be expressed as a vectorizable XLA program.
Fixed-width-per-block costs ~1.5-2 bits/sample over the entropy of a
Gaussian residual (the block max sits ~4 sigma up) — the price of a
decode that is three gathers and a scan.  BENCH
reports achieved bits/sample next to the link bandwidth so the
remaining distance to the entropy floor is explicit.

Reference workload being accelerated: the CLI's whole-fleet search
streams every file from disk through sf_readf_float
(cli/phase-rotate.cc:573-587); here disk -> residual
pack -> wire -> in-graph unpack -> batched sweep.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["PackedChunk", "pack_residual", "pack_adaptive",
           "unpack_residual", "sweep_peaks_aux_packed",
           "packed_bits_per_sample", "BLOCK", "MAX_ORDER"]

# Samples per width block.  Must be a multiple of 32 so every block's
# packed payload is word-aligned (4096 * w bits = 128*w words exactly),
# which keeps the in-graph bit addressing to one add + shift.
BLOCK = 4096
MAX_ORDER = 3
# Padded word counts snap to a geometric grid (5-bit mantissa): at
# most 1/16 extra wire, and the number of distinct compiled unpack
# programs stays ~16 per power of two of chunk size (in practice a
# fleet's chunks are near-identical in size, so one or two programs).
_GRID_MANTISSA_BITS = 5


def _grid_pad(need: int) -> int:
    """Smallest m * 2^e >= need with m in [16, 32)."""
    if need <= (1 << _GRID_MANTISSA_BITS):
        return 1 << _GRID_MANTISSA_BITS
    e = need.bit_length() - _GRID_MANTISSA_BITS
    return -(-need >> e) << e


@dataclasses.dataclass(frozen=True)
class PackedChunk:
    """One chunk's packed transport, ready for device_put.

    words:  (W,) int32 — the bit stream (W padded to WORD_GRID + 1
            slack word so the unpack's straddle gather never reads
            out of bounds).
    widths: (S, NB) int32 — bits/sample of each stream's blocks.
    woffs:  (S, NB) int32 — word offset of each block's payload.
    order:  (S,) int32 — fixed-predictor order per stream (0..3).
    n:      true samples per stream (static; NB*BLOCK >= n).
    shape:  the original (..., n) leading shape, restored by consumers.
    """

    words: np.ndarray
    widths: np.ndarray
    woffs: np.ndarray
    order: np.ndarray
    n: int
    shape: Tuple[int, ...]

    @property
    def wire_bytes(self) -> int:
        return (self.words.nbytes + self.widths.nbytes
                + self.woffs.nbytes + self.order.nbytes)


def _signed_width(mx: np.ndarray, mn: np.ndarray) -> np.ndarray:
    """Minimal signed bit width holding every value in [mn, mx]."""
    # need 2^(w-1) - 1 >= mx  and  -2^(w-1) <= mn
    hi = np.maximum(mx, 0).astype(np.int64)
    lo = np.maximum(-mn.astype(np.int64) - 1, 0)
    m = np.maximum(hi, lo)
    # w-1 bits of magnitude: smallest w-1 with 2^(w-1) > m
    return (np.where(m > 0,
                     np.floor(np.log2(np.maximum(m, 1))).astype(np.int64)
                     + 2,
                     1)).astype(np.int32)


def _pack_fixed_width(vals: np.ndarray, w: int) -> np.ndarray:
    """(m, BLOCK) int32 residuals -> (m, BLOCK*w//32) int32 words.

    Little-endian bit order: sample i occupies bits [i*w, (i+1)*w) of
    the block's stream.  Vectorized over all m blocks: the inner loop
    runs over the <= g sample slots of one word-group (g = lcm(w,32)/w
    samples fill g*w/32 words exactly), each slot a full-array shift+or.
    """
    import math

    g = 32 // math.gcd(w, 32)          # samples per word-group
    wpg = g * w // 32                  # words per group
    m = vals.shape[0]
    u = vals.astype(np.uint32) & np.uint32((1 << w) - 1)
    u = u.reshape(m, BLOCK // g, g)
    out = np.zeros((m, BLOCK // g, wpg), np.uint32)
    for s in range(g):
        bit = s * w
        k, sh = bit >> 5, bit & 31
        out[:, :, k] |= u[:, :, s] << np.uint32(sh)
        if sh + w > 32:
            out[:, :, k + 1] |= u[:, :, s] >> np.uint32(32 - sh)
    return out.reshape(m, BLOCK * w // 32).view(np.int32)


def pack_residual(x16: np.ndarray,
                  out_words: np.ndarray | None = None,
                  native: bool | None = None) -> PackedChunk:
    """Pack int16 PCM (..., n) into the residual wire format.

    ``out_words`` optionally supplies a preallocated int32 scratch
    buffer (>= worst case: 17 bits/sample + grid padding): the fleet's
    staging ring reuses one per slot, avoiding fresh-page faults on the
    1-core bench host.  The returned ``words`` is a VIEW into it —
    callers must not rewrite the buffer while a device transfer of the
    view may be in flight (same discipline as the pcm16 ring).

    ``native`` selects the wire_pack.cc packer (bit-identical, ~20x the
    numpy throughput, GIL released): None = use it when built, True =
    require it, False = numpy reference path.
    """
    x16 = np.ascontiguousarray(x16, np.int16)
    shape = x16.shape
    n = shape[-1]
    if native is not False:
        pk = _pack_residual_native(x16.reshape(-1, n), out_words, n,
                                   shape)
        if pk is not None:
            return pk
        if native:
            raise RuntimeError("native wire pack unavailable")
    streams = x16.reshape(-1, n).astype(np.int32)
    S = streams.shape[0]
    nb = -(-n // BLOCK)
    pad = nb * BLOCK - n
    if pad:
        streams = np.pad(streams, ((0, 0), (0, pad)))

    # residuals r_k = k-th difference; per-stream order choice by
    # total packed bits (FLAC's fixed-predictor selection, order cap
    # 3).  Two passes over the diffs instead of materializing all four
    # orders at once: the width tables are tiny, the residual arrays
    # are ~BLOCK*nb*S*4 bytes each, and the fleet host has one core.
    widths_k = []
    r = streams
    for k in range(MAX_ORDER + 1):
        if k:
            r = np.diff(r, axis=-1, prepend=0)
        blocks = r.reshape(S, nb, BLOCK)
        widths_k.append(
            _signed_width(blocks.max(axis=-1), blocks.min(axis=-1)))
    cost = np.stack([w.sum(axis=-1, dtype=np.int64) for w in widths_k])
    order = np.argmin(cost, axis=0).astype(np.int32)     # (S,)
    widths = np.take_along_axis(
        np.stack(widths_k), order[None, :, None], axis=0)[0]  # (S, nb)
    resid = np.empty_like(streams)
    r = streams
    for k in range(MAX_ORDER + 1):
        if k:
            r = np.diff(r, axis=-1, prepend=0)
        rows = order == k
        if rows.any():
            resid[rows] = r[rows]

    # word layout: blocks in (stream, block) order, each word-aligned
    lens = (widths.astype(np.int64) * (BLOCK // 32)).reshape(-1)
    woffs_flat = np.zeros(S * nb, np.int64)
    np.cumsum(lens[:-1], out=woffs_flat[1:])
    total = int(woffs_flat[-1] + lens[-1])
    # +1 slack word (the unpack's straddle gather reads wi+1), then
    # pad up to the grid so compiled-program count stays bounded
    wpad = _grid_pad(total + 1)
    if out_words is not None and out_words.size >= wpad:
        words = out_words[:wpad]
        words.fill(0)
    else:
        words = np.zeros(wpad, np.int32)
    woffs = woffs_flat.astype(np.int32).reshape(S, nb)

    rblocks = resid.reshape(S * nb, BLOCK)
    wflat = widths.reshape(-1)
    for w_val in np.unique(wflat):
        idx = np.nonzero(wflat == w_val)[0]
        packed = _pack_fixed_width(rblocks[idx], int(w_val))
        pos = woffs_flat[idx, None] + np.arange(packed.shape[1])[None, :]
        words[pos] = packed
    return PackedChunk(words=words, widths=widths, woffs=woffs,
                       order=order, n=n, shape=shape)


def _pack_residual_native(streams16: np.ndarray,
                          out_words: np.ndarray | None,
                          n: int, shape) -> PackedChunk | None:
    """wire_pack.cc path of :func:`pack_residual` (None if unbuilt)."""
    from ..io.native import pack_residual_raw

    S = streams16.shape[0]
    nb = -(-n // BLOCK)
    # worst case: the chosen order never beats order 0's <= 16 b/s
    cap = _grid_pad(S * nb * (BLOCK // 2) + 1)
    if out_words is not None and out_words.size >= cap:
        words = out_words[:cap]
    else:
        words = np.empty(cap, np.int32)
    widths = np.empty((S, nb), np.int32)
    woffs = np.empty((S, nb), np.int32)
    order = np.empty(S, np.int32)
    total = pack_residual_raw(streams16, words, widths, woffs, order)
    if total < 0:
        return None
    wpad = _grid_pad(total + 1)
    words = words[:wpad]
    words[total:] = 0  # slack word + grid padding
    return PackedChunk(words=words, widths=widths, woffs=woffs,
                       order=order, n=n, shape=shape)


def packed_bits_per_sample(chunk: PackedChunk) -> float:
    """Achieved wire bits per audio sample, metadata included."""
    n_samples = int(np.prod(chunk.shape[:-1])) * chunk.n
    return chunk.wire_bytes * 8.0 / max(1, n_samples)


def pack_adaptive(x16: np.ndarray, scratch: np.ndarray,
                  threshold: float = 0.9) -> PackedChunk | None:
    """Adaptive transport decision: pack iff it beats pcm16 by margin.

    Runs the native packer with ``scratch`` (int32) as both the word
    budget and the output buffer: the budget is ``threshold`` x the
    pcm16 wire size, so content whose residuals don't compress (fully
    noise-dominated material) aborts the pack mid-way and ships the
    plain 16-bit bitcast instead — the fleet never pays wire for a
    transport that doesn't win.  The 10% margin: the pack rides the
    staging thread and the in-graph unpack hides under the next chunk's
    transfer in the pipelined fleet, but in a serial pass both land on
    the critical path, where a few percent of bytes saved lose to the
    exposed pack+unpack time.  Returns None when pcm16 should be shipped (budget
    exceeded, or no native packer — the numpy pack is slower than the
    wire it would save).
    """
    from ..io.native import pack_residual_raw

    shape = x16.shape
    n = shape[-1]
    streams = x16.reshape(-1, n)
    S = streams.shape[0]
    nb = -(-n // BLOCK)
    budget = int(threshold * S * n * 16) // 32
    cap = min(scratch.size, _grid_pad(budget + 1))
    widths = np.empty((S, nb), np.int32)
    woffs = np.empty((S, nb), np.int32)
    order = np.empty(S, np.int32)
    total = pack_residual_raw(streams, scratch[:cap], widths, woffs,
                              order)
    if total < 0 or total > budget:
        return None
    wpad = _grid_pad(total + 1)
    if wpad > scratch.size:
        return None
    words = scratch[:wpad]
    words[total:] = 0
    return PackedChunk(words=words, widths=widths, woffs=woffs,
                       order=order, n=n, shape=shape)


def unpack_residual(words: jnp.ndarray, widths: jnp.ndarray,
                    woffs: jnp.ndarray, order: jnp.ndarray,
                    n: int) -> jnp.ndarray:
    """In-graph inverse of :func:`pack_residual`.

    (W,) int32 words + (S, NB) metadata -> (S, n) float32 in [-1, 1).
    Shifts/masks recover each block's fixed-width residuals (two-word
    straddle gather), then k prefix sums invert the k-th difference;
    the per-stream order select costs MAX_ORDER cumsums of the full
    stream — log-depth scans, far under the sweep's own FFT work.
    """
    S, nb = widths.shape
    u = jax.lax.bitcast_convert_type(words, jnp.uint32)

    w_rep = jnp.repeat(widths, BLOCK, axis=-1)        # (S, nsamp)
    off_rep = jnp.repeat(woffs, BLOCK, axis=-1)
    i_in = jnp.tile(jnp.arange(BLOCK, dtype=jnp.int32), nb)[None, :]
    bit = i_in * w_rep
    wi = off_rep + (bit >> 5)
    sh = (bit & 31).astype(jnp.uint32)
    u0 = u[wi]
    u1 = u[wi + 1]  # 1 slack word guaranteed by the pack's grid pad
    hi = jnp.where(sh == 0, jnp.uint32(0),
                   u1 << (jnp.uint32(32) - sh))
    v = (u0 >> sh) | hi
    v = v & ((jnp.uint32(1) << w_rep.astype(jnp.uint32)) - 1)
    s = (32 - w_rep).astype(jnp.uint32)
    r = jax.lax.bitcast_convert_type(
        v << s, jnp.int32) >> (32 - w_rep)            # sign extend

    x = r
    out = r
    for k in range(1, MAX_ORDER + 1):
        x = jnp.cumsum(x, axis=-1, dtype=jnp.int32)
        out = jnp.where(order[:, None] == k, x, out)
    return out[:, :n].astype(jnp.float32) * (1.0 / 32768.0)


@functools.partial(jax.jit, static_argnames=("n", "shape", "geom"))
def _sweep_impl_packed(words, widths, woffs, order, n: int, shape, geom):
    from .sweep import _sweep_impl

    x = unpack_residual(words, widths, woffs, order, n)
    return _sweep_impl(x.reshape(shape), geom)


def sweep_peaks_aux_packed(pk: PackedChunk, geom):
    """sweep.sweep_peaks_aux over the packed wire format.

    Value-identical to ``sweep_peaks_aux_pcm16`` of the same PCM (the
    unpack reproduces the int16 values exactly, then dequantizes with
    the same 1/32768).  Compiles once per (padded word count, shape,
    geometry) — the pack pads word counts to WORD_GRID so a fleet
    reuses a handful of programs.
    """
    return _sweep_impl_packed(
        jnp.asarray(pk.words), jnp.asarray(pk.widths),
        jnp.asarray(pk.woffs), jnp.asarray(pk.order),
        pk.n, pk.shape, geom)
