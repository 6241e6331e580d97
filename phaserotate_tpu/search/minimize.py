"""Minimum-peak angle selection: exact CLI-result parity.

The reference CLI runs a coarse sweep at ``stride`` half-degree steps,
collects candidate minima within 7 % of the coarse range, rewinds the file
and re-analyzes each candidate's neighborhood at step 1, then unwraps the
chosen angles to minimize inter-channel phase distance
(cli/phase-rotate.cc:779-948).

Here the full 720-entry peak table comes out of *one* batched sweep
(search/sweep.py), so no file rewinds or re-reads are needed — but the
selection below reproduces exactly the reference's visit order and
tie-breaking (``<=`` keeps the last candidate visited,
cli/phase-rotate.cc:885), so the chosen angles match the CLI bit for bit
given matching peak tables.

The implementation is **batched**: :func:`select_min_peak_angles_batch`
resolves a whole fleet of tables in vectorized numpy (the reference's
sequential scan has a closed form: with ``<=`` updates against a running
minimum, the final selection is the *last visited occurrence of the
global minimum*), keeping host-side selection from capping the
device-side sweep throughput.  :func:`select_min_peak_angles` is the
single-file wrapper.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..core.angles import MAXSAMPLE, SUBSAMPLE

__all__ = [
    "SearchResult",
    "select_min_peak_angles",
    "select_min_peak_angles_batch",
    "coeff_to_db",
]


def coeff_to_db(coeff: float) -> float:
    """cli/phase-rotate.cc:76-83."""
    if coeff < 1e-15:
        return float("-inf")
    return 20.0 * math.log10(coeff)


@dataclasses.dataclass
class SearchResult:
    """Per-file search outcome.

    Attributes:
      angles_units: chosen rotation per channel, half-degree units, already
        unwrapped (may be negative — same convention the CLI prints and
        applies).
      angles_deg: the same in degrees.
      peak_zero: per-channel peak at 0 deg (``r_zro``).
      peak_min: per-channel peak at the chosen angle (``r_min``).
      found: per-channel flag — False mirrors the CLI's "cannot find min"
        (constant-peak channels, cli/phase-rotate.cc:935-936).
      coarse_considered: candidate coarse angles per channel (diagnostics).
    """

    angles_units: List[int]
    angles_deg: List[float]
    peak_zero: List[float]
    peak_min: List[float]
    found: List[bool]
    coarse_considered: Dict[int, List[int]]

    def gain_db(self, c: int) -> float:
        """Attenuation gained: peak(0deg) - peak(min) in dB
        (cli/phase-rotate.cc:940-942)."""
        return coeff_to_db(self.peak_zero[c]) - coeff_to_db(self.peak_min[c])


def _validate_stride(stride: int) -> None:
    if stride < 1 or stride > 45 * SUBSAMPLE or MAXSAMPLE % stride:
        raise ValueError(
            "180 deg is not evenly dividable by given stride"
        )  # cli/phase-rotate.cc:668-671


def select_min_peak_angles_batch(
    peak_tables: np.ndarray,
    stride: int = 12 * SUBSAMPLE,
    link_channels: bool = False,
    rot0: Optional[np.ndarray] = None,
) -> List[SearchResult]:
    """Reproduce the CLI's coarse->fine selection on a fleet of tables.

    Args:
      peak_tables: (files, channels, MAXSAMPLE) float32 from
        :func:`phaserotate_tpu.parallel.batch_sweep_peaks`.
      stride: coarse step in half-degree units (default 24 = 12 deg,
        cli/phase-rotate.cc:597); must divide MAXSAMPLE and be <= 90.
      link_channels: use the cross-channel max peak for selection
        (``-l``, cli/phase-rotate.cc:639).
      rot0: optional (files, channels) "rotated by 0" aux peaks
        (sweep_peaks_aux): the value a fine window crossing 360 writes
        into table slot 0 via the generic path instead of the raw-input
        special case.

    Returns one :class:`SearchResult` per file, bit-matching the CLI.
    The comparison math runs in float64 exactly like the C++ (float
    table values promoted through ``double`` expressions).
    """
    _validate_stride(stride)
    tables = np.ascontiguousarray(
        np.asarray(peak_tables, np.float32), dtype=np.float32
    ).astype(np.float64)
    if tables.ndim != 3:
        raise ValueError(f"expected (files, channels, {MAXSAMPLE}) table")
    F, C, M = tables.shape
    r0 = None if rot0 is None else np.asarray(
        rot0, np.float32).astype(np.float64).reshape(F, C)

    linked = tables.max(axis=1)  # (F, M): pr.peak(-1, a)
    pv = (np.broadcast_to(linked[:, None, :], tables.shape)
          if link_channels else tables)

    # ---- coarse scan (cli/phase-rotate.cc:815-857) ----
    A = np.arange(0, M, stride)
    coarse = pv[:, :, A]  # (F, C, nA)
    c_min = coarse.min(-1)
    c_max = coarse.max(-1)
    degenerate = (c_max - c_min) == 0  # constant-peak channel: not found
    r_zro = tables[:, :, 0]

    if stride == 1:
        # rng = 0: candidates are the exact coarse minima; the final
        # assignment loop visits angles ascending, so the LAST minimum
        # wins (assignment, not <=-update, cli/phase-rotate.cc:853-858)
        cand = (pv == c_min[..., None]) & ~degenerate[..., None]
        min_angle = M - 1 - np.argmax(cand[:, :, ::-1], axis=-1)
        p_min = np.where(degenerate, np.inf, c_min)
        found = np.isfinite(p_min)
        min_angle = np.where(found, min_angle, 0)
        r_min = np.take_along_axis(
            tables, min_angle[..., None], -1)[..., 0]
        r_min = np.where(found, r_min, 0.0)
        cand_coarse = cand  # (F, C, M) for diagnostics (A == arange(M))
    else:
        thr = c_min + (c_max - c_min) * 0.07
        cand = (coarse <= thr[..., None]) & ~degenerate[..., None]
        cand_coarse = cand

        # ---- fine pass (cli/phase-rotate.cc:866-902): the visit order
        # is candidate angles ascending (std::map), offsets ascending;
        # with `p <= p_min` updates the final selection is the last
        # visited occurrence of the global minimum ----
        stride_2 = (stride + 1) // 2
        offs = np.arange(-stride_2, stride_2 + 1)
        ang = A[:, None] + offs[None, :]  # (nA, L) unwrapped
        w = ang % M
        un = tables[:, :, w]  # (F, C, nA, L) fine_peak(False, ...)
        if r0 is not None:
            # a fine window crossing 360 reads the rotated-at-0
            # accumulation, not the raw-input special slot
            rot0_case = (w == 0) & (ang != 0)
            un = np.where(rot0_case[None, None], r0[:, :, None, None], un)
        if link_channels:
            lk = linked[:, w]  # (F, nA, L)
            if r0 is not None:
                lk = np.where(rot0_case[None],
                              r0.max(axis=1)[:, None, None], lk)
            # reference quirk: a single-channel candidate re-analyzes
            # only that channel after pr.reset(), so in link mode
            # peak_all() degenerates to the candidate's own peak
            # (cli/phase-rotate.cc:880, 884)
            link_here = cand.sum(axis=1) > 1  # (F, nA)
            V = np.where(link_here[:, None, :, None],
                         lk[:, None], un)
        else:
            V = un
        Vm = np.where(cand[..., None], V, np.inf)
        flat = Vm.reshape(F, C, -1)  # (j, l) flattening == visit order
        p_min = flat.min(-1)
        K = flat.shape[-1]
        last_k = K - 1 - np.argmax(
            (flat == p_min[..., None])[:, :, ::-1], axis=-1)
        found = np.isfinite(p_min)
        min_angle = np.where(
            found, ang.reshape(-1)[last_k] % M, 0)
        r_min = np.take_along_axis(
            un.reshape(F, C, -1), last_k[..., None], -1)[..., 0]
        r_min = np.where(found, r_min, 0.0)

    # ---- unwrap to minimize channel phase distance
    # (cli/phase-rotate.cc:905-929) ----
    cnt = found.sum(-1)  # (F,)
    safe_cnt = np.maximum(cnt, 1)
    avg = (min_angle * found).sum(-1) / safe_cnt
    avg_dist = M / safe_cnt
    wrap = ((min_angle > 90 * SUBSAMPLE)
            & (np.abs(min_angle - avg[:, None]) > avg_dist[:, None]))
    wrap |= (avg > 90 * SUBSAMPLE)[:, None]
    angles = np.where(wrap, min_angle - M, min_angle)
    angles = np.where(found & (cnt[:, None] > 0), angles, 0)

    results: List[SearchResult] = []
    for f in range(F):
        mins: Dict[int, List[int]] = {}
        any_c = np.nonzero(cand_coarse[f].any(axis=0))[0]
        for j in any_c:
            a = int(j if stride == 1 else A[j])
            mins[a] = [int(c) for c in np.nonzero(cand_coarse[f, :, j])[0]]
        results.append(SearchResult(
            angles_units=[int(a) for a in angles[f]],
            angles_deg=[float(a) / SUBSAMPLE for a in angles[f]],
            peak_zero=[float(v) for v in r_zro[f]],
            peak_min=[float(v) for v in r_min[f]],
            found=[bool(v) for v in found[f]],
            coarse_considered=mins,
        ))
    return results


def select_min_peak_angles(
    peak_table: np.ndarray,
    stride: int = 12 * SUBSAMPLE,
    link_channels: bool = False,
    rot0: Optional[np.ndarray] = None,
) -> SearchResult:
    """Single-file wrapper over :func:`select_min_peak_angles_batch`.

    Args:
      peak_table: (channels, MAXSAMPLE) float32 from
        :func:`phaserotate_tpu.search.sweep.sweep_peaks`.

    Returns a :class:`SearchResult` whose angles match the reference CLI.
    """
    table = np.asarray(peak_table, np.float32)
    return select_min_peak_angles_batch(
        table[None], stride=stride, link_channels=link_channels,
        rot0=None if rot0 is None else np.asarray(rot0, np.float32)[None],
    )[0]
