"""Sweep implementations and the convolutions against plain references.

The Triton sweep kernel runs here in Pallas interpret mode (its explicit
``interpret=True``); the compiled kernel is checked on the GPU by
tests_gpu/ and chip_smoke.py.
"""

import inspect

import numpy as np
import pytest

from phaserotate_tpu.core.angles import MAXSAMPLE, all_angle_cos_sin
from phaserotate_tpu.kernels import choice, rotate_peak_sweep_kernel
from phaserotate_tpu.kernels.rotate_peak import sweep_splits
from phaserotate_tpu.ops.peak import rotated_peak_sweep, rotated_peak_sweep_tiled


def _reference(b0, b1, cs):
    """ops/peak.rotated_peak_sweep row by row over any leading dims."""
    lead = b0.shape[:-1]
    r0 = b0.reshape(-1, b0.shape[-1])
    r1 = b1.reshape(-1, b1.shape[-1])
    rows = [np.asarray(rotated_peak_sweep(r0[i], r1[i], cs))
            for i in range(r0.shape[0])]
    return np.stack(rows).reshape(*lead, cs.shape[-1])


def test_sweep_kernel_matches_xla_scan(rng):
    n = 30000
    b0 = rng.standard_normal(n).astype(np.float32)
    b1 = rng.standard_normal(n).astype(np.float32)
    cs = all_angle_cos_sin()
    got = np.asarray(rotate_peak_sweep_kernel(b0, b1, cs, tile_len=1024,
                                              interpret=True))
    want = np.asarray(rotated_peak_sweep(b0, b1, cs))
    assert got.shape == (MAXSAMPLE,)
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_sweep_kernel_matches_direct(rng):
    n = 4096
    b0 = rng.standard_normal(n).astype(np.float32)
    b1 = rng.standard_normal(n).astype(np.float32)
    cs = np.asarray(all_angle_cos_sin())
    got = np.asarray(rotate_peak_sweep_kernel(b0, b1, cs, tile_len=512,
                                              interpret=True))
    direct = np.abs(
        cs[0][:, None] * b0[None] + cs[1][:, None] * b1[None]
    ).max(axis=1)
    np.testing.assert_allclose(got, direct, atol=2e-5)


# (length, tile, block of angles, leading dims, angle slice)
KERNEL_CASES = [
    (1, 256, 32, (), slice(None)),
    (255, 256, 32, (), slice(None)),
    (257, 128, 64, (2,), slice(None)),
    (5000, 256, 32, (2, 3), slice(None)),
    (4096, 512, 16, (3,), slice(None)),
    (3001, 1024, 128, (1, 2), slice(None)),
    (2000, 256, 32, (2,), slice(90, 180)),
    (1500, 128, 32, (), slice(0, 45)),
]


@pytest.mark.parametrize("n,tile,block,lead,angles", KERNEL_CASES)
def test_sweep_kernel_interpret_matches_reference(rng, n, tile, block,
                                                  lead, angles):
    """Ragged lengths, tile sizes, batch dims and angle slices (the
    angle-parallel mesh path) against the plain reference."""
    b0 = rng.standard_normal((*lead, n)).astype(np.float32)
    b1 = rng.standard_normal((*lead, n)).astype(np.float32)
    cs = np.asarray(all_angle_cos_sin())[:, angles]
    got = np.asarray(rotate_peak_sweep_kernel(
        b0, b1, cs, block_angles=block, tile_len=tile, interpret=True))
    want = _reference(b0, b1, cs)
    assert got.shape == (*lead, cs.shape[-1])
    np.testing.assert_allclose(got, want, rtol=2.5e-7, atol=1e-7)


@pytest.mark.parametrize("signals,blocks,tiles,want", [
    (512, 12, 1875, 1),     # a full search batch fills the device alone
    (2, 12, 41000, 43),     # one stereo track: split the samples
    (1, 12, 6, 1),          # too short to split: >= 4 tiles per program
])
def test_sweep_splits(signals, blocks, tiles, want):
    got = sweep_splits(signals, blocks, tiles)
    assert got == want
    assert got == 1 or tiles // got >= 4


@pytest.mark.parametrize("n,lead", [
    (1, ()), (777, (3,)), (20000, (2, 2)), (4097, (40,)),
])
def test_tiled_xla_sweep_matches_reference(rng, n, lead):
    b0 = rng.standard_normal((*lead, n)).astype(np.float32)
    b1 = rng.standard_normal((*lead, n)).astype(np.float32)
    cs = np.asarray(all_angle_cos_sin())
    got = np.asarray(rotated_peak_sweep_tiled(b0, b1, cs))
    np.testing.assert_allclose(got, _reference(b0, b1, cs),
                               rtol=2.5e-7, atol=1e-7)


@pytest.mark.parametrize("platform,want", [
    ("gpu", "triton"), ("cpu", "xla"), ("rocm", "xla"),
])
def test_chooser_per_platform(platform, want):
    assert choice.sweep_implementation(platform) == want


def test_chooser_on_cpu_runs_xla_not_the_kernel(rng, monkeypatch):
    from phaserotate_tpu.kernels import rotate_peak

    def refuse(*a, **k):
        raise AssertionError("kernel reached on the CPU backend")

    monkeypatch.setattr(rotate_peak, "rotate_peak_sweep_kernel", refuse)
    b0 = rng.standard_normal((2, 300)).astype(np.float32)
    b1 = rng.standard_normal((2, 300)).astype(np.float32)
    cs = np.asarray(all_angle_cos_sin())
    got = np.asarray(choice.rotate_peak_sweep(b0, b1, cs))
    np.testing.assert_allclose(got, _reference(b0, b1, cs),
                               rtol=2.5e-7, atol=1e-7)


def test_chooser_never_asks_for_interpret_mode(monkeypatch):
    """On the GPU the chooser calls the compiled kernel with no
    ``interpret`` argument, and the kernel's default compiles."""
    from phaserotate_tpu.kernels import rotate_peak

    sig = inspect.signature(rotate_peak.rotate_peak_sweep_kernel)
    assert sig.parameters["interpret"].default is False
    seen = {}

    def record(b0, b1, cs, **kwargs):
        seen.update(kwargs)
        return "kernel"

    monkeypatch.setattr(rotate_peak, "rotate_peak_sweep_kernel", record)
    monkeypatch.setattr(choice.jax, "default_backend", lambda: "gpu")
    assert choice.rotate_peak_sweep(None, None, None) == "kernel"
    assert "interpret" not in seen


def _np_hilbert(x, taps):
    """float64 linear convolution with the reference FIR."""
    from phaserotate_tpu.core.fir import _design_hilbert_fir_np

    fir = _design_hilbert_fir_np(taps).astype(np.float64)
    return np.stack([np.convolve(row, fir) for row in
                     np.atleast_2d(x).astype(np.float64)])


@pytest.mark.parametrize("firlen", [3072, 4096, 8192])
def test_hilbert_fir_matches_float64_convolution(rng, firlen):
    """The stream FIR lengths (48/96/192 kHz), time-aligned."""
    from phaserotate_tpu.ops.rotate import hilbert_fir

    n = 2 * firlen + 123
    x = rng.standard_normal((2, n)).astype(np.float32)
    got = np.asarray(hilbert_fir(x, firlen))
    lat = firlen // 2
    want = _np_hilbert(x, firlen)[:, lat : lat + n]
    np.testing.assert_allclose(got, want, atol=2e-5)


@pytest.mark.parametrize("blksiz", [1024, 32768])
def test_hilbert_offline_matches_float64_convolution(rng, blksiz):
    """The offline geometry's extremes (CLI MIN_BLKSIZ and MAX_BLKSIZ)."""
    from phaserotate_tpu.core.sizes import OfflineGeometry
    from phaserotate_tpu.search.sweep import hilbert_offline

    geom = OfflineGeometry(blksiz=blksiz)
    n = blksiz + 777
    x = rng.standard_normal(n).astype(np.float32)
    got = np.asarray(hilbert_offline(x, geom))
    n_blocks = -(-n // geom.parsiz)
    assert got.shape == ((n_blocks + 1) * geom.parsiz,)
    full = _np_hilbert(x, geom.parsiz)[0]
    want = np.zeros(got.shape)  # beyond the convolution's support: zero
    m = min(len(full), len(got))
    want[:m] = full[:m]
    np.testing.assert_allclose(got, want, atol=2e-5)


@pytest.mark.parametrize("rate", [48000, 96000, 192000])
def test_rotate_streamed_matches_rotate_fir(rng, rate):
    """The whole-signal streaming engine equals the offline FIR rotation
    at every plugin geometry."""
    from phaserotate_tpu.ops.rotate import rotate_fir
    from phaserotate_tpu.stream.engine import rotate_streamed

    x = rng.standard_normal(12000).astype(np.float32)
    got = np.asarray(rotate_streamed(x, -63.0, rate=rate))
    want = np.asarray(rotate_fir(x, -63.0, rate=rate))
    np.testing.assert_allclose(got, want, atol=1e-5)
