"""Sample-rate adaptive FFT/FIR sizing.

Re-design of the reference's sizing tables:

* Plugin (streaming) geometry — reference src/phaserotate.c:278-297:
  rate < 64 kHz  -> fftlen  512, firlen 3072
  rate < 128 kHz -> fftlen 1024, firlen 4096
  else           -> fftlen 2048, firlen 8192
  with parsiz = fftlen/2, firlat = firlen/2, n_segm = firlen/parsiz,
  latency = parsiz + firlat.

* Offline/CLI geometry — reference cli/phase-rotate.cc:128-141, 749-755:
  blksiz defaults to rate/8 rounded up to a power of two, clamped to
  [1024, 32768]; then fftlen = 2*blksiz, parsiz = blksiz, firlen = blksiz/2
  (the FIR support is `parsiz` samples, its group delay `firlen`), and the
  processing latency is blksiz/2 (cli/phase-rotate.cc:963).

Both geometries are expressed as frozen, hashable dataclasses so they can be
closed over by ``jax.jit`` as static configuration.
"""

from __future__ import annotations

import dataclasses

__all__ = [
    "StreamGeometry",
    "OfflineGeometry",
    "stream_geometry_for_rate",
    "offline_geometry",
    "default_blksiz",
    "MIN_BLKSIZ",
    "MAX_BLKSIZ",
]

MIN_BLKSIZ = 1024
MAX_BLKSIZ = 32768


@dataclasses.dataclass(frozen=True)
class StreamGeometry:
    """Static geometry of the streaming (plugin) engine.

    Mirrors the derived quantities of the reference's ``FFTiProc`` config
    (src/phaserotate.c:84-92).
    """

    rate: float
    fftlen: int
    firlen: int

    @property
    def parsiz(self) -> int:
        """Partition size: samples consumed/produced per FFT block."""
        return self.fftlen // 2

    @property
    def firlat(self) -> int:
        """FIR group delay in samples (window center)."""
        return self.firlen // 2

    @property
    def n_segm(self) -> int:
        """Number of uniform FIR partitions."""
        return self.firlen // self.parsiz

    @property
    def latency(self) -> int:
        """End-to-end latency: one partition + FIR group delay
        (src/phaserotate.c:297)."""
        return self.parsiz + self.firlat

    @property
    def interp_th(self) -> float:
        """Per-sample angle-ramp rate clamp (src/phaserotate.c:295)."""
        return self.parsiz * 1e-6

    @property
    def interp_nm(self) -> float:
        """1/parsiz — converts an angle delta into a per-sample slope
        (src/phaserotate.c:296)."""
        return 1.0 / self.parsiz

    def __post_init__(self):
        if self.fftlen & (self.fftlen - 1):
            raise ValueError(f"fftlen must be a power of two, got {self.fftlen}")
        if self.firlen % (self.fftlen // 2):
            raise ValueError(
                f"firlen ({self.firlen}) must be a multiple of parsiz "
                f"({self.fftlen // 2})"
            )


@dataclasses.dataclass(frozen=True)
class OfflineGeometry:
    """Static geometry of the offline analyzer/applier.

    Mirrors ``PhaseRotateProc`` (cli/phase-rotate.cc:128-141): one FIR
    partition of ``blksiz`` taps with group delay ``blksiz/2``.
    """

    blksiz: int

    @property
    def parsiz(self) -> int:
        return self.blksiz

    @property
    def fftlen(self) -> int:
        return 2 * self.blksiz

    @property
    def firlen(self) -> int:
        """FIR *group delay* in samples; the FIR support is ``parsiz`` taps.

        Matches the (confusingly named) ``_firlen`` of the reference
        (cli/phase-rotate.cc:131): half the FIR support.
        """
        return self.blksiz // 2

    @property
    def latency(self) -> int:
        """Streaming write-path latency (cli/phase-rotate.cc:963)."""
        return self.blksiz // 2

    def __post_init__(self):
        if self.blksiz & (self.blksiz - 1):
            raise ValueError(f"blksiz must be a power of two, got {self.blksiz}")
        if not (MIN_BLKSIZ <= self.blksiz <= MAX_BLKSIZ):
            raise ValueError(
                f"blksiz {self.blksiz} out of range [{MIN_BLKSIZ}, {MAX_BLKSIZ}]"
            )


def stream_geometry_for_rate(rate: float) -> StreamGeometry:
    """Pick streaming FFT/FIR sizes for a sample rate
    (src/phaserotate.c:278-290)."""
    if rate < 64000:
        return StreamGeometry(rate=rate, fftlen=512, firlen=3072)
    if rate < 128000:
        return StreamGeometry(rate=rate, fftlen=1024, firlen=4096)
    return StreamGeometry(rate=rate, fftlen=2048, firlen=8192)


def default_blksiz(rate: int, requested: int = 0) -> int:
    """CLI block-size selection (cli/phase-rotate.cc:749-755).

    ``requested == 0`` (or out of range high) means "derive from rate":
    rate/8 rounded *up* to the next power of two, clamped to
    [MIN_BLKSIZ, MAX_BLKSIZ].
    """
    blksiz = requested
    if blksiz == 0 or blksiz > MAX_BLKSIZ:
        blksiz = rate // 8
    power_of_two = 1
    while (1 << power_of_two) < blksiz:
        power_of_two += 1
    return min(MAX_BLKSIZ, max(MIN_BLKSIZ, 1 << power_of_two))


def offline_geometry(rate: int, blksiz: int = 0) -> OfflineGeometry:
    """Build the offline geometry the CLI would use for ``rate``."""
    return OfflineGeometry(blksiz=default_blksiz(rate, blksiz))
