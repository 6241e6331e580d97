"""phaserotate_tpu — accelerator audio phase-rotation framework in JAX.

A ground-up JAX/XLA/Pallas re-design with the capabilities of
x42/phaserotate.lv2: arbitrary-angle phase rotation of audio (preserving
sound and loudness while moving the digital peak) and a minimum-peak angle
analyzer, built as batched functional transforms instead of a real-time C
plugin.

Public surface (mirrors the reference's capabilities, see BASELINE.json):

* :func:`rotate` — rotate(audio, degrees): whole-buffer rotation, batched.
* :func:`find_min_peak_angle` — the CLI's coarse-to-fine minimum-peak
  search, evaluated as one vmapped sweep.
* :mod:`phaserotate_tpu.stream` — lax.scan streaming engine with the LV2
  plugin's block/latency/interpolation semantics.
* :mod:`phaserotate_tpu.parallel` — pjit/shard_map batch processing over
  device meshes.
"""

from .core import (
    MAXSAMPLE,
    SUBSAMPLE,
    OfflineGeometry,
    StreamGeometry,
    offline_geometry,
    stream_geometry_for_rate,
)
from .ops import rotate, rotate_fir, rotate_spectral

__version__ = "0.1.0"

__all__ = [
    "MAXSAMPLE",
    "SUBSAMPLE",
    "OfflineGeometry",
    "StreamGeometry",
    "find_min_peak_angle",
    "offline_geometry",
    "rotate",
    "rotate_fir",
    "rotate_spectral",
    "stream_geometry_for_rate",
    "__version__",
]


def find_min_peak_angle(audio, rate: int = 48000, **kwargs):
    """Find the rotation angle minimizing digital peak (lazy import; see
    phaserotate_tpu.search.find_min_peak_angle)."""
    from .search import find_min_peak_angle as _impl

    return _impl(audio, rate=rate, **kwargs)


_LAZY = {
    "PhaseRotator": "models",
    "OfflineRotator": "models",
    "AngleAnalyzer": "models",
    "StreamingRotator": "stream",
    "read_audio": "io",
    "write_audio": "io",
}
__all__ += sorted(_LAZY)


def __getattr__(name):
    """Lazy top-level access to the model classes and audio I/O without
    importing their (jax-heavy) modules at package import."""
    if name in _LAZY:
        import importlib

        mod = importlib.import_module(f".{_LAZY[name]}", __name__)
        return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
