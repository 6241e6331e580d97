"""Angle conventions, wrapping, and the sin/cos tables.

The reference stores angles as *negated turns*: ``angle = degrees / -360``,
clamped to [-0.5, 0.5] (src/phaserotate.c:564-571), and evaluates
``sin_cos(angle)`` as ``sin/cos(2*pi*angle)`` (src/phaserotate.c:122-133).
The rotation mix is then ``out = ca*x + sa*hilbert_fir(x)``
(src/phaserotate.c:700).  Because the designed FIR is the *negative* of the
ideal Hilbert transformer (see core/fir.py), the two sign flips compose to
the conventional analytic rotation

    out = cos(theta)*x - sin(theta)*H(x) = Re[analytic(x) * e^{-j*theta}]

with ``theta = 2*pi*degrees/360`` — a positive angle delays every component's
phase: ``cos(w t) -> cos(w t - theta)``.

The CLI discretizes angles to half degrees: integer "angle units" of
``1/SUBSAMPLE`` degrees with ``SUBSAMPLE = 2`` and a table of
``MAXSAMPLE = 360`` units covering 180 degrees (cli/phase-rotate.cc:38-74);
rotating by ``d + 180`` degrees equals negating the signal, so peaks repeat
with period 180.
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np

__all__ = [
    "SUBSAMPLE",
    "MAXSAMPLE",
    "degrees_to_turns",
    "turns_to_radians",
    "wrap_turns_delta",
    "sin_cos_turns",
    "angle_units_from_degrees",
    "wrap_angle_units",
    "sincos_lut",
    "degrees_to_turns_np",
    "sin_cos_units",
    "all_angle_cos_sin",
]

SUBSAMPLE = 2  # angle-units per degree (cli/phase-rotate.cc:38)
MAXSAMPLE = 180 * SUBSAMPLE  # table length: 180 deg span (cli/phase-rotate.cc:39)


def degrees_to_turns(degrees):
    """Port-value degrees -> negated turns, clamped to [-0.5, 0.5]
    (src/phaserotate.c:564-571)."""
    t = jnp.asarray(degrees, jnp.float32) / jnp.float32(-360.0)
    return jnp.clip(t, -0.5, 0.5)


def degrees_to_turns_np(degrees) -> "np.ndarray":
    """Numpy twin of :func:`degrees_to_turns` for host-side real-time
    paths: identical float32 arithmetic, zero device involvement (an
    eager device op here costs a full dispatch round trip per block)."""
    t = np.asarray(degrees, np.float32) / np.float32(-360.0)
    return np.clip(t, np.float32(-0.5), np.float32(0.5)).astype(
        np.float32)


def turns_to_radians(turns):
    return jnp.asarray(turns, jnp.float32) * jnp.float32(2.0 * np.pi)


def wrap_turns_delta(da):
    """Shortest-path angle delta in turns: wrap |da| > 0.5 around +-180 deg
    (src/phaserotate.c:676-683)."""
    da = jnp.asarray(da, jnp.float32)
    return jnp.where(jnp.abs(da) > 0.5, da - jnp.sign(da), da)


def sin_cos_turns(turns):
    """(sin, cos) of an angle given in turns (src/phaserotate.c:122-133)."""
    rad = turns_to_radians(turns)
    return jnp.sin(rad), jnp.cos(rad)


def angle_units_from_degrees(degrees: float) -> int:
    """Degrees -> integer half-degree units (cli/phase-rotate.cc:730).

    C ``round()`` semantics — halves round *away from zero*, unlike
    Python's banker's rounding: 10.25 deg -> 21 units (10.5 deg), not 20.
    """
    import math

    x = degrees * SUBSAMPLE
    return int(math.floor(x + 0.5) if x >= 0 else math.ceil(x - 0.5))


def wrap_angle_units(a: int) -> int:
    """Wrap an angle-unit index into [0, MAXSAMPLE)
    (cli/phase-rotate.cc:281-284, 463)."""
    return (a + MAXSAMPLE) % MAXSAMPLE


@functools.lru_cache(maxsize=1)
def _sincos_lut_np() -> tuple[np.ndarray, np.ndarray]:
    """(sin, cos) tables over all MAXSAMPLE angle units.

    Entry ``a`` is sin/cos of ``-pi*a/360`` — the negated-degrees convention
    of ``SinCosLut`` (cli/phase-rotate.cc:44-55).  float64 evaluation rounded
    to float32 (the C library's sincosf is correctly rounded for these args).
    """
    mp = 2.0 * np.pi / SUBSAMPLE / -360.0
    idx = np.arange(MAXSAMPLE)
    return (
        np.sin(mp * idx).astype(np.float32),
        np.cos(mp * idx).astype(np.float32),
    )


def sincos_lut() -> tuple[jnp.ndarray, jnp.ndarray]:
    """The CLI's 0.5-degree-resolution (sin, cos) LUT as device arrays."""
    s, c = _sincos_lut_np()
    return jnp.asarray(s), jnp.asarray(c)


def sin_cos_units(a):
    """(sin, cos) for integer angle units, via table lookup."""
    s, c = sincos_lut()
    a = jnp.mod(jnp.asarray(a) + MAXSAMPLE, MAXSAMPLE)
    return s[a], c[a]


@functools.lru_cache(maxsize=1)
def _all_angle_cos_sin_np() -> np.ndarray:
    """(2, MAXSAMPLE) float32 matrix of [cos; sin] over every angle unit.

    This is the right operand of the angle-sweep matmul: stacking the
    delayed input and Hilbert signals as columns of an ``(n, 2)`` matrix and
    multiplying by this gives every candidate rotation at once — in
    place of the serial per-angle loop of cli/phase-rotate.cc:409-428.
    """
    s, c = _sincos_lut_np()
    return np.stack([c, s], axis=0)


def all_angle_cos_sin() -> jnp.ndarray:
    return jnp.asarray(_all_angle_cos_sin_np())
