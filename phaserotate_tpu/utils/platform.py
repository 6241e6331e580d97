"""Backend platform selection for subprocess entry points.

Pins the backend of an entry point's process: every CLI entry point
(hostapp, bridge daemon, phase-rotate CLI, fleet) calls
:func:`apply_platform_env` first, and if ``PHASEROTATE_TPU_PLATFORM`` is
set, the jax config is updated to that platform (with
``PHASEROTATE_TPU_PLATFORM_NDEV`` virtual CPU devices) — the last write
wins.  The test suite sets it to ``cpu`` (tests/conftest.py) so the
subprocesses it spawns run on the CPU backend; unset, JAX picks its
default backend.
"""

from __future__ import annotations

import os

__all__ = ["apply_platform_env"]

ENV_VAR = "PHASEROTATE_TPU_PLATFORM"


def apply_platform_env() -> None:
    plat = os.environ.get(ENV_VAR, "").strip()
    if not plat:
        return
    import jax

    try:
        jax.config.update("jax_platforms", plat)
        n = os.environ.get(ENV_VAR + "_NDEV", "").strip()
        if n and plat == "cpu":
            jax.config.update("jax_num_cpu_devices", int(n))
    except RuntimeError:
        pass  # backend already initialized; nothing more we can do
