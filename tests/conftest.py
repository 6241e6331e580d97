"""Test configuration: force an 8-device virtual CPU mesh.

Multi-device sharding is validated without accelerator hardware by running
the whole suite on the CPU backend with 8 virtual devices — the JAX equivalent
of "multi-node tests without a real cluster" (SURVEY.md §4).  Must run
before the first jax import anywhere.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
# Subprocesses spawned by tests (hostapp, TUI, bridge daemon) are pinned to
# the CPU backend too: entry points honor this variable via
# utils/platform.apply_platform_env.
os.environ["PHASEROTATE_TPU_PLATFORM"] = "cpu"

import jax  # noqa: E402

# jax may already be imported before conftest runs, so the env var alone
# may not stick — force via config.
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)
jax.config.update("jax_enable_x64", False)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0x5EED)


@pytest.fixture(scope="session")
def sine_sweep():
    """10 s, 44.1 kHz logarithmic sine sweep — the parity config of
    BASELINE.json (config 0)."""
    rate = 44100
    t = np.arange(10 * rate, dtype=np.float64) / rate
    f0, f1 = 20.0, 20000.0
    k = np.log(f1 / f0) / t[-1]
    phase = 2 * np.pi * f0 * (np.exp(k * t) - 1.0) / k
    return (0.7 * np.sin(phase)).astype(np.float32), rate
