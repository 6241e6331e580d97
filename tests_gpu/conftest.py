"""On-card test configuration (``make test-gpu``, phase 7 of chip_smoke.py).

Unlike tests/conftest.py, which pins an 8-device virtual CPU mesh, this
suite runs on the backend JAX finds: the sweep kernel and the XLA paths
execute as compiled for the card.  Every test carries the ``gpu`` marker
(registered in pyproject.toml); the fixture below skips it, with the
reason, when the backend is not a GPU.
"""

import numpy as np
import pytest


@pytest.fixture(autouse=True)
def _needs_gpu(request):
    if request.node.get_closest_marker("gpu") is None:
        return
    import jax

    platform = jax.devices()[0].platform
    if platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU (backend is {platform!r})")


@pytest.fixture(scope="session", autouse=True)
def _compile_cache():
    from phaserotate_tpu.core.plancache import enable_compile_cache

    enable_compile_cache()


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0x7B0)
