"""The rules every entry point follows: the compile-cache location, and the
card-only scripts refusing any backend but a GPU."""

import contextlib
import json
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def restore_cache_config():
    import jax

    saved = (jax.config.jax_compilation_cache_dir,
             jax.config.jax_persistent_cache_min_compile_time_secs)
    yield
    jax.config.update("jax_compilation_cache_dir", saved[0])
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      saved[1])


def test_compile_cache_follows_env(monkeypatch, tmp_path,
                                   restore_cache_config):
    """With JAX_COMPILATION_CACHE_DIR set, JAX reads it itself: the rule
    returns it and sets no directory of its own."""
    import jax

    from phaserotate_tpu.core import plancache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "env"))
    assert plancache.enable_compile_cache() == str(tmp_path / "env")
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_to_checkout(monkeypatch, tmp_path,
                                            restore_cache_config):
    """Unset, the cache goes to one fixed directory of the checkout."""
    import jax

    from phaserotate_tpu.core import plancache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    fixed = str(tmp_path / ".jax_cache")
    monkeypatch.setattr(plancache, "CHECKOUT_CACHE_DIR", fixed)
    assert plancache.enable_compile_cache() == fixed
    assert jax.config.jax_compilation_cache_dir == fixed
    assert os.path.isdir(fixed)


def test_checkout_cache_dir_is_fixed_inside_the_checkout():
    from phaserotate_tpu.core.plancache import CHECKOUT_CACHE_DIR

    assert CHECKOUT_CACHE_DIR == os.path.join(REPO, ".jax_cache")
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


@pytest.mark.parametrize("module,argv", [
    ("cli", ["--version"]),
    ("fleet", ["--help"]),
    ("bridge", ["--help"]),
    ("hostapp", ["--help"]),
])
def test_entry_point_applies_compile_cache_first(monkeypatch, module, argv):
    import importlib

    from phaserotate_tpu.core import plancache

    calls = []
    monkeypatch.setattr(plancache, "enable_compile_cache",
                        lambda: calls.append(module))
    mod = importlib.import_module(f"phaserotate_tpu.{module}")
    with pytest.raises(SystemExit) if argv == ["--help"] else \
            contextlib.nullcontext():
        mod.main(argv)
    assert calls == [module]


def _run(args, cwd=REPO):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def _claims_success(stdout):
    for line in stdout.splitlines():
        try:
            if json.loads(line).get("ok"):
                return True
        except (ValueError, AttributeError):
            continue
    return False


def test_chip_smoke_refuses_cpu_backend():
    r = _run(["chip_smoke.py"])
    assert r.returncode != 0
    assert not _claims_success(r.stdout)
    assert "not 'gpu'" in r.stdout + r.stderr


def test_chip_smoke_needs_the_repository(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run(["chip_smoke.py"], cwd=tmp_path)
    assert r.returncode != 0
    assert not _claims_success(r.stdout)


def test_bench_refuses_cpu_backend():
    r = _run(["bench.py"])
    assert r.returncode == 2
    assert r.stdout == ""
    assert "needs an NVIDIA GPU" in r.stderr
