"""Where the persistent XLA compile cache goes (cli.enable_compile_cache,
shared by the CLI, bench.py and chip_smoke.py)."""

import os

import jax
import pytest

from nerf_rs_tpu import cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cache_config():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_follows_jax_compilation_cache_dir(monkeypatch, tmp_path,
                                          cache_config):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    jax.config.update("jax_compilation_cache_dir", None)
    assert cli.enable_compile_cache() == str(tmp_path)
    # JAX reads the variable itself; nothing else is set in code
    assert jax.config.jax_compilation_cache_dir is None


def test_fixed_path_in_the_checkout(monkeypatch, cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    first = cli.enable_compile_cache()
    assert first == os.path.join(REPO, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == first
    # the same path on every call: a path that moves never hits
    assert cli.enable_compile_cache() == first
