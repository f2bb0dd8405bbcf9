"""Import-time configuration: the persistent compile cache's location."""
import os

import jax
import pytest

from lcgp_tpu import config


@pytest.fixture
def restore_cache_dir():
    saved = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update('jax_compilation_cache_dir', saved)


def test_compile_cache_honours_env(monkeypatch, restore_cache_dir):
    """JAX_COMPILATION_CACHE_DIR set: JAX keeps its choice, nothing in
    code overrides it."""
    monkeypatch.setenv('JAX_COMPILATION_CACHE_DIR', '/elsewhere/cache')
    jax.config.update('jax_compilation_cache_dir', '/elsewhere/cache')
    assert config.configure_compile_cache() is None
    assert jax.config.jax_compilation_cache_dir == '/elsewhere/cache'


def test_compile_cache_defaults_to_checkout(monkeypatch, restore_cache_dir):
    """Unset: a fixed .jax_cache/ at the checkout root — never a
    temporary, per-process or timestamped path."""
    monkeypatch.delenv('JAX_COMPILATION_CACHE_DIR', raising=False)
    jax.config.update('jax_compilation_cache_dir', None)
    got = config.configure_compile_cache()
    root = os.path.dirname(os.path.dirname(os.path.abspath(config.__file__)))
    assert got == os.path.join(root, '.jax_cache')
    assert jax.config.jax_compilation_cache_dir == got
    assert config.configure_compile_cache() == got      # stable
