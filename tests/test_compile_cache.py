"""The persistent compilation cache helper (utils.compile_cache)."""

import jax
import pytest

from megapath.utils import compile_cache


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_env_set_sets_nothing(monkeypatch, restore_cache_dir, tmp_path):
    monkeypatch.setenv(compile_cache.CACHE_ENV, str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.use_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_env_unset_uses_checkout_dir(monkeypatch, restore_cache_dir):
    monkeypatch.delenv(compile_cache.CACHE_ENV, raising=False)
    got = compile_cache.use_compile_cache()
    assert got == compile_cache.DEFAULT_CACHE_DIR
    assert got.endswith("bench_cache/jaxcache")
    assert jax.config.jax_compilation_cache_dir == got
