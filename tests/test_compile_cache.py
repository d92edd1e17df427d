"""The one place that decides where JAX's persistent compilation cache
lives (``landhydrology.compile_cache``)."""

import os

import jax

from landhydrology import compile_cache


def test_environment_variable_wins_and_nothing_is_set(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_default_is_fixed_inside_the_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    before = jax.config.jax_compilation_cache_dir
    try:
        path = compile_cache.enable_compile_cache()
        assert path == os.path.join(repo_root, ".jax_compile_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    with open(os.path.join(repo_root, ".gitignore")) as f:
        assert ".jax_compile_cache/" in f.read().split()
