"""Compile-cache placement (backend.setup_compile_cache)."""

import os

import jax
import pytest

from raytracing_gpu import backend


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_env_var_wins_and_nothing_is_set(monkeypatch, tmp_path,
                                         restore_cache_dir):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv(backend.CACHE_ENV, str(tmp_path))
    assert backend.setup_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_default_is_fixed_dir_at_repo_root(monkeypatch, restore_cache_dir):
    monkeypatch.delenv(backend.CACHE_ENV, raising=False)
    path = backend.setup_compile_cache()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert path == os.path.join(repo, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    # a fixed path, not one made per process or per call
    assert backend.setup_compile_cache() == path


def test_cache_dir_is_ignored_by_git():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(repo, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
