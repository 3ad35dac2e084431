"""The persistent compile cache helper every entry point calls."""

import os

import jax
import pytest

from topfusion.utils import compile_cache


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_cache_in_checkout_when_variable_unset(monkeypatch, restore_cache_dir):
    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    path = compile_cache.enable_compile_cache()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert path == os.path.join(root, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    # A fixed path: a second call (a later run) names the same directory.
    assert compile_cache.enable_compile_cache() == path


def test_cache_variable_wins_and_nothing_else_is_set(
    monkeypatch, tmp_path, restore_cache_dir
):
    monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    # JAX reads the variable itself; the helper sets no directory in code.
    assert jax.config.jax_compilation_cache_dir == before
