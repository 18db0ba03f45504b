"""The compile-cache location helper (tpu_snappy.utils.compile_cache)."""

import jax
import pytest

from tpu_snappy.utils import compile_cache


@pytest.fixture()
def restore_config():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_default_is_repo_dot_jax_cache(monkeypatch, restore_config):
    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    want = compile_cache.REPO_ROOT / ".jax_cache"
    assert (compile_cache.REPO_ROOT / "tpu_snappy").is_dir()
    assert compile_cache.cache_dir() == want
    assert compile_cache.enable() == want
    assert jax.config.jax_compilation_cache_dir == str(want)


def test_environment_variable_wins(monkeypatch, tmp_path, restore_config):
    monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path / "cc"))
    jax.config.update("jax_compilation_cache_dir", "unchanged")
    assert compile_cache.cache_dir() == tmp_path / "cc"
    assert compile_cache.enable() == tmp_path / "cc"
    # JAX reads the variable itself; the helper sets no other directory.
    assert jax.config.jax_compilation_cache_dir == "unchanged"


def test_path_is_stable():
    assert compile_cache.cache_dir() == compile_cache.cache_dir()
    assert compile_cache.REPO_ROOT.is_absolute()
