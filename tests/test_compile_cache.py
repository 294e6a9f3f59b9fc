"""Where the persistent compilation cache goes: JAX_COMPILATION_CACHE_DIR
when it is set (and no other directory is set then), otherwise a fixed
``.jax_cache`` at the checkout root; CPU runs are not cached."""

import os

import jax
import pytest

import recgraph_tpu
from recgraph_tpu.ops import device

CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = ("jax_compilation_cache_dir",
        "jax_persistent_cache_min_entry_size_bytes",
        "jax_persistent_cache_min_compile_time_secs")


@pytest.fixture
def jax_config():
    saved = {k: getattr(jax.config, k) for k in KEYS}
    yield
    for k, v in saved.items():
        jax.config.update(k, v)


def test_dir_defaults_to_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert recgraph_tpu.compile_cache_dir() == os.path.join(
        CHECKOUT, ".jax_cache")


def test_dir_follows_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert recgraph_tpu.compile_cache_dir() == str(tmp_path)


def test_enable_on_gpu_without_env(monkeypatch, jax_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(device, "platform", lambda: "gpu")
    jax.config.update("jax_compilation_cache_dir", None)
    recgraph_tpu.enable_compile_cache()
    assert jax.config.jax_compilation_cache_dir == os.path.join(
        CHECKOUT, ".jax_cache")
    assert jax.config.jax_persistent_cache_min_compile_time_secs == 0.0


def test_enable_on_gpu_with_env_sets_no_other_dir(monkeypatch, jax_config,
                                                  tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(device, "platform", lambda: "gpu")
    jax.config.update("jax_compilation_cache_dir", str(tmp_path))
    recgraph_tpu.enable_compile_cache()
    assert jax.config.jax_compilation_cache_dir == str(tmp_path)


def test_enable_on_cpu_is_a_no_op(monkeypatch, jax_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(device, "platform", lambda: "cpu")
    jax.config.update("jax_compilation_cache_dir", None)
    recgraph_tpu.enable_compile_cache()
    assert jax.config.jax_compilation_cache_dir is None
