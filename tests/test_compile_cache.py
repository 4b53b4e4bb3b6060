"""runtime/compile_cache: one rule for where compiled programs persist."""
import jax
import pytest

from impop_tpu.runtime import compile_cache


@pytest.fixture
def recorded(monkeypatch, tmp_path):
    """Record jax.config.update calls instead of applying them, and point
    the checkout cache at a temporary directory."""
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda name, value: calls.append((name, value)))
    monkeypatch.setattr(compile_cache, "CACHE_DIR",
                        str(tmp_path / ".jax_cache"))
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    return calls


def test_env_dir_is_left_to_jax(recorded, monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "env"))
    assert (compile_cache.configure_compile_cache("gpu")
            == str(tmp_path / "env"))
    assert recorded == []
    assert not (tmp_path / ".jax_cache").exists()


def test_gpu_without_env_uses_checkout_dir(recorded, tmp_path):
    got = compile_cache.configure_compile_cache("gpu")
    assert got == str(tmp_path / ".jax_cache")
    assert recorded == [("jax_compilation_cache_dir", got)]
    assert (tmp_path / ".jax_cache").is_dir()


def test_cpu_has_no_cache(recorded, tmp_path):
    assert compile_cache.configure_compile_cache() is None   # this suite
    assert compile_cache.configure_compile_cache("cpu") is None
    assert recorded == []
    assert not (tmp_path / ".jax_cache").exists()
