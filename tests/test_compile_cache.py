"""Where the persistent compile cache lives: $JAX_COMPILATION_CACHE_DIR
when set (JAX reads it; nothing overrides it), else <repo>/.jax_cache."""

import os

import jax

from ray_tracer.utils import compile_cache


def _record_updates(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda name, value: calls.append((name, value)))
    return calls


def test_env_dir_wins_and_is_not_overridden(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    calls = _record_updates(monkeypatch)
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert compile_cache.cache_dir() == str(tmp_path)
    assert calls == []


def test_default_is_fixed_repo_dir(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    calls = _record_updates(monkeypatch)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    want = os.path.join(repo, ".jax_cache")
    assert compile_cache.enable_compile_cache() == want
    assert calls == [("jax_compilation_cache_dir", want)]
    # the same path every time: no pid, temporary name or time in it
    assert compile_cache.cache_dir() == want
