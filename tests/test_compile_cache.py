"""The compilation-cache helper shared by the CLI, bench.py and chip_smoke.py."""

from pathlib import Path

import jax

from uvtrace.utils import compile_cache

REPO = Path(__file__).resolve().parent.parent


def _record_updates(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update", lambda k, v: calls.append((k, v)))
    return calls


def test_environment_variable_wins(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    calls = _record_updates(monkeypatch)
    assert compile_cache.compile_cache_dir() is None
    compile_cache.enable_compile_cache()
    assert calls == []  # JAX reads the variable itself; no other directory set


def test_default_is_fixed_in_checkout_and_ignored(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert compile_cache.compile_cache_dir() == REPO / ".jax_cache"
    ignored = (REPO / ".gitignore").read_text().split()
    assert ".jax_cache/" in ignored


def test_default_is_set_in_jax_config(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    calls = _record_updates(monkeypatch)
    compile_cache.enable_compile_cache()
    assert calls == [("jax_compilation_cache_dir", str(REPO / ".jax_cache"))]
