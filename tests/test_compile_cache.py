"""The compile-cache helper sets a directory only where the environment
names none, and then always the same fixed path."""

import os

import jax
import pytest

from mvskit_tpu.utils import compile_cache as cc


@pytest.mark.parametrize("env_dir", [None, "/elsewhere/cache"])
def test_enable_compile_cache(monkeypatch, env_dir):
    if env_dir is None:
        monkeypatch.delenv(cc.ENV_VAR, raising=False)
    else:
        monkeypatch.setenv(cc.ENV_VAR, env_dir)
    calls = {}
    monkeypatch.setattr(
        jax.config, "update", lambda k, v: calls.__setitem__(k, v)
    )
    cc.enable_compile_cache()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if env_dir is None:
        assert cc.dir_to_set() == os.path.join(repo, ".jax_cache")
        assert calls["jax_compilation_cache_dir"] == cc.dir_to_set()
    else:
        assert cc.dir_to_set() is None
        assert "jax_compilation_cache_dir" not in calls
    assert calls["jax_persistent_cache_min_compile_time_secs"] == 1.0
