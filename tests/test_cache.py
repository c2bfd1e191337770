"""Compile-cache placement (utils/cache.py) and the rescan-seed store
that lives beside it (engine._seed_store_path)."""

import os

import jax
import pytest

import merpcr_tpu.engine as E
from merpcr_tpu.utils import cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("mode", ["env_dir", "checkout_dir", "disabled"])
def test_cache_placement(mode, tmp_path, monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.delenv("MERPCR_TPU_CACHE", raising=False)
    if mode == "env_dir":
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    elif mode == "disabled":
        monkeypatch.setenv("MERPCR_TPU_CACHE", "0")

    updates = {}
    monkeypatch.setattr(cache, "_ENABLED", False)
    monkeypatch.setattr(jax.config, "update", updates.__setitem__)
    cache.enable_compilation_cache()
    first, second = cache.cache_dir(), cache.cache_dir()
    assert first == second

    if mode == "env_dir":
        # JAX reads the variable itself; no other directory is set
        assert first == str(tmp_path)
        assert "jax_compilation_cache_dir" not in updates
        assert E._seed_store_path() == str(tmp_path / "rescan_seeds.json")
    elif mode == "checkout_dir":
        assert first == os.path.join(REPO, ".jax_cache")
        assert updates["jax_compilation_cache_dir"] == first
        assert E._seed_store_path() == os.path.join(first, "rescan_seeds.json")
        with open(os.path.join(REPO, ".gitignore")) as fh:
            assert ".jax_cache/" in fh.read().split()
    else:
        assert first is None
        assert updates == {"jax_enable_compilation_cache": False}
        assert E._seed_store_path() is None
