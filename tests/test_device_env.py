"""Process-level device settings: the compile cache location and the
per-worker memory share of the rank launchers."""

import os

import jax
import pytest

from genomicsdb_tpu.runtime import device_env

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cache_config():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_follows_env(monkeypatch, cache_config, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    jax.config.update("jax_compilation_cache_dir", None)
    assert device_env.init_compile_cache() == str(tmp_path)
    # the variable is JAX's own setting: the helper leaves it alone
    assert jax.config.jax_compilation_cache_dir is None


def test_compile_cache_defaults_to_checkout(monkeypatch, cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    got = device_env.init_compile_cache()
    assert got == os.path.join(REPO, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == got
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


@pytest.mark.parametrize("n_workers,cards,share,visible", [
    (2, ["0"], "0.450", [None, None]),          # two ranks, one card
    (4, ["0", "1", "2", "3"], "0.900", ["0", "1", "2", "3"]),
    (4, ["0", "1"], "0.450", ["0", "1", "0", "1"]),
    (3, [], "0.300", [None, None, None]),       # no card seen: split 0.9
])
def test_rank_env_memory_share(n_workers, cards, share, visible):
    for i in range(n_workers):
        env = device_env.rank_env(i, n_workers, base={}, cards=cards)
        assert env["XLA_PYTHON_CLIENT_MEM_FRACTION"] == share
        assert env.get("CUDA_VISIBLE_DEVICES") == visible[i]
