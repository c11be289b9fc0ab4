"""Where the entry points put JAX's persistent compilation cache."""

import os

import jax

from opendlv_perception_vision_orbslam2_jax.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_env_var_set_means_nothing_is_configured():
    env = {"JAX_COMPILATION_CACHE_DIR": "/somewhere/else"}
    assert compile_cache.cache_dir_for("gpu", env) is None
    assert compile_cache.cache_dir_for("cpu", env) is None


def test_unset_env_var_uses_the_checkouts_cache_dir():
    assert compile_cache.cache_dir_for("gpu", {}) == os.path.join(
        REPO, ".jax_cache")
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_cpu_backend_leaves_the_config_alone():
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.cache_dir_for("cpu", {}) is None
    assert compile_cache.enable_compile_cache() is None
    assert jax.config.jax_compilation_cache_dir == before
