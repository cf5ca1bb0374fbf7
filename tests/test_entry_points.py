"""Entry-point plumbing: the shared compile-cache helper and chip_smoke.py's
refusal to run without a GPU."""

import json
import os
import shutil
import subprocess
import sys

import jax
import pytest

from srba_slam_tpu.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_cache_dir_honours_env_var(tmp_path):
    d = str(tmp_path / "cache")
    assert compile_cache.cache_dir({compile_cache.ENV_VAR: d}) == d


def test_cache_dir_defaults_inside_checkout(monkeypatch):
    """Without the env var every entry point shares <repo>/.jax_cache."""
    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    assert compile_cache.cache_dir({}) == os.path.join(REPO, ".jax_cache")
    old = (jax.config.jax_compilation_cache_dir,
           jax.config.jax_persistent_cache_min_compile_time_secs)
    try:
        assert compile_cache.enable_compile_cache() == os.path.join(
            REPO, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == os.path.join(
            REPO, ".jax_cache")
    finally:
        jax.config.update("jax_compilation_cache_dir", old[0])
        jax.config.update("jax_persistent_cache_min_compile_time_secs",
                          old[1])


@pytest.mark.parametrize("alone", [False, True],
                         ids=["in_checkout", "script_alone"])
def test_chip_smoke_refuses_without_gpu(tmp_path, alone):
    """On a CPU-only JAX, and in a directory holding only the script, the
    smoke check exits non-zero and prints no result line."""
    script = os.path.join(REPO, "chip_smoke.py")
    cwd = REPO
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = str(tmp_path / "chip_smoke.py"), str(tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    for line in r.stdout.splitlines():
        with pytest.raises(ValueError):
            json.loads(line)
