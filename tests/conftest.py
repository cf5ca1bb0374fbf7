"""Test configuration: run all tests on a virtual 8-device CPU mesh.

The CPU backend is forced through jax.config (before any device is touched)
as well as JAX_PLATFORMS, so the suite is hermetic on a machine with a GPU
too, and exercises the multi-device sharding paths via
``--xla_force_host_platform_device_count=8``. The GPU is exercised by
``python chip_smoke.py``.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ.setdefault("JAX_ENABLE_X64", "0")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _clear_jax_caches_per_module():
    """Bound in-process XLA/jit state growth across the full suite.

    A single `pytest tests/ -x -q` process accumulates every module's
    compiled programs; after ~180 tests the backend segfaults inside a
    fresh compile (reproduced twice at the same test, 2026-08-20; passes
    in isolation and at file scope). Dropping the jit caches at module
    boundaries keeps the in-process footprint at single-module scale.
    Cross-module recompiles are cheap relative to the suite's own
    compile-dominated runtime.
    """
    yield
    jax.clear_caches()


@pytest.fixture
def rng():
    return np.random.default_rng(0)
