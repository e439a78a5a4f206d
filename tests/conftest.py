"""Test configuration: run all tests on a virtual 8-device CPU mesh.

Multi-device sharding (parallel/) is exercised without accelerators via
XLA's host-platform device-count override — the standard JAX pattern for
testing pjit/shard_map programs on one machine.
"""
import os


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: heavy soak/integration tests — excluded from the default "
        "(fast, <=10 min) tier; run with SLAM_SLOW_TESTS=1",
    )


os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
# The persistent cache (the checkout's .jax_cache, as utils/jaxcache.py
# uses) makes repeated test runs cheap; the tests jit their hot calls.
os.environ.setdefault(
    "JAX_COMPILATION_CACHE_DIR",
    os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"),
)
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES", "-1")
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "0")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def pytest_collection_modifyitems(config, items):
    """Fast/slow tiers (VERDICT r03 #9): the default invocation
    (`python -m pytest tests/ -x -q`) must gate in <= 10 min, so tests
    marked `slow` (long soaks, heavyweight integration) are skipped unless
    SLAM_SLOW_TESTS=1 is set."""
    import pytest as _pytest

    if os.environ.get("SLAM_SLOW_TESTS"):
        return
    skip = _pytest.mark.skip(reason="slow tier (set SLAM_SLOW_TESTS=1)")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)
