"""Test harness configuration.

Runs everything on the CPU with 8 virtual devices (SURVEY §4's multi-device-without-
a-cluster strategy) so sharding tests exercise real ``Mesh``/``shard_map`` paths, and
the Pallas kernel runs in the Pallas interpreter. Tests marked ``gpu`` need a card:
they skip here and run on a GPU machine with

    JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu -n 0

(one process, so that one JAX process holds the card).
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax

# Functional XLA has no data races to detect (SURVEY §5); the numerical analogue
# is NaN poisoning — surface it at the op that produced it when requested.
if os.environ.get("RT_DEBUG_NANS"):
    jax.config.update("jax_debug_nans", True)

import numpy as np
import pytest

import python_ray_tracer_jax as rt


def pytest_addoption(parser):
    parser.addoption("--runslow", action="store_true", default=False,
                     help="run tests marked slow (full suite; ~15 min on 4 cores)")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: >45 s on the 4-core CI host; excluded by default, "
        "run with --runslow (or RT_FULL_TESTS=1)")
    config.addinivalue_line(
        "markers", "gpu: needs a GPU (compiled kernels); skips elsewhere — "
        "see this module's docstring for how to run them")


def pytest_collection_modifyitems(config, items):
    if config.getoption("--runslow") or os.environ.get("RT_FULL_TESTS"):
        return
    skip_slow = pytest.mark.skip(reason="slow test: pass --runslow to include")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip_slow)


@pytest.fixture(scope="session")
def demo_scene():
    return rt.default_scene()


@pytest.fixture(scope="session")
def small_camera():
    return rt.default_camera((32, 32))


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU (decided at run time)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: the kernel is compiled for the card here")
