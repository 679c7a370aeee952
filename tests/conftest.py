import os
import sys

# The tests run on the CPU, with a virtual 8-device mesh for the sharding
# tests; the GPU runs are chip_smoke.py and bench.py (see the README).
os.environ.setdefault("JAX_PLATFORMS", "cpu")
xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8"
    ).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import pytest


def pytest_addoption(parser):
    parser.addoption(
        "--run-slow",
        action="store_true",
        default=False,
        help="run slow full-scale tests (reference-size circuits)",
    )


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: full-scale circuit test")
    config.addinivalue_line(
        "markers",
        "mesh_slow: multi-minute shard_map-compile test on the CPU mesh "
        "(run explicitly with --run-slow)",
    )


def pytest_collection_modifyitems(config, items):
    if config.getoption("--run-slow"):
        return
    skip_slow = pytest.mark.skip(reason="needs --run-slow")
    for item in items:
        if "slow" in item.keywords or "mesh_slow" in item.keywords:
            item.add_marker(skip_slow)
