import os
import sys

# Tests run on a virtual 8-device CPU mesh (SURVEY.md §4: sharding tests on
# a CPU mesh; golden tests compare code paths, not device numerics). Both
# variables must be set before JAX is first imported, which happens after
# this file is loaded.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


# ---------------------------------------------------------------------------
# Fast/slow tiers: `pytest tests/ -q` runs the fast
# tier (< ~5 min on the 2-vCPU CI box); the heavy tests (interpret-mode
# Pallas, BDPT oracle, shard_map-compile-heavy, long Adam loops) are
# @pytest.mark.slow and run with --runslow or AKARI_SLOW_TESTS=1.

import pytest  # noqa: E402


def pytest_addoption(parser):
    parser.addoption(
        "--runslow", action="store_true", default=False,
        help="also run tests marked slow (full tier)",
    )


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: heavy test, excluded from the default fast tier"
    )


def pytest_collection_modifyitems(config, items):
    if config.getoption("--runslow") or os.environ.get("AKARI_SLOW_TESTS") == "1":
        return
    skip = pytest.mark.skip(reason="slow tier: use --runslow / AKARI_SLOW_TESTS=1")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)
