"""Test bootstrap: force JAX onto a virtual 8-device CPU platform.

Multi-chip TPU hardware is not available in CI; all sharding/collective tests
run against ``--xla_force_host_platform_device_count=8`` CPU devices, which
exercises the same Mesh/pjit/shard_map code paths XLA uses on a real slice.
Must run before the first ``import jax`` anywhere in the test session.
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# Some images pin a hardware platform through a sitecustomize hook that runs
# before this file and ignores JAX_PLATFORMS; jax.config wins over both.
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import pytest  # noqa: E402

# ---- slow-tier marker -------------------------------------------------------
#
# The compile-heaviest tests (serving engines, speculative decoding,
# pipeline) are marked ``slow`` and excluded by default so the default tier
# stays under ~10 minutes; run the FULL suite with ``--runslow`` or
# ``RUN_SLOW=1``.  CI/driver runs use the default tier; the full tier is
# for pre-merge validation of serving/speculative/pipeline changes.


def pytest_addoption(parser):
    parser.addoption(
        "--runslow", action="store_true", default=False,
        help="also run tests marked slow (compile-heavy serving/pipeline)")


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: compile-heavy test, excluded unless --runslow or RUN_SLOW=1")
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU; skips, with its reason, where there is none")


def pytest_collection_modifyitems(config, items):
    if config.getoption("--runslow") or os.environ.get("RUN_SLOW") == "1":
        return
    skip = pytest.mark.skip(reason="slow tier: run with --runslow or RUN_SLOW=1")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)
