import os
import sys

# Tests run on a virtual 8-device CPU mesh.  JAX_PLATFORMS is exported so
# subprocesses spawned by tests (CLI workers, local-spark executors) stay
# on the CPU too; the gpu lane (tests/test_gpu_lane.py) clears it for the
# children that run on the card.
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8"
                           ).strip()
os.environ["JAX_PLATFORMS"] = "cpu"

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

REFERENCE_TESTS = "/root/reference/tests"

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: runs on an NVIDIA GPU (select with -m gpu)")
    config.addinivalue_line(
        "markers", "slow: multi-minute lanes (select with -m slow)")


def pytest_collection_modifyitems(config, items):
    # the gpu lane decides in a fixture whether a card is present
    markexpr = config.getoption("-m", default="") or ""
    skip_slow = pytest.mark.skip(
        reason="multi-minute lane (run: pytest -m slow)")
    for item in items:
        if "slow" in item.keywords and "slow" not in markexpr:
            item.add_marker(skip_slow)


@pytest.fixture(scope="session")
def ref_tests_dir():
    return REFERENCE_TESTS
