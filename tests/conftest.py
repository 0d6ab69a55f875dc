"""Test configuration: force JAX onto a virtual 8-device CPU platform so the
full stack (including multi-chip sharding) runs without TPU hardware.

Must set the env vars before jax is imported anywhere in the test process.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

# The serving image preloads jax via sitecustomize, so the env vars above can
# arrive after import. The config knobs below still apply as long as the
# backend itself has not been initialized yet.
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
try:
    # jax >= 0.4.x with the explicit knob; older/other versions rely on the
    # XLA_FLAGS fallback set above
    jax.config.update("jax_num_cpu_devices", 8)
except AttributeError:
    pass

assert jax.device_count() == 8, (
    "tests need 8 virtual CPU devices (got {}); the XLA_FLAGS "
    "--xla_force_host_platform_device_count=8 fallback did not take — jax "
    "was initialized before conftest ran".format(jax.device_count())
)

import pytest  # noqa: E402


def pytest_configure(config):
    # the repo has no pytest.ini/pyproject marker section; register the
    # tier-1 exclusion marker here so `-m 'not slow'` runs warning-free
    config.addinivalue_line(
        "markers", "slow: long-running test excluded from the tier-1 run"
    )
    config.addinivalue_line(
        "markers",
        "chaos: fault-injection robustness test (CPU-fast, runs in tier-1; "
        "select with -m chaos)",
    )
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU and nvcc (the PyTorch port's kernels); "
        "skips elsewhere, select with -m cuda",
    )


@pytest.fixture()
def state_root(tmp_path):
    """Isolated control-plane state root per test."""
    root = tmp_path / "state"
    os.environ["TPUSERVE_STATE_ROOT"] = str(root)
    yield root
    os.environ.pop("TPUSERVE_STATE_ROOT", None)
