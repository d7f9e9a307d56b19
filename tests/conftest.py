"""Test configuration: CPU backend with 8 simulated devices.

Env vars MUST be set before the first `import jax` anywhere in the process:
- JAX_PLATFORMS=cpu, unless NESTMC_GPU_TESTS=1 (set by chip_smoke.py for
  its `pytest -m gpu` phase on the card);
- xla_force_host_platform_device_count=8 gives a virtual 8-device mesh for
  sharding tests (SURVEY.md section 4 "distributed without a cluster").

Tests that need the card carry @pytest.mark.gpu; whether one is present is
decided inside a fixture at run time, never at import or collection.
"""

import os

if os.environ.get("NESTMC_GPU_TESTS", "") != "1":
    os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    _flags = (_flags + " --xla_force_host_platform_device_count=8").strip()
if "xla_cpu_collective_call_terminate_timeout_seconds" not in _flags:
    # 8 simulated device threads time-slicing on a small core count can
    # miss XLA-CPU's default 40 s collective rendezvous window on
    # non-trivial programs, which ABORTS the process (observed at nproc=1:
    # "only 5 of 8 threads arrived"); give them room.
    _flags = (
        _flags + " --xla_cpu_collective_call_terminate_timeout_seconds=1200"
    ).strip()
os.environ["XLA_FLAGS"] = _flags

import jax  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(autouse=True)
def _gpu_marker(request):
    """Skip @pytest.mark.gpu tests unless JAX runs on a GPU."""
    if request.node.get_closest_marker("gpu") is None:
        return
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU (run `python chip_smoke.py` on the card)")


@pytest.fixture(scope="session")
def devices8():
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs 8 simulated devices")
    return devs
