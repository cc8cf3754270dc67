"""Give CPU test runs a few virtual devices so mesh/sharding paths are real.

This must execute before the first ``import jax`` of the session; pytest
imports conftest.py before collecting any test module, and none of the
active plugins import jax earlier. Single-device semantics are unchanged
for tests that never build a mesh (computations stay on device 0).
"""
import os

_FLAGS = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _FLAGS:
    os.environ["XLA_FLAGS"] = (
        _FLAGS + " --xla_force_host_platform_device_count=8"
    ).strip()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card (CUDA kernels of repro_torch); "
        "skipped where torch.cuda.is_available() is False")
