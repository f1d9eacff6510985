"""Test harness: run JAX on a simulated 8-device CPU mesh.

``XLA_FLAGS`` must carry the device count before the CPU backend is
created, and the platform is pinned to the CPU both through the
environment and through ``jax.config``, so every test (including the
sharded ones) runs the same way on any machine.  Tests that need a real
GPU get the ``gpu`` marker and decide inside a fixture (never at import)
whether a card is present.  On a machine with a GPU, ``python
chip_smoke.py`` drives the device path end to end.
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "gpu: needs a real GPU (skips on the CPU test mesh; the GPU path "
        "is driven end to end by chip_smoke.py)",
    )


@pytest.fixture(params=["host", "device"])
def backend(request):
    """Run parity tests on both the numpy scalar path and the JAX path."""
    return request.param
