"""Test configuration: by default run everything on the CPU with 8 virtual
devices, so the sharded-table / sharded-top-k logic is testable on any
machine.

Tests marked ``gpu`` need an NVIDIA GPU (the scaled oracle-parity gates).
They skip on the CPU; run them on a GPU host with

    RANKFM_TEST_GPU=1 python -m pytest tests/ -m gpu -q

``RANKFM_TEST_GPU=1`` keeps the real device instead of forcing the CPU.
Whether a GPU is present is decided inside the ``gpu`` fixture, when a
test runs — never while a module is imported, so every pytest-xdist
worker collects the same tests.
"""

import os

import jax
import pytest

if not os.environ.get("RANKFM_TEST_GPU"):
    os.environ["JAX_PLATFORMS"] = "cpu"  # for any subprocesses we spawn
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)


@pytest.fixture(autouse=True)
def gpu(request):
    """Skip a ``gpu``-marked test unless JAX's default device is a GPU."""
    if request.node.get_closest_marker("gpu") is not None:
        platform = jax.devices()[0].platform
        if platform != "gpu":
            pytest.skip(f"needs an NVIDIA GPU (default device is {platform}); "
                        "run with RANKFM_TEST_GPU=1 -m gpu on a GPU host")
