"""Test configuration: run everything on CPU with 8 virtual devices so
multi-device sharding tests work without several accelerators
(SURVEY.md §4).

Tests that need the card carry the ``gpu`` marker and skip here; their
bodies run on the GPU through ``python chip_smoke.py`` (phase 3 runs
tests/test_gpu_oracle.py). Whether a card is present is decided inside
the ``gpu_device`` fixture, never at import or collection time, so every
test worker collects the same tests.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"  # for any late jax re-reads

import jax
import pytest

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skips on the CPU suite "
        "(run on the card with `python chip_smoke.py`)",
    )


@pytest.fixture
def gpu_device():
    """The first GPU device, or a skip when JAX runs without one."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (the CPU suite runs on the host); "
                    "run `python chip_smoke.py` on the card")
    return jax.devices()[0]
