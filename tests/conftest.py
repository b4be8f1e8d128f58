"""Test environment: the CPU backend with 8 virtual devices.

Pallas kernels run in interpret mode here (the `sw_emu` tier, SURVEY.md
SS4), and the 8-device virtual CPU mesh stands in for several cards in the
sharding tests. Tests that need an NVIDIA GPU carry the `gpu` marker and the
`gpu` fixture, which skips them when JAX finds no GPU; run them on the card
with `python -m pytest tests/ -m gpu` and no JAX_PLATFORMS override.
"""

import os

import jax
import numpy as np
import pytest

if os.environ.get("JAX_PLATFORMS", "cpu") == "cpu":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1234)


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU (decided here, at run
    time, never while test modules are imported)."""
    from mobilenet_tpu import platform

    if platform.accelerator() != "gpu":
        pytest.skip("needs an NVIDIA GPU; JAX found none")
