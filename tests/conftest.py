"""Test configuration: run JAX on a virtual 8-device CPU mesh.

Multi-chip sharding is validated without accelerator hardware by forcing
the host platform with 8 virtual devices (SURVEY.md §4: replaces the
fake backends the reference lacks). ``jax.config.update`` runs here,
before any test touches a backend.

``RASR_TEST_GPU=1`` leaves the GPU visible (JAX_PLATFORMS decides) for
the card tests in tests/test_gpu.py, and runs them in one process:

    RASR_TEST_GPU=1 python -m pytest tests/test_gpu.py -m gpu

Which tests are collected never depends on the switch or on the
hardware; the card tests decide inside a fixture whether a GPU is there.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

if os.environ.get("RASR_TEST_GPU") != "1":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)

import numpy as np
import pytest


def pytest_configure(config):
    """One process for the card tests: a JAX process reserves most of
    the card's memory when it starts, so a second xdist worker on the
    same card would fail. This hook runs before xdist's trylast
    pytest_configure activates its DSession."""
    if os.environ.get("RASR_TEST_GPU") == "1":
        if getattr(config.option, "numprocesses", None):
            config.option.numprocesses = 0
        if getattr(config.option, "dist", "no") != "no":
            config.option.dist = "no"


@pytest.fixture
def rng():
    return np.random.default_rng(12345)
