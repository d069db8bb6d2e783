"""Test configuration: JAX on the CPU with 8 virtual devices.

The suite runs on the CPU unless JAX_PLATFORMS names another platform;
multi-device sharding tests use 8 virtual CPU devices
(--xla_force_host_platform_device_count). Tests marked ``gpu`` need an
NVIDIA GPU and skip elsewhere; run them on a GPU machine with
``JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/``.
"""

import os
import sys

_flag = "--xla_force_host_platform_device_count=8"
if _flag not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " " + _flag).strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import pathlib

import jax
import pytest

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (skips elsewhere)")


@pytest.fixture
def repo_root():
    return pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU: run with JAX_PLATFORMS=cuda,cpu")
    return jax.devices()[0]
