"""Test configuration: run JAX on a virtual 8-device CPU mesh.

Multi-device sharding paths are validated on virtual CPU devices; CPU also
has native f64 and true-f32 matmuls, so oracle parity tests run at full
precision. The platform is the CPU unless ``JAX_PLATFORMS`` names another:
tests marked ``gpu`` run on a card with
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

import pathlib

import pytest

DATA = pathlib.Path(__file__).parent / "data"


@pytest.fixture(scope="session")
def data_path():
    return DATA
