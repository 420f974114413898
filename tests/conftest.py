"""Test configuration: run everything on a virtual 8-device CPU mesh.

Multi-chip hardware is unavailable in CI; shardings are validated on a
host-platform device mesh (mirrors the reference's thread-count-independent
determinism requirement, visual-testing/README.md:103). Nothing here reaches
a GPU: chip_smoke.py checks the CUDA walk and GPU renders on the card.
"""
import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)

