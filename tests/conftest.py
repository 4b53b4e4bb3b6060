"""Test configuration: an 8-device CPU mesh unless a platform is named.

With ``JAX_PLATFORMS`` unset (or ``cpu``) the suite runs on the CPU, split
into 8 virtual XLA devices: multi-device sharding is validated without
accelerators (SURVEY.md §4: shard-count invariance of all statistics is
part of the test pyramid).  Must run before jax initialises.

With ``JAX_PLATFORMS`` naming another platform (``cuda``), nothing is
forced, so the card-only tests (``-m gpu``) reach the card.
"""
import os

_PLATFORM = os.environ.setdefault("JAX_PLATFORMS", "cpu")
if _PLATFORM == "cpu":
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax  # noqa: E402

if _PLATFORM == "cpu":
    assert len(jax.devices()) == 8, (
        f"expected 8 virtual CPU devices, got {jax.devices()}"
    )

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where JAX finds none."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX platform is {dev.platform}")
    return dev
