"""Test configuration: force an 8-fake-device CPU backend.

The standard JAX trick (SURVEY.md §4.3): mesh/shard_map/ppermute logic is
tested hostless with ``--xla_force_host_platform_device_count=8``, and
``jax_platforms`` is pinned to the CPU before first backend use, so the
tests run the same on a machine with a GPU. The SGM kernel runs under
``interpret=True`` here (backend="pallas_interpret"). Tests that need the
card carry the ``chip`` marker and the ``chip`` fixture, which skips them
without one; ``STEREO_ON_CHIP=1`` leaves the platform to JAX so they run
on the card (README "Running on the GPU").
"""

import os
import sys

import pytest  # noqa: E402

ON_CHIP = os.environ.get("STEREO_ON_CHIP") == "1"

if not ON_CHIP:
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=8"
    )

import jax  # noqa: E402

if not ON_CHIP:
    jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.fixture
def chip():
    """Skip unless JAX runs on a GPU (tests marked ``chip``)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (run with STEREO_ON_CHIP=1 there)")
