"""Test harness config: an 8-virtual-device CPU platform by default.

Tests exercise sharding on a virtual mesh; speed is measured on the card
by ``chip_smoke.py``. Card-only tests carry the ``gpu`` marker and skip
without a GPU; run them on the card with
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``. The environment
must be set before jax is imported anywhere in the test process.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(1234)
