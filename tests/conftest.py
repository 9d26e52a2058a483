"""Test configuration: run everything on the CPU with eight virtual devices
so mesh and collective code paths execute for real without a GPU
(SURVEY.md §4 "Multi-node without a cluster").  Pallas kernels run in
interpret mode here (tests pass `interpret=True`); tests that need the card
carry the `gpu` marker, skip here through the `gpu` fixture, and run on the
card through `python chip_smoke.py`."""

import os

# Set before the first backend use, so an installed CUDA plugin is never
# initialised by a test process.
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where there is none."""
    devs = [d for d in jax.devices() if d.platform == "gpu"]
    if not devs:
        pytest.skip("needs a GPU; runs on the card via chip_smoke.py")
    return devs[0]
