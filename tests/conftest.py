"""Test harness configuration.

Forces JAX onto the CPU backend with 8 virtual devices so that multi-device
sharding (`vaudio.parallel`) is exercised without accelerator hardware — the
test strategy called for in SURVEY.md §4.  Tests that need the card carry the
``gpu`` marker and the ``gpu_device`` fixture, which skips them on the CPU;
run them on a GPU host with
``VAUDIO_TEST_PLATFORM=cuda,cpu python -m pytest -m gpu tests/``.
"""

import os

# Must run before jax is imported anywhere.  The session may preset
# JAX_PLATFORMS; tests always run on the virtual CPU mesh unless
# explicitly redirected with VAUDIO_TEST_PLATFORM.
os.environ["JAX_PLATFORMS"] = os.environ.get("VAUDIO_TEST_PLATFORM", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

# Something may already have imported jax before this conftest runs, in
# which case env vars set above are ignored — force platform and virtual
# device count through the config system (both take effect as long as no
# backend has been initialized yet).
jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
if os.environ["JAX_PLATFORMS"] == "cpu":
    jax.config.update("jax_num_cpu_devices", 8)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu_device():
    """The first GPU, or a skip.  Decided here, at run time, never while
    a test module is imported (xdist workers must collect identical
    test lists)."""
    gpus = [d for d in jax.devices() if d.platform == "gpu"]
    if not gpus:
        pytest.skip("needs an NVIDIA GPU (run with VAUDIO_TEST_PLATFORM="
                    "cuda,cpu python -m pytest -m gpu tests/)")
    return gpus[0]
