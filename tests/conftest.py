"""Test configuration.

The suite runs on the CPU with 8 virtual devices, so multi-device sharding
paths are exercised without accelerator hardware (the
`xla_force_host_platform_device_count` fake-mesh strategy from SURVEY §4):

    JAX_PLATFORMS=cpu python -m pytest tests -m 'not gpu'

Tests marked `gpu` need an NVIDIA card; the `gpu_device` fixture skips them
elsewhere.  On a machine with a card, run them with the backend left alone:

    RT_GPU_TESTS=1 python -m pytest tests -m gpu
"""

import os

import pytest

GPU_TIER = os.environ.get("RT_GPU_TESTS", "") == "1"

if not GPU_TIER:
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=8"
    )

import jax  # noqa: E402

if not GPU_TIER:
    # wins over a JAX_PLATFORMS preset in the environment
    jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402


@pytest.fixture
def np_rng():
    return np.random.default_rng(1984)


@pytest.fixture
def gpu_device():
    """The first NVIDIA GPU; skips the test when there is none."""
    if jax.default_backend() != "gpu":
        pytest.skip(f"needs an NVIDIA GPU (backend is {jax.default_backend()})")
    return jax.devices()[0]


@pytest.fixture
def eight_devices():
    """The 8 virtual CPU devices the sharding tests mesh over."""
    if len(jax.devices()) < 8:
        pytest.skip(f"needs 8 devices, have {len(jax.devices())}")
    return jax.devices()[:8]


def _assert_renders_match(a, b, max_diverged=0.02):
    """Two renders of one scene with the same keys, through two traversals.

    Both traversals find the same closest hits, but the last bits of a hit
    distance may differ (another operation order), and a path whose hit
    point moves by an ulp can scatter differently from then on.  So most
    pixels must agree to float precision, at most `max_diverged` of them may
    differ, and the image means must agree.
    """
    a, b = np.asarray(a), np.asarray(b)
    close = np.all(np.abs(a - b) <= 1e-4 * (1.0 + np.abs(a)), axis=-1)
    assert close.mean() >= 1.0 - max_diverged, (
        f"{(~close).sum()} of {close.size} pixels differ")
    np.testing.assert_allclose(b.mean(axis=0), a.mean(axis=0), rtol=0.02,
                               atol=1e-3)


@pytest.fixture
def assert_renders_match():
    return _assert_renders_match
