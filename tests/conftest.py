"""Test config: run on a virtual 8-device CPU mesh (SURVEY §4d).

Tests must be deterministic and runnable without an accelerator; multi-device
sharding tests use xla_force_host_platform_device_count=8.  Tests that need
the GPU carry the ``gpu`` marker and take the ``gpu_device`` fixture, which
skips them where JAX finds no GPU.
"""

import os

# Correctness tests run on the CPU backend unless the caller names another
# platform; the ``gpu``-marked tests run on the card with
# ``JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu -p no:xdist``.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_ENABLE_X64", "0")
# XLA compiles dominate test time; cache compiled executables across pytest
# runs (pcr_tpu/__init__.py places the cache in the checkout unless
# JAX_COMPILATION_CACHE_DIR says otherwise).
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES", "0")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu_device():
    """The first JAX device when it is a GPU; skips the test otherwise.
    Decided here, at run time, never while a module is imported."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX found {dev.platform}")
    return dev


def random_rotation(rng) -> np.ndarray:
    """Haar-ish random rotation via QR."""
    A = rng.normal(size=(3, 3))
    Q, R = np.linalg.qr(A)
    Q = Q * np.sign(np.diag(R))
    if np.linalg.det(Q) < 0:
        Q[:, 0] = -Q[:, 0]
    return Q


@pytest.fixture
def random_rotation_fn(rng):
    return lambda: random_rotation(rng)
