"""Test configuration: force JAX onto CPU with 8 virtual devices.

Tests must be deterministic and multi-device-capable, so by default the CPU
backend is pinned and split into 8 virtual devices (SURVEY.md §4:
multi-device tests via xla_force_host_platform_device_count):

    JAX_PLATFORMS=cpu python -m pytest tests/ -q -m 'not slow'

Tests marked `gpu` compile the product path for a GPU and compare it with
the plain oracle there. They take the `gpu_device` fixture, which skips
them when the first JAX device is not a GPU. They run on a GPU machine
with UVTRACE_TEST_PLATFORM=gpu, which leaves JAX's device choice alone;
`python chip_smoke.py` runs them in its own process as one of its phases.
"""

import os

TEST_PLATFORM = os.environ.get("UVTRACE_TEST_PLATFORM", "cpu")

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
if "--xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] += " --xla_force_host_platform_device_count=8"

import jax

if TEST_PLATFORM == "cpu":
    os.environ["JAX_PLATFORMS"] = "cpu"
    jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest

ASSETS = os.path.join(os.path.dirname(__file__), "..", "assets")


@pytest.fixture
def gpu_device():
    """The first GPU; skips the test when JAX has none. Decided here, at
    run time, and never while modules are imported, so every xdist worker
    collects the same tests."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (JAX platform: {dev.platform})")
    return dev


@pytest.fixture(scope="session")
def testroom_mesh():
    from uvtrace.geometry.gltf import load_glb

    return load_glb(os.path.join(ASSETS, "testroomopt.glb"))


@pytest.fixture(scope="session")
def small_room():
    from uvtrace.geometry.procedural import make_box_room

    return make_box_room(subdivisions=4, clutter=3, seed=1)


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1234)


@pytest.fixture
def transfer_case():
    """A random 64-source field for the bounce transfer
    (diff/estimator._neumann_sum) and its float64 NumPy reference:
    returns (e_dir, rho, f, w, reference) with reference(n_bounces)."""
    gen = np.random.default_rng(0)
    m = 64
    e_dir = gen.uniform(0.5, 50.0, m)
    rho = gen.uniform(0.0, 0.5, m)
    f = gen.uniform(0.0, 1.0, (m, m)) / m
    np.fill_diagonal(f, 0.0)
    w = 1.7

    def reference(n_bounces):
        e_k = e_sum = e_dir.astype(np.float64)
        for _ in range(1, n_bounces):
            e_k = w * (rho * e_k) @ f
            e_sum = e_sum + e_k
        return e_sum

    return e_dir, rho, f, w, reference
