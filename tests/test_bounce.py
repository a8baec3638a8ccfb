"""Multi-bounce diffuse interreflection (Russian roulette) — BASELINE
config 2 superset semantics."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from uvtrace.geometry.procedural import make_box_room
from uvtrace.io.routexml import LightPos
from uvtrace.ops.bounce import cosine_hemisphere, orthonormal_basis
from uvtrace.sim import SimParams, Simulator


def test_onb_orthonormal(rng):
    n = rng.normal(size=(500, 3))
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    t1, t2 = orthonormal_basis(jnp.asarray(n, jnp.float32))
    t1, t2 = np.asarray(t1), np.asarray(t2)
    for a, b in [(t1, t2), (t1, n), (t2, n)]:
        dots = np.abs(np.sum(a * b, axis=1))
        assert dots.max() < 1e-5
    np.testing.assert_allclose(np.linalg.norm(t1, axis=1), 1.0, atol=1e-5)


def test_cosine_hemisphere_distribution():
    n = jnp.broadcast_to(jnp.array([0.0, 1.0, 0.0]), (20000, 3))
    d = np.asarray(cosine_hemisphere(jax.random.PRNGKey(0), n))
    assert (d[:, 1] > 0).all()  # all in the hemisphere
    np.testing.assert_allclose(np.linalg.norm(d, axis=1), 1.0, atol=1e-5)
    # cosine-weighted: E[cos theta] = 2/3
    assert abs(d[:, 1].mean() - 2 / 3) < 0.01


@pytest.fixture(scope="module")
def room():
    return make_box_room(subdivisions=4, clutter=1, seed=5, floor_y=-1.0)


def _total_counts(room, bounces, rho, n=1 << 15):
    p = SimParams(
        photon_count=n, max_iterations=1, max_bounces=bounces, reflectance=rho, seed=3
    )
    sim = Simulator(room, p, route=[LightPos(0.0, 0.0, 1.0)])
    sim.compute()
    return float(jnp.sum(sim.photon_map)), sim


def test_zero_bounces_matches_reference_mode(room):
    t0, _ = _total_counts(room, 0, 0.0)
    t1, _ = _total_counts(room, 4, 0.0)  # rho=0 -> RR kills everything
    assert t0 == t1


def test_bounce_deposits_grow_geometrically(room):
    """With survival prob rho, expected total deposits ~ N * (1-rho^{B+1})/(1-rho)
    for B bounces in a closed room (every bounce hits something)."""
    n = 1 << 15
    rho = 0.5
    t0, _ = _total_counts(room, 0, rho, n)
    t4, _ = _total_counts(room, 4, rho, n)
    hit_frac = t0 / n
    expected = t0 * (1 - rho**5) / (1 - rho)
    assert abs(t4 - expected) / expected < 0.05, (t4, expected)


def test_bounce_spreads_dose(room):
    """Interreflection must deposit dose on triangles the lamp cannot see
    directly (e.g. shadowed faces) — coverage strictly grows."""
    _, sim0 = _total_counts(room, 0, 0.9, 1 << 16)
    _, sim4 = _total_counts(room, 4, 0.9, 1 << 16)
    cov0 = float((sim0.photon_map > 0).mean())
    cov4 = float((sim4.photon_map > 0).mean())
    assert cov4 >= cov0


def test_per_triangle_reflectance(room):
    p = SimParams(photon_count=1 << 14, max_iterations=1, max_bounces=2, reflectance=0.0)
    sim = Simulator(room, p, route=[LightPos(0.0, 0.0, 1.0)])
    sim.set_reflectance(np.linspace(0.0, 0.8, room.triangle_count).astype(np.float32))
    sim.compute()
    assert float(jnp.sum(sim.photon_map)) > 0


@pytest.mark.parametrize("bounces", [1, 2, 4])
def test_bounce_clustered_matches_jax(room, bounces):
    """Both extend backends are exact and bounce segments re-launch through
    the same backend in the same lane order, so the same photons and the
    same bounce RNG give bit-identical counts at every depth (the histogram
    is order-invariant)."""
    params = SimParams(
        photon_count=4096, max_iterations=1, max_bounces=bounces, reflectance=0.6,
    )

    def run(backend):
        sim = Simulator(
            room,
            dataclasses.replace(params, traversal=backend),
            route=[LightPos(0.2, -0.1, 1.0)],
            ray_chunk=1024,
            max_clusters=1 << 30,  # budget-free
        )
        sim.run_iteration()
        return np.asarray(sim.photon_map)

    m_c, m_j = run("clustered"), run("jax")
    np.testing.assert_array_equal(m_c, m_j)
    assert m_j.sum() > 4096  # bounces deposited extra dose
