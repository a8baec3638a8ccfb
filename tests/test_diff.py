"""Differentiable dose layer: gradient checks vs finite differences (CRN),
cross-validation against the count-based simulator, route optimization."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from uvtrace.diff import irradiance, make_diff_scene, optimize_route, route_dose
from uvtrace.geometry.procedural import make_box_room, make_single_square
from uvtrace.io.routexml import LightPos
from uvtrace.sim import SimParams, Simulator, ViewMode


@pytest.fixture(scope="module")
def room_scene():
    room = make_box_room(subdivisions=4, clutter=1, seed=11, floor_y=-1.0)
    return room, make_diff_scene(room)


def test_irradiance_positive_and_finite(room_scene):
    room, scene = room_scene
    e = irradiance(
        scene, jnp.array([0.0, 0.0]), room.floor_height + 0.8, 1.0, 450.0,
        jax.random.PRNGKey(0), n_samples=8,
    )
    e = np.asarray(e)
    assert np.isfinite(e).all() and (e >= 0).all()
    assert (e > 0).mean() > 0.5  # most of a convex-ish room sees the lamp


def test_matches_count_estimator_unoccluded():
    """E[count dose] == analytic G on an unoccluded target: the two
    estimators must agree (cross-validation, SURVEY.md §4)."""
    sq = make_single_square(center=(0.0, 0.5, 2.0), half_width=0.1)
    p = SimParams(photon_count=1 << 20, max_iterations=1, light_length=1.0)
    sim = Simulator(sq, p, route=[LightPos(0.0, 0.0, 1.0)])
    sim.mesh.floor_height = -p.light_height  # rod base at y=0
    sim.compute()
    count_irr = np.asarray(sim.dosage_map(ViewMode.MAX_POWER))  # µW/cm^2

    scene = make_diff_scene(sq)
    e = irradiance(
        scene, jnp.array([0.0, 0.0]), 0.0, 1.0, p.light_intensity,
        jax.random.PRNGKey(1), n_samples=256,
    )
    analytic_irr = 100.0 * np.asarray(e)  # W/m^2 -> µW/cm^2
    np.testing.assert_allclose(count_irr.mean(), analytic_irr.mean(), rtol=0.05)


def test_jax_visibility_backend_matches_clustered(room_scene):
    """Shadow rays through the per-ray BVH walk and through the budget-free
    clustered backend: visibility is binary and backend-agnostic, so the
    estimates agree."""
    room, _ = room_scene
    scene_cl = make_diff_scene(room, backend="clustered")
    scene_jax = make_diff_scene(room, backend="jax")
    key = jax.random.PRNGKey(5)
    args = (jnp.array([0.3, -0.4]), room.floor_height + 0.8, 1.0, 450.0, key)
    e_cl = np.asarray(irradiance(scene_cl, *args, n_samples=2))
    e_jax = np.asarray(irradiance(scene_jax, *args, n_samples=2))
    np.testing.assert_allclose(e_jax, e_cl, rtol=2e-3, atol=1e-6)


def test_sharded_visibility_bit_identical(room_scene):
    """make_diff_scene(device_mesh=...) shards shadow rays over the ray
    axis; visibility is per-ray deterministic, so irradiance AND its
    gradients are bit-identical to the single-device scene."""
    from uvtrace.parallel import make_ray_mesh

    room, scene_single = room_scene
    scene_sh = make_diff_scene(room, device_mesh=make_ray_mesh(8))
    key = jax.random.PRNGKey(6)
    base_y = room.floor_height + 0.8

    def f(scene, xz):
        return irradiance(scene, xz, base_y, 1.0, 450.0, key, n_samples=2)

    x0 = jnp.array([0.25, -0.35])
    np.testing.assert_array_equal(
        np.asarray(f(scene_single, x0)), np.asarray(f(scene_sh, x0))
    )
    g1 = np.asarray(jax.grad(lambda xz: jnp.mean(f(scene_single, xz)))(x0))
    g8 = np.asarray(jax.grad(lambda xz: jnp.mean(f(scene_sh, xz)))(x0))
    np.testing.assert_array_equal(g1, g8)


def test_grad_through_jax_backend(room_scene):
    """jax.grad works with either visibility backend: gradients are severed
    at _visibility's INPUTS, so the traversal is never differentiated.
    Gradients agree between backends (same estimator, same CRN)."""
    room, _ = room_scene
    scene_cl = make_diff_scene(room, backend="clustered")
    scene_jax = make_diff_scene(room, backend="jax")
    key = jax.random.PRNGKey(3)
    base_y = room.floor_height + 0.8

    def f(scene, xz):
        return jnp.mean(irradiance(scene, xz, base_y, 1.0, 450.0, key,
                                   n_samples=2))

    x0 = jnp.array([0.2, -0.1])
    g_jax = np.asarray(jax.grad(lambda xz: f(scene_jax, xz))(x0))
    g_cl = np.asarray(jax.grad(lambda xz: f(scene_cl, xz))(x0))
    assert np.isfinite(g_jax).all()
    np.testing.assert_allclose(g_jax, g_cl, rtol=5e-3, atol=1e-7)


def test_gradient_matches_finite_difference(room_scene):
    """AD gradient == central FD of the same CRN estimator (the documented
    contract: visibility held fixed, geometry differentiated)."""
    room, scene = room_scene
    key = jax.random.PRNGKey(3)
    base_y = room.floor_height + 0.8

    def f(xz):
        e = irradiance(scene, xz, base_y, 1.0, 450.0, key, n_samples=4)
        return jnp.mean(e)

    x0 = jnp.array([0.3, -0.2])
    g = np.asarray(jax.grad(f)(x0))
    eps = 1e-3
    for i in range(2):
        d = np.zeros(2)
        d[i] = eps
        fd = (float(f(x0 + d)) - float(f(x0 - d))) / (2 * eps)
        np.testing.assert_allclose(g[i], fd, rtol=0.08, atol=1e-5)


def test_gradient_wrt_durations(room_scene):
    room, scene = room_scene
    key = jax.random.PRNGKey(4)
    wp = jnp.array([[0.0, 0.0], [0.5, 0.5]])

    def f(durs):
        dose = route_dose(scene, wp, durs, room.floor_height + 0.8, 1.0, 450.0, key,
                          n_samples=2)
        return jnp.mean(dose)

    durs = jnp.array([30.0, 60.0])
    g = np.asarray(jax.grad(f)(durs))
    # dose is linear in durations: gradient equals the per-waypoint mean dose rate
    assert (g > 0).all()
    eps = 1.0
    fd0 = (float(f(durs + jnp.array([eps, 0.0]))) - float(f(durs))) / eps
    np.testing.assert_allclose(g[0], fd0, rtol=1e-4)


def test_route_optimization_improves_min_dose(room_scene):
    room, scene = room_scene
    init_wp = np.array([[1.5, 2.5]])  # corner start
    res = optimize_route(
        scene, init_wp, np.array([60.0]),
        room.floor_height + 0.8, 1.0, 450.0,
        steps=25, learning_rate=0.1, n_samples=2, temperature=10.0,
        optimize_durations=False, seed=0,
    )
    assert len(res.history) == 25
    # loss = -softmin(dose): optimization must reduce it
    assert res.history[-1] < res.history[0]
    assert np.isfinite(res.final_min_dose)
    # waypoint should move toward the room interior
    assert np.linalg.norm(res.waypoints_xz[0]) < np.linalg.norm(init_wp[0])


class TestOneBounce:
    """Differentiable diffuse interreflection with per-surface reflectance
    (SURVEY.md §7: gradients w.r.t. ... per-surface reflectance)."""

    def _e1(self, scene, room, rho, key=0, **kw):
        from uvtrace.diff import one_bounce_irradiance

        return one_bounce_irradiance(
            scene, jnp.array([0.0, 0.0]), room.floor_height + 0.8, 1.0,
            450.0, rho, jnp.asarray(room.areas), jax.random.PRNGKey(key), **kw
        )

    def test_positive_and_scales_linearly_with_rho(self, room_scene):
        room, scene = room_scene
        t = room.triangle_count
        e1 = self._e1(scene, room, jnp.full((t,), 0.5))
        e2 = self._e1(scene, room, jnp.full((t,), 1.0))
        e1, e2 = np.asarray(e1), np.asarray(e2)
        assert np.isfinite(e1).all() and (e1 >= 0).all() and e1.max() > 0
        np.testing.assert_allclose(e2, 2.0 * e1, rtol=1e-5)

    def test_reflectance_gradient_exact(self, room_scene):
        """E1 is LINEAR in reflectance, so AD gradients equal finite
        differences to float precision (same key = same estimator)."""
        from uvtrace.diff import one_bounce_irradiance

        room, scene = room_scene
        t = room.triangle_count
        rho0 = jnp.full((t,), 0.4)

        def j(rho):
            return jnp.sum(self._e1(scene, room, rho, n_samples=2, n_sources=16))

        g = np.asarray(jax.grad(j)(rho0))
        eps = 0.05
        for i in (0, t // 2):
            basis = jnp.zeros((t,)).at[i].set(1.0)
            fd = (j(rho0 + eps * basis) - j(rho0 - eps * basis)) / (2 * eps)
            np.testing.assert_allclose(g[i], float(fd), rtol=1e-3, atol=1e-7)

    def test_lamp_gradient_matches_fd(self, room_scene):
        """Lamp-position gradients flow through the source irradiance;
        CRN makes FD of the same estimator meaningful (away from
        silhouettes — the documented visibility contract)."""
        room, scene = room_scene
        t = room.triangle_count
        rho = jnp.full((t,), 0.5)

        def j(xz):
            from uvtrace.diff import one_bounce_irradiance

            return jnp.sum(
                one_bounce_irradiance(
                    scene, xz, room.floor_height + 0.8, 1.0, 450.0, rho,
                    jnp.asarray(room.areas), jax.random.PRNGKey(3),
                    n_samples=2, n_sources=16,
                )
            )

        xz0 = jnp.array([0.1, -0.2])
        g = np.asarray(jax.grad(j)(xz0))
        for i in range(2):
            e = jnp.zeros((2,)).at[i].set(1e-3)
            fd = (j(xz0 + e) - j(xz0 - e)) / 2e-3
            np.testing.assert_allclose(g[i], float(fd), rtol=5e-2, atol=1e-4)

    def test_cross_validates_count_bounce_estimator(self):
        """Expected bounce-arrival flux of the count estimator (survive w.p.
        rho, cosine re-emission) equals A_t * E1_t: total bounce dose agrees
        between the two estimators on a closed box."""
        room = make_box_room(subdivisions=3, clutter=0, seed=5)
        rho = 0.5
        p0 = SimParams(photon_count=1 << 18, max_iterations=2, seed=2)
        direct = Simulator(room, p0, route=[LightPos(0.0, 0.0, 1.0)])
        direct.compute()
        p1 = dataclasses.replace(p0, max_bounces=1, reflectance=rho)
        both = Simulator(room, p1, route=[LightPos(0.0, 0.0, 1.0)])
        both.compute()
        bounce_dose = np.asarray(both.dosage_map()) - np.asarray(direct.dosage_map())

        from uvtrace.diff import one_bounce_irradiance

        scene = make_diff_scene(room)
        e1 = one_bounce_irradiance(
            scene, jnp.array([0.0, 0.0]), room.floor_height + 0.8, 1.0,
            p0.light_intensity, jnp.full((room.triangle_count,), rho),
            jnp.asarray(room.areas), jax.random.PRNGKey(4),
            n_samples=8, n_sources=256,
        )
        # dose units: 0.1 * duration * E (Report §3 Eq. 1); duration=1
        diff_dose = 0.1 * np.asarray(e1)
        # area-weighted means (total flux) agree
        a = np.asarray(room.areas)
        np.testing.assert_allclose(
            (bounce_dose * a).sum(), (diff_dose * a).sum(), rtol=0.15
        )


class TestMultiBounce:
    """Multi-bounce differentiable interreflection (round-4 verdict #1:
    the gradient model must match the forward model's transport depth)."""

    def _eb(self, scene, room, rho, n_bounces, key=0, **kw):
        from uvtrace.diff import bounce_irradiance

        kw.setdefault("n_samples", 2)
        kw.setdefault("n_sources", 24)
        return bounce_irradiance(
            scene, jnp.array([0.0, 0.0]), room.floor_height + 0.8, 1.0,
            450.0, rho, jnp.asarray(room.areas), jax.random.PRNGKey(key),
            n_bounces=n_bounces, **kw
        )

    def test_terms_positive_monotone_and_decaying(self, room_scene):
        """Adding bounce levels only adds energy; successive Neumann terms
        shrink by at least ~rho (physical contraction of the transfer
        operator in a closed room)."""
        room, scene = room_scene
        t = room.triangle_count
        rho = jnp.full((t,), 0.5)
        e1 = np.asarray(self._eb(scene, room, rho, 1))
        e2 = np.asarray(self._eb(scene, room, rho, 2))
        e3 = np.asarray(self._eb(scene, room, rho, 3))
        assert np.isfinite(e3).all()
        assert (e2 >= e1 - 1e-6).all() and (e3 >= e2 - 1e-6).all()
        term2, term3 = (e2 - e1).sum(), (e3 - e2).sum()
        assert 0 < term2 < e1.sum()  # second bounce is a correction
        assert 0 < term3 < term2  # and the series contracts

    def test_chunked_receiver_pass_matches_unchunked(self, room_scene):
        """ADVICE r4: the source loop is chunked (lax.map) so peak memory is
        bounded; chunking must not change the estimate (same RNG)."""
        room, scene = room_scene
        rho = jnp.full((room.triangle_count,), 0.4)
        a = self._eb(scene, room, rho, 2, source_chunk=4)
        b = self._eb(scene, room, rho, 2, source_chunk=64)
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5, atol=1e-8)

    def test_reflectance_gradient_matches_fd_two_bounce(self, room_scene):
        """With 2 bounces the estimator is QUADRATIC in reflectance; AD
        gradients must match central FD (exact for quadratics, CRN)."""
        room, scene = room_scene
        t = room.triangle_count
        rho0 = jnp.full((t,), 0.4)

        def j(rho):
            return jnp.sum(self._eb(scene, room, rho, 2, n_sources=16))

        g = np.asarray(jax.grad(j)(rho0))
        eps = 0.05
        for i in (0, t // 2):
            basis = jnp.zeros((t,)).at[i].set(1.0)
            fd = (j(rho0 + eps * basis) - j(rho0 - eps * basis)) / (2 * eps)
            np.testing.assert_allclose(g[i], float(fd), rtol=1e-3, atol=1e-7)

    def test_lamp_gradient_matches_fd_two_bounce(self, room_scene):
        room, scene = room_scene
        rho = jnp.full((room.triangle_count,), 0.5)

        def j(xz):
            from uvtrace.diff import bounce_irradiance

            return jnp.sum(
                bounce_irradiance(
                    scene, xz, room.floor_height + 0.8, 1.0, 450.0, rho,
                    jnp.asarray(room.areas), jax.random.PRNGKey(3),
                    n_samples=2, n_sources=16, n_bounces=2,
                )
            )

        xz0 = jnp.array([0.1, -0.2])
        g = np.asarray(jax.grad(j)(xz0))
        for i in range(2):
            e = jnp.zeros((2,)).at[i].set(1e-3)
            fd = (j(xz0 + e) - j(xz0 - e)) / 2e-3
            np.testing.assert_allclose(g[i], float(fd), rtol=5e-2, atol=1e-4)

    def test_cross_validates_count_two_bounce_estimator(self):
        """Total 2-bounce dose agrees between the count pipeline
        (max_bounces=2: survive w.p. rho, cosine re-emit, two segments) and
        the differentiable 2-term Neumann estimator on a closed box."""
        room = make_box_room(subdivisions=3, clutter=0, seed=5)
        rho = 0.5
        p0 = SimParams(photon_count=1 << 18, max_iterations=2, seed=2)
        direct = Simulator(room, p0, route=[LightPos(0.0, 0.0, 1.0)])
        direct.compute()
        p2 = dataclasses.replace(p0, max_bounces=2, reflectance=rho)
        both = Simulator(room, p2, route=[LightPos(0.0, 0.0, 1.0)])
        both.compute()
        bounce_dose = np.asarray(both.dosage_map()) - np.asarray(direct.dosage_map())

        from uvtrace.diff import bounce_irradiance

        scene = make_diff_scene(room)
        eb = bounce_irradiance(
            scene, jnp.array([0.0, 0.0]), room.floor_height + 0.8, 1.0,
            p0.light_intensity, jnp.full((room.triangle_count,), rho),
            jnp.asarray(room.areas), jax.random.PRNGKey(4),
            n_samples=8, n_sources=256, n_bounces=2,
        )
        diff_dose = 0.1 * np.asarray(eb)
        a = np.asarray(room.areas)
        np.testing.assert_allclose(
            (bounce_dose * a).sum(), (diff_dose * a).sum(), rtol=0.15
        )


def test_optimize_route_reflectance_changes_result(room_scene):
    """round-4 verdict #3: reflectance must REACH the optimizer — a
    reflective room yields different gradients (and after a few steps,
    different waypoints) than rho=0 from the same start."""
    room, scene = room_scene
    init_wp = np.array([[1.0, 1.5]], np.float32)
    durs = np.array([60.0], np.float32)
    kw = dict(steps=3, n_samples=2, optimize_durations=False, seed=0)
    plain = optimize_route(
        scene, init_wp, durs, room.floor_height + 0.8, 1.0, 450.0, **kw
    )
    refl = optimize_route(
        scene, init_wp, durs, room.floor_height + 0.8, 1.0, 450.0,
        reflectance=0.6, areas=np.asarray(room.areas), n_sources=16,
        n_bounces=2, **kw
    )
    # the bounce term adds dose everywhere -> losses differ at step 0 already
    assert refl.history[0] < plain.history[0]
    assert not np.allclose(refl.waypoints_xz, plain.waypoints_xz)


def test_route_dose_with_bounce_term(room_scene):
    """route_dose(reflectance=...) adds the differentiable one-bounce term;
    dose strictly increases everywhere dose was already positive."""
    room, scene = room_scene
    wp = jnp.array([[0.0, 0.0]])
    durs = jnp.array([60.0])
    base = route_dose(
        scene, wp, durs, room.floor_height + 0.8, 1.0, 450.0,
        jax.random.PRNGKey(0), n_samples=2,
    )
    withb = route_dose(
        scene, wp, durs, room.floor_height + 0.8, 1.0, 450.0,
        jax.random.PRNGKey(0), n_samples=2,
        reflectance=jnp.full((room.triangle_count,), 0.5),
        areas=jnp.asarray(room.areas), n_sources=16,
    )
    base, withb = np.asarray(base), np.asarray(withb)
    assert (withb >= base - 1e-6).all()
    assert withb.sum() > base.sum()


def test_optimize_durations_false_freezes_durations(room_scene):
    """optimize_durations=False must actually freeze dwell times (optax
    masked() passed the raw gradient through — unscaled ASCENT on the
    frozen leaf; multi_transform + set_to_zero freezes for real)."""
    room, scene = room_scene
    init_wp = np.array([[0.2, 0.1], [-0.4, 0.3]], np.float32)
    init_durs = np.array([40.0, 20.0], np.float32)
    res = optimize_route(
        scene, init_wp, init_durs, room.floor_height + 0.8, 1.0, 450.0,
        steps=3, n_samples=2, optimize_durations=False,
    )
    np.testing.assert_allclose(res.durations, init_durs, rtol=1e-5)
    assert not np.allclose(res.waypoints_xz, init_wp)  # positions did move


def test_optimize_bounds_init_roundtrip(room_scene):
    """With bounds=, optimization must START from the requested waypoints
    (inverse-sigmoid init): zero steps returns the init, inside bounds."""
    room, scene = room_scene
    init_wp = np.array([[2.0, 3.0]], np.float32)
    res = optimize_route(
        scene, init_wp, np.array([60.0], np.float32),
        room.floor_height + 0.8, 1.0, 450.0,
        steps=0, n_samples=2, bounds=((0.0, 0.0), (5.0, 5.0)),
    )
    np.testing.assert_allclose(res.waypoints_xz, init_wp, atol=1e-3)
