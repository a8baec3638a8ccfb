"""The product path compiled for a GPU, against the plain oracle there.

Marked `gpu`: the `gpu_device` fixture skips every test without a GPU, and
`python chip_smoke.py` runs them on one (UVTRACE_TEST_PLATFORM=gpu keeps
conftest off the CPU pin). A GPU orders float operations differently from
the CPU, so triangle ids may differ on float ties between adjacent
triangles; distances and hit/miss masks may not.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def room():
    from uvtrace.geometry.procedural import make_box_room

    return make_box_room(subdivisions=6, clutter=6, seed=11)


@pytest.mark.parametrize("backend", ["clustered", "jax"])
@pytest.mark.parametrize("sampler", ["stratified", "native"])
def test_extend_matches_oracle_on_gpu(gpu_device, room, backend, sampler):
    from uvtrace.ops import generate as gen_ops
    from uvtrace.ops.intersect import brute_force_closest_hit
    from uvtrace.ops.select import build_extend

    lamp = jnp.array([0.0, room.floor_height + 0.8, 0.0], jnp.float32)
    key = jax.random.PRNGKey(3)
    if sampler == "stratified":
        r = gen_ops.generate_stratified(key, 1 << 14, lamp, 1.0)
    else:
        r = gen_ops.generate_native(key, 1 << 14, lamp, 1.0)
    ext = build_extend(room.tris, backend)
    res = jax.jit(ext.fn)(ext.scene, r.orig, r.dir)
    t, hit = np.asarray(res[0]), np.asarray(res[1])
    t_ref, id_ref = map(np.asarray, brute_force_closest_hit(r.orig, r.dir, jnp.asarray(room.tris)))
    assert res[0].devices() == {gpu_device}
    np.testing.assert_array_equal(hit < 0, id_ref < 0)
    np.testing.assert_allclose(t, t_ref, rtol=1e-5)
    assert (hit == id_ref).mean() >= 0.999


def test_simulator_deterministic_and_matches_cpu(gpu_device, room):
    """Two GPU runs are bit-equal; the same launch on the host CPU agrees
    up to float-tie winner flips between adjacent triangles."""
    from uvtrace.io.routexml import LightPos
    from uvtrace.sim import SimParams, Simulator

    p = SimParams(photon_count=1 << 16, max_iterations=1, seed=21, max_bounces=2,
                  reflectance=0.3)

    def run():
        sim = Simulator(room, p, route=[LightPos(0.1, -0.2, 1.0)])
        sim.run_iteration()
        return np.asarray(sim.photon_map)

    a, b = run(), run()
    np.testing.assert_array_equal(a, b)
    with jax.default_device(jax.devices("cpu")[0]):
        c = run()
    assert a.sum() > 1 << 16
    assert abs(a.sum() - c.sum()) / c.sum() < 0.01
    assert np.abs(a - c).sum() / c.sum() < 0.05


def test_diff_irradiance_matches_cpu(gpu_device):
    """The differentiable estimator and its gradient on the GPU and on the
    host CPU (the setting of tests/test_diff.py)."""
    from uvtrace.diff import irradiance, make_diff_scene
    from uvtrace.geometry.procedural import make_box_room

    room = make_box_room(subdivisions=4, clutter=1, seed=11, floor_y=-1.0)
    base_y = room.floor_height + 0.8

    def value_and_grad():
        # every input made under the current default device
        scene, key = make_diff_scene(room), jax.random.PRNGKey(5)

        def f(xz):
            return jnp.mean(irradiance(scene, xz, base_y, 1.0, 450.0, key, n_samples=2))

        return jax.value_and_grad(f)(jnp.array([0.3, -0.4]))

    v_dev, g_dev = value_and_grad()
    with jax.default_device(jax.devices("cpu")[0]):
        v_cpu, g_cpu = value_and_grad()
    assert g_dev.devices() == {gpu_device}
    np.testing.assert_allclose(float(v_dev), float(v_cpu), rtol=2e-3)
    np.testing.assert_allclose(np.asarray(g_dev), np.asarray(g_cpu), rtol=5e-3, atol=1e-7)


def test_transfer_keeps_float32_on_gpu(gpu_device, transfer_case):
    """The bounce transfer runs at HIGHEST precision: TF32 (~1e-3) would
    miss this float32 tolerance."""
    from uvtrace.diff.estimator import _neumann_sum

    e_dir, rho, f, w, reference = transfer_case
    got = _neumann_sum(jnp.asarray(e_dir, jnp.float32), jnp.asarray(rho, jnp.float32),
                       jnp.asarray(f, jnp.float32), w, 4)
    assert got.devices() == {gpu_device}
    np.testing.assert_allclose(np.asarray(got), reference(4), rtol=1e-5)
