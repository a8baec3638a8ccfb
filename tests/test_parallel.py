"""Sharded execution on the 8-virtual-device CPU mesh (conftest forces
XLA_FLAGS=--xla_force_host_platform_device_count=8).

All multi-device tests run the PRODUCT path — Simulator(device_mesh=...) /
parallel.sharded_launch_fn wrapping the same launch_counts the single-device
pipeline runs (one pipeline, round-2 verdict #4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from uvtrace.geometry.procedural import make_box_room
from uvtrace.ops.cluster import build_clusters
from uvtrace.ops.traverse_clustered import cluster_arrays
from uvtrace.parallel import make_ray_mesh


@pytest.fixture(scope="module")
def setup():
    room = make_box_room(subdivisions=4, clutter=2, seed=3)
    cs = build_clusters(room.tris, cluster_size=128)
    return room, cluster_arrays(cs)


def test_mesh_has_8_devices():
    mesh = make_ray_mesh()
    assert mesh.devices.size == 8


def test_sharded_counts_conservation(setup):
    """Closed-room conservation through the product sharded path: every
    photon lands on some triangle (the reference's implicit invariant —
    sum(counts) <= N, SURVEY.md §4 property tests)."""
    from uvtrace.io.routexml import LightPos
    from uvtrace.sim import SimParams, Simulator

    room, _ = setup
    sim = Simulator(
        room,
        SimParams(photon_count=1 << 13, max_iterations=1),
        route=[LightPos(0.0, 0.0, 1.0)],
        ray_chunk=1024,
        device_mesh=make_ray_mesh(),
    )
    sim.run_iteration()
    counts = np.asarray(sim.photon_map)
    total = sim.photon_map_size
    assert 0 < counts.sum() <= total
    assert counts.sum() > 0.95 * total  # closed room interior


def test_mesh_factorization_invariance(setup):
    """The global-chunk-index RNG makes counts invariant to HOW the launch is
    split: 1 device == 8 devices (exact, not just in distribution)."""
    from uvtrace.io.routexml import LightPos
    from uvtrace.sim import SimParams, Simulator

    room, _ = setup
    maps = {}
    for nd in (1, 2, 8):
        sim = Simulator(
            room,
            SimParams(photon_count=1 << 13, max_iterations=1),
            route=[LightPos(0.3, -0.2, 1.0)],
            ray_chunk=1024,
            device_mesh=make_ray_mesh(nd),
        )
        sim.run_iteration()
        maps[nd] = np.asarray(sim.photon_map)
    np.testing.assert_array_equal(maps[1], maps[2])
    np.testing.assert_array_equal(maps[1], maps[8])


def test_simulator_sharded_bitexact_vs_single_device(setup):
    """The PRODUCT multi-chip path: Simulator(device_mesh=...) must produce
    bit-identical dose maps for 1 and 8 devices (global-chunk-index RNG,
    psum of partials — uvtrace/sim/simulator.py:_launch_sharded)."""
    from uvtrace.io.routexml import LightPos
    from uvtrace.sim import SimParams, Simulator

    room, _ = setup
    route = [LightPos(0.0, 0.0, 2.0), LightPos(0.4, -0.3, 1.0)]
    for sampler in ("stratified", "reference"):
        maps = {}
        for nd in (1, 8):
            sim = Simulator(
                room,
                SimParams(photon_count=1 << 12, max_iterations=1, sampler=sampler),
                route=list(route),
                # 2048 photons/lamp must divide ndev*chunk for the 1-dev and
                # 8-dev launches to round to the same n (else 8-dev rounds up)
                ray_chunk=256,
                device_mesh=make_ray_mesh(nd),
            )
            sim.run_iteration()
            maps[nd] = (np.asarray(sim.photon_map), np.asarray(sim.max_photon_map))
        assert np.array_equal(maps[1][0], maps[8][0]), sampler
        assert np.array_equal(maps[1][1], maps[8][1]), sampler
        assert maps[8][0].sum() > 0


def test_simulator_sharded_bounce_bitexact(setup):
    """Bounce mode under shard_map: global-index bounce keys keep 1-dev and
    8-dev runs identical (multi-bounce + RR, ops/bounce.py)."""
    from uvtrace.io.routexml import LightPos
    from uvtrace.sim import SimParams, Simulator

    room, _ = setup
    params = SimParams(
        photon_count=1 << 12, max_iterations=1, max_bounces=2, reflectance=0.5
    )
    maps = {}
    for nd in (1, 8):
        sim = Simulator(
            room, params, route=[LightPos(0.1, 0.2, 3.0)], ray_chunk=512,
            device_mesh=make_ray_mesh(nd),
        )
        sim.run_iteration()
        maps[nd] = np.asarray(sim.photon_map)
    assert np.array_equal(maps[1], maps[8])
    # bounces add hits beyond the direct 4096
    assert maps[8].sum() / 3.0 > 4096


@pytest.mark.parametrize("layout", ["rays4", "rays2x2texels"])
def test_simulator_sharded_jax_backend(setup, layout):
    """The per-ray BVH walk under shard_map, on a 1-D ray mesh and on the
    2-D rays x texels mesh, vs the same Simulator unsharded: bit-identical
    per-triangle and per-texel counts."""
    from uvtrace.io.routexml import LightPos
    from uvtrace.parallel import make_2d_mesh
    from uvtrace.sim import SimParams, Simulator

    room, _ = setup
    params = SimParams(photon_count=4 * 1024, max_iterations=1, traversal="jax",
                       texel_density=4.0)
    device_mesh = (make_ray_mesh(4) if layout == "rays4"
                   else make_2d_mesh(ray_shards=2, texel_shards=2))
    maps = {}
    for dm in (None, device_mesh):
        sim = Simulator(
            room, params, route=[LightPos(0.0, 0.0, 1.0)], ray_chunk=1024,
            device_mesh=dm,
        )
        sim.run_iteration()
        maps[dm is None] = (np.asarray(sim.photon_map), np.asarray(sim.photon_map_tex))
    assert sim.backend == "jax"
    np.testing.assert_array_equal(maps[True][0], maps[False][0])
    np.testing.assert_array_equal(maps[True][1], maps[False][1])
    assert maps[False][0].sum() == 4 * 1024  # closed room: every photon lands
