"""The two extend backends against the brute-force oracle, and the one
place that chooses between them (ops/select.py)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from uvtrace.ops import generate as gen_ops
from uvtrace.ops.intersect import brute_force_closest_hit
from uvtrace.ops.select import TRAVERSALS, build_extend, resolve_traversal
from uvtrace.sim import SimParams, Simulator
from tests.test_traverse import assert_hits_match


def _rays(room, sampler, n):
    lamp = (0.1, room.floor_height + 0.8, -0.2)
    key = jax.random.PRNGKey(17)
    if sampler == "stratified":
        return gen_ops.generate_stratified(key, n, lamp, 1.0, packet=min(1024, n))
    if sampler == "native":
        return gen_ops.generate_native(key, n, lamp, 1.0)
    return gen_ops.generate_reference(n, lamp, 1.0, global_seed=5)


def _check_against_oracle(room, res, orig, direction):
    t_ref, id_ref = brute_force_closest_hit(orig, direction, jnp.asarray(room.tris))
    assert_hits_match(res[0], res[1], room.tris, orig, direction, t_ref, id_ref)
    if len(res) > 2:
        assert int(res[2]) == 0  # budget-free: nothing dropped


@pytest.mark.parametrize("sampler", ["stratified", "native", "reference"])
@pytest.mark.parametrize("backend", ["clustered", "jax"])
def test_backend_matches_oracle(small_room, backend, sampler):
    r = _rays(small_room, sampler, 2048)
    ext = build_extend(small_room.tris, backend)
    _check_against_oracle(small_room, ext.fn(ext.scene, r.orig, r.dir), r.orig, r.dir)


@pytest.mark.parametrize(
    "backend,n,kw",
    [
        ("clustered", 1000, dict(packet=256)),
        ("clustered", 2500, dict(packet=1024)),
        ("clustered", 5000, dict(packet=512, group=4)),  # scanned groups + tail
        ("clustered", 77, dict(packet=1024)),  # one short packet
        ("jax", 1000, {}),
        ("jax", 77, {}),
    ],
)
def test_batch_sizes_off_the_packet_grid(small_room, backend, n, kw):
    """Batches that are not whole packets (or whole scan groups) are padded
    with dummy rays internally; the caller sees exactly n results."""
    r = _rays(small_room, "native", n)
    ext = build_extend(small_room.tris, backend)
    res = ext.fn(ext.scene, r.orig, r.dir, **kw)
    assert res[0].shape == (n,) and res[1].shape == (n,)
    _check_against_oracle(small_room, res, r.orig, r.dir)


@pytest.mark.parametrize("backend", ["clustered", "jax"])
def test_bounce_rays_match_oracle(small_room, backend):
    """Bounce segments: scattered origins on surfaces, cosine-hemisphere
    directions, dead lanes parked outside the scene."""
    from uvtrace.ops.bounce import bounce_rays

    r = _rays(small_room, "stratified", 2048)
    ext = build_extend(small_room.tris, backend)
    t, hit = ext.fn(ext.scene, r.orig, r.dir)[:2]
    orig, direction, alive = bounce_rays(
        jax.random.PRNGKey(4), r.orig, r.dir, t, hit,
        jnp.asarray(small_room.normals),
        jnp.full((small_room.triangle_count,), 0.7, jnp.float32),
        jnp.ones((2048,), bool),
    )
    assert 0 < int(alive.sum()) < 2048
    _check_against_oracle(small_room, ext.fn(ext.scene, orig, direction), orig, direction)


@pytest.mark.parametrize("name", ["pallas", "mxu", "mxu-fused"])
def test_simparams_rejects_removed_traversals(name):
    with pytest.raises(ValueError, match="valid choices: auto, clustered, jax"):
        SimParams(traversal=name)


@pytest.mark.parametrize("name", ["pallas", "mxu", "mxu-fused"])
def test_cli_rejects_removed_traversals(name, capsys):
    from uvtrace.cli import main

    with pytest.raises(SystemExit) as e:
        main(["compute", "scene.glb", "--traversal", name])
    assert e.value.code == 2
    assert "invalid choice" in capsys.readouterr().err


@pytest.mark.parametrize("platform", ["cpu", "gpu", "cuda"])
def test_auto_resolves_identically_on_every_platform(monkeypatch, small_room, platform):
    """The choice reads what the request says, never the platform."""
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    assert resolve_traversal("auto") == "jax"
    for p in (SimParams(), SimParams(sampler="native"), SimParams(max_bounces=2)):
        assert Simulator(small_room, dataclasses.replace(p, photon_count=4096)).backend == "jax"


@pytest.mark.parametrize("name", [t for t in TRAVERSALS if t != "auto"])
def test_explicit_traversal_is_kept(small_room, name):
    assert resolve_traversal(name) == name
    sim = Simulator(small_room, SimParams(traversal=name, photon_count=4096))
    assert sim.backend == name
