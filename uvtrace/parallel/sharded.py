"""Multi-chip execution — ONE sharded pipeline, shared with the Simulator.

The reference is single-GPU (SURVEY.md §2 'Distributed communication backend:
none'); this module is the scale-out design:

- the photon batch is embarrassingly parallel -> shard the `rays` axis;
- the scene (BVH or clusters, a few MB) is replicated on every device;
- each device runs the SAME chunked launch pipeline (`launch_counts`,
  uvtrace/sim/launch.py) over its own GLOBAL chunk range, so the photon
  population — and therefore every count — is bit-identical to a
  single-device run of the whole launch (global-chunk-index RNG folding);
- per-triangle count partials are summed with one `psum` — the collective
  that replaces the reference's atomic_inc global-memory contention
  (cl/extend.cl:95-98); every device reaches every other at the same rate
  (NVLink, all to all), so the mesh follows the algorithm alone;
- large texel atlases (BASELINE config 5: 4K dose maps, ~16M slots) add a
  second mesh axis `texels`: every device still traces distinct photons, and
  its full-size texel partial is `psum_scatter`ed over the texel axis so each
  device *keeps* only its own slot range. Steady-state per-device texel state
  is n_texels / texel_shards; the full-size array exists only as the launch's
  transient partial (67 MB at 4K — small next to device memory), and cross-device
  traffic per launch is one scatter plus one shard-sized psum.

There is deliberately no second implementation here: earlier rounds carried a
parallel `sharded_launch_counts` pipeline without chunking, bounce support,
or the overflow audit — it has been replaced by this thin shard_map wrapper
around the product `launch_counts` (round-2 verdict #4).
"""

from __future__ import annotations

import math
from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from uvtrace.sim.launch import launch_counts

RAY_AXIS = "rays"
TEXEL_AXIS = "texels"


def make_ray_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    """A 1-D device mesh over the `rays` axis."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return jax.make_mesh((len(devices),), (RAY_AXIS,), devices=devices)


def mesh_shape(mesh: Mesh) -> tuple[int, int]:
    """(ray_shards, texel_shards) of a 1-D or 2-D product mesh."""
    names = tuple(mesh.axis_names)
    if names not in ((RAY_AXIS,), (RAY_AXIS, TEXEL_AXIS)):
        raise ValueError(
            f"expected a ('{RAY_AXIS}',) or ('{RAY_AXIS}', '{TEXEL_AXIS}') "
            f"device mesh, got axis names {names} — build one with "
            "uvtrace.parallel.sharded.make_ray_mesh or jax.make_mesh"
        )
    return mesh.shape[RAY_AXIS], mesh.shape.get(TEXEL_AXIS, 1)


def sharded_launch_fn(
    mesh: Mesh,
    *,
    t_count: int,
    n_total: int,
    chunk: int,
    sampler: str,
    method: str,
    extend_fn,
    max_bounces: int = 0,
    n_texels: int = 0,
):
    """Build the jitted multi-device launch for `n_total` photons.

    Returns fn(scene, rng_in, lamp_xyz, light_length, aux) ->
    (counts[t_count], tex_counts, overflow) where `aux` is the dict of traced
    per-launch arrays launch_counts accepts (normals, reflectance, atlas,
    tri_v0/e1/e2).

    Device d (linear index over the mesh) scans global chunks
    [d*k, (d+1)*k): the RNG folds the GLOBAL chunk index inside
    launch_counts, so results are bit-identical to the single-device run AND
    invariant to the mesh factorization (8x1 == 4x2 == 2x4).

    Outputs: counts/overflow replicated (psum over every axis); tex_counts
    replicated on a 1-D mesh, sharded P('texels') on a 2-D mesh
    (psum_scatter over texels + psum over rays).
    """
    ray_shards, tex_shards = mesh_shape(mesh)
    n_dev = ray_shards * tex_shards
    if n_total % (n_dev * chunk) != 0:
        raise ValueError(
            f"n_total={n_total} must be a multiple of n_devices*chunk = "
            f"{n_dev}*{chunk} so every device scans whole chunks "
            "(the Simulator rounds launches up to this automatically)"
        )
    chunks_per_dev = n_total // n_dev // chunk
    if tex_shards > 1 and (not n_texels or n_texels % tex_shards != 0):
        raise ValueError(
            f"a {tex_shards}-way 'texels' axis needs n_texels > 0 and "
            f"divisible by it (got n_texels={n_texels}); enable "
            "params.texel_density — the Simulator pads the slot count"
        )
    static = dict(
        t_count=t_count,
        n=n_total // n_dev,
        chunk=chunk,
        sampler=sampler,
        method=method,
        extend_fn=extend_fn,
        max_bounces=max_bounces,
        n_texels=n_texels,
    )

    def shard_fn(scene, rng, lamp, ll, aux):
        dev = jax.lax.axis_index(RAY_AXIS)
        if tex_shards > 1:
            dev = dev * tex_shards + jax.lax.axis_index(TEXEL_AXIS)
        counts, tex, ov = launch_counts(
            scene, rng, lamp, ll, chunk_offset=dev * chunks_per_dev,
            **static, **aux,
        )
        axes = tuple(mesh.axis_names)
        counts = jax.lax.psum(counts, axes)
        ov = jax.lax.psum(ov, axes)
        if tex_shards > 1:
            # scatter-reduce the full-size texel partial: each device keeps
            # only its own slot range (traffic: one scatter over `texels`,
            # then a shard-sized psum over `rays`)
            tex = jax.lax.psum_scatter(
                tex, TEXEL_AXIS, scatter_dimension=0, tiled=True
            )
            tex = jax.lax.psum(tex, RAY_AXIS)
        else:
            tex = jax.lax.psum(tex, axes)
        return counts, tex, ov

    out_tex_spec = P(TEXEL_AXIS) if tex_shards > 1 else P()
    return jax.jit(
        jax.shard_map(
            shard_fn,
            mesh=mesh,
            in_specs=(P(), P(), P(), P(), P()),
            out_specs=(P(), out_tex_spec, P()),
            check_vma=False,
        )
    )
