"""Ray-triangle and ray-AABB intersection primitives + brute-force oracle.

Reference: cl/extend.cl — Möller–Trumbore `IntersectTri` (:6-27, parallel
reject |det| < 1e-5, near clip t > 1e-4) and slab-test `IntersectAABB`
(:29-38). Vectorized over arbitrary leading batch dims; used by both traversal
backends and the brute-force correctness oracle. Everything here is
elementwise float32 arithmetic with no matrix product, so no matmul
precision setting (TF32 on a GPU) can touch it.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

# numpy scalars, NOT jnp: module-level jnp constants would initialize the XLA
# backend at import time, which breaks jax.distributed.initialize (it must be
# the first backend touch in a multi-process run — parallel/multihost.py)
BIG = np.float32(1e30)
DET_EPS = np.float32(1e-5)
T_MIN = np.float32(1e-4)


def intersect_tri(orig, direction, v0, v1, v2):
    """Möller–Trumbore (cl/extend.cl:6-27). Broadcasting over leading dims.

    Returns t, float32 — hit distance, or 1e30 on miss. Boundary semantics
    follow the reference: u in [0,1], v >= 0, u+v <= 1, t > 1e-4.
    """
    edge1 = v1 - v0
    edge2 = v2 - v0
    h = jnp.cross(direction, edge2)
    a = jnp.sum(edge1 * h, axis=-1)
    f = jnp.where(a == 0, 0.0, 1.0 / jnp.where(a == 0, 1.0, a))
    s = orig - v0
    u = f * jnp.sum(s * h, axis=-1)
    q = jnp.cross(s, edge1)
    v = f * jnp.sum(direction * q, axis=-1)
    t = f * jnp.sum(edge2 * q, axis=-1)
    valid = (
        (jnp.abs(a) >= DET_EPS)
        & (u >= 0.0)
        & (u <= 1.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > T_MIN)
    )
    return jnp.where(valid, t, BIG)


def safe_inv_dir(direction):
    """1/direction with zero components replaced by 1/1e-30 = 1e30.

    Avoids the 0 * inf = NaN case of the slab test when a ray origin
    coordinate lies exactly on a node plane (the reference divides by zero,
    cl/extend.cl:31-36, and inherits OpenCL's order-dependent NaN min/max;
    this formulation is robust and NaN-free).
    """
    tiny = jnp.float32(1e-30)
    d = jnp.where(direction == 0.0, tiny, direction)
    return 1.0 / d


def intersect_aabb(orig, inv_dir, box_min, box_max, t_best):
    """Slab test (cl/extend.cl:29-38). `inv_dir` = 1/direction (+-inf on zero
    components — IEEE semantics match the reference's division).

    Returns tmin, or 1e30 when the box is missed / beyond t_best.
    """
    t1 = (box_min - orig) * inv_dir
    t2 = (box_max - orig) * inv_dir
    tmin = jnp.max(jnp.minimum(t1, t2), axis=-1)
    tmax = jnp.min(jnp.maximum(t1, t2), axis=-1)
    hit = (tmax >= tmin) & (tmin < t_best) & (tmax > 0)
    return jnp.where(hit, tmin, BIG)


def brute_force_closest_hit(rays_orig, rays_dir, tris, chunk: int = 2048):
    """Closest-hit over all triangles, no BVH — the correctness oracle.

    Matches the reference's hit semantics including its tie-breaking: the
    reference scans triangles in BVH-leaf order with a strict `t < dist`
    update (cl/extend.cl:25-26); here we scan in triangle order, so exact-tie
    hits may resolve to a different triangle (tests compare distances, and ids
    only off tie boundaries).

    Returns (t, tri_id): float32[N], int32[N]; misses have t=1e30, tri_id=-1.
    """
    n = rays_orig.shape[0]
    t_count = tris.shape[0]
    v0, v1, v2 = tris[:, 0], tris[:, 1], tris[:, 2]

    def body(i, carry):
        best_t, best_id = carry
        o = jax.lax.dynamic_slice_in_dim(rays_orig, i * chunk, chunk)
        d = jax.lax.dynamic_slice_in_dim(rays_dir, i * chunk, chunk)
        t = intersect_tri(
            o[:, None, :], d[:, None, :], v0[None, :, :], v1[None, :, :], v2[None, :, :]
        )  # [chunk, T]
        tmin = jnp.min(t, axis=1)
        tid = jnp.argmin(t, axis=1).astype(jnp.int32)
        tid = jnp.where(tmin >= BIG, -1, tid)
        best_t = jax.lax.dynamic_update_slice_in_dim(best_t, tmin, i * chunk, 0)
        best_id = jax.lax.dynamic_update_slice_in_dim(best_id, tid, i * chunk, 0)
        return best_t, best_id

    if n % chunk != 0:
        pad = chunk - n % chunk
        rays_orig = jnp.concatenate([rays_orig, jnp.zeros((pad, 3), rays_orig.dtype)])
        rays_dir = jnp.concatenate([rays_dir, jnp.ones((pad, 3), rays_dir.dtype)])
    padded_n = rays_orig.shape[0]
    best = (jnp.full((padded_n,), BIG), jnp.full((padded_n,), -1, jnp.int32))
    best_t, best_id = jax.lax.fori_loop(0, padded_n // chunk, body, best)
    return best_t[:n], best_id[:n]
