"""Multi-bounce diffuse interreflection with Russian roulette.

A superset of the reference, which is explicitly direct-lighting-only
(Report §1.1: "reflections ... safe to ignore"; BASELINE config 2 demands
4-bounce diffuse + Russian roulette). Physics:

- UV dose on a surface is the *fluence* through it, so a photon deposits a
  full count at EVERY surface arrival (the primary hit and each bounce hit).
- At each arrival the photon survives with probability rho (the surface's
  UV reflectance — per-triangle, differentiable upstream) and continues in a
  cosine-weighted hemisphere direction around the oriented surface normal;
  Russian roulette keeps continuation unweighted and unbiased.
- Bounced rays are re-launched through the same extend backend. They lose
  packet coherence, so bounce passes should use a traversal without a
  candidate budget (the per-ray BVH walk, or clustered with a large budget).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def orthonormal_basis(n):
    """Branchless ONB (Duff et al. 2017 / Frisvad) for unit normals [*,3]."""
    s = jnp.where(n[..., 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (s + n[..., 2])
    b = n[..., 0] * n[..., 1] * a
    t1 = jnp.stack(
        [1.0 + s * n[..., 0] ** 2 * a, s * b, -s * n[..., 0]], axis=-1
    )
    t2 = jnp.stack([b, s + n[..., 1] ** 2 * a, -n[..., 1]], axis=-1)
    return t1, t2


def cosine_hemisphere(key, normals):
    """Cosine-weighted directions about unit `normals` [N,3]."""
    k1, k2 = jax.random.split(key)
    u1 = jax.random.uniform(k1, normals.shape[:-1])
    u2 = jax.random.uniform(k2, normals.shape[:-1])
    r = jnp.sqrt(u1)
    phi = 2.0 * jnp.pi * u2
    x = r * jnp.cos(phi)
    y = r * jnp.sin(phi)
    z = jnp.sqrt(jnp.maximum(0.0, 1.0 - u1))
    t1, t2 = orthonormal_basis(normals)
    return x[..., None] * t1 + y[..., None] * t2 + z[..., None] * normals


def bounce_rays(key, orig, direction, t_hit, hit_ids, normals, reflectance, alive,
                eps: float = 1e-3):
    """One Russian-roulette bounce step.

    Args:
      orig, direction: current rays f32[R,3].
      t_hit, hit_ids: closest-hit results (1e30 / -1 on miss).
      normals: f32[T,3] unit triangle normals (original order).
      reflectance: f32[T] per-triangle survival probability in [0,1).
      alive: bool[R] photons still in flight BEFORE this interaction.

    Returns:
      (new_orig, new_dir, new_alive, key_consumed_marker) — rays for the next
      extend pass; dead lanes keep harmless dummy rays.
    """
    k_rr, k_dir = jax.random.split(key)
    safe_hit = jnp.maximum(hit_ids, 0)
    n = normals[safe_hit]
    # orient the normal against the incoming direction (double-sided surfaces,
    # consistent with Möller–Trumbore accepting both faces)
    facing = jnp.sum(n * direction, axis=-1, keepdims=True)
    n = jnp.where(facing > 0, -n, n)

    rho = reflectance[safe_hit]
    u = jax.random.uniform(k_rr, hit_ids.shape)
    new_alive = alive & (hit_ids >= 0) & (u < rho)

    p = orig + t_hit[..., None] * direction
    new_dir = cosine_hemisphere(k_dir, n)
    new_orig = p + eps * n
    # dead lanes: park far OUTSIDE the scene pointing away — their (masked)
    # traversal then culls instantly instead of re-tracing through the room
    new_orig = jnp.where(new_alive[..., None], new_orig, jnp.float32(1e6))
    new_dir = jnp.where(new_alive[..., None], new_dir, jnp.array([1.0, 0.0, 0.0]))
    return new_orig, new_dir, new_alive
