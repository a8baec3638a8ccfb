"""Ray generation — the wavefront `generate` stage.

Reference: cl/generate.cl (entry `render`, :8-40). One photon per lane.
Origin is uniform along a vertical rod of length `light_length` above the lamp
base; direction is uniform over the unit sphere, produced in the reference by
sampling dir-y uniform in [-1,1] and a rejection-sampled unit-disc horizontal
direction rescaled to sqrt(1-y^2) (cl/generate.cl:20-33).

Two samplers:

- `generate_reference`: reproduces the reference's per-photon xorshift32
  streams and the rejection loop (vectorized with a masked while_loop: a
  lane's stream only advances when that lane resamples, so every photon's
  random sequence matches the reference algorithm exactly).
- `generate_native`: threefry-based, rejection-free (uniform azimuth angle),
  identical distribution, faster and stateless.

Both return a `RayBatch` structure of arrays (in place of the reference's
32-byte AoS `Ray` records, cl/tools.cl:8-14).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from uvtrace.ops import rng as ref_rng


class RayBatch(NamedTuple):
    """SoA ray queue: origins and unit directions, float32[N,3]."""

    orig: jax.Array
    dir: jax.Array

    @property
    def count(self):
        return self.orig.shape[0]


def generate_reference(n: int, light_pos, light_length, global_seed=0, start: int = 0,
                       max_rejection_rounds: int = 64) -> RayBatch:
    """Reference-semantics ray generation (cl/generate.cl:8-40).

    Args:
      n: number of photons (static).
      light_pos: (x,y,z) 3D lamp base position (y already includes
        floor_height + light_height, raytracer.cpp:77).
      light_length: rod length in meters.
      global_seed: uint32 cross-launch SEED (see rng.advance_global_seed).
      start: first thread id, for sharded generation.
      max_rejection_rounds: safety bound on the vectorized rejection loop
        (P(round fails) = 1 - pi/4 per lane; 64 rounds => < 1e-39 residual).
    """
    lp = jnp.asarray(light_pos, jnp.float32)
    lx, ly, lz = lp[0], lp[1], lp[2]
    seeds = ref_rng.photon_seeds(n, lp, global_seed, start=start)

    seeds, u_height = ref_rng.random_float(seeds)
    orig = jnp.stack(
        [jnp.full((n,), lx), ly + u_height * jnp.float32(light_length), jnp.full((n,), lz)],
        axis=-1,
    )

    seeds, u_y = ref_rng.random_float(seeds)
    dir_y = u_y * 2.0 - 1.0
    # reference computes the horizontal magnitude in f64 (cl/generate.cl:21);
    # f32 here (JAX's default) — |error| < 1ulp, covered by test tolerances.
    xz_len = jnp.sqrt(jnp.maximum(0.0, 1.0 - dir_y * dir_y))

    # Masked vectorized rejection sampling of the unit disc. Lanes that have
    # accepted keep their state; only rejected lanes draw new candidates, so
    # per-lane streams match the reference's sequential loop.
    def draw(seeds):
        seeds, ux = ref_rng.random_float(seeds)
        seeds, uz = ref_rng.random_float(seeds)
        return seeds, ux * 2 - 1, uz * 2 - 1

    seeds, dx, dz = draw(seeds)

    def cond(carry):
        _, dx, dz, i = carry
        return jnp.logical_and(jnp.any(dx * dx + dz * dz > 1.0), i < max_rejection_rounds)

    def body(carry):
        seeds, dx, dz, i = carry
        reject = dx * dx + dz * dz > 1.0
        new_seeds, ndx, ndz = draw(seeds)
        seeds = jnp.where(reject, new_seeds, seeds)
        dx = jnp.where(reject, ndx, dx)
        dz = jnp.where(reject, ndz, dz)
        return seeds, dx, dz, i + 1

    seeds, dx, dz, _ = jax.lax.while_loop(cond, body, (seeds, dx, dz, jnp.int32(0)))

    inv = xz_len / jnp.sqrt(dx * dx + dz * dz)
    direction = jnp.stack([dx * inv, dir_y, dz * inv], axis=-1)
    return RayBatch(orig=orig.astype(jnp.float32), dir=direction.astype(jnp.float32))


def generate_native(key: jax.Array, n: int, light_pos, light_length) -> RayBatch:
    """Threefry-based sampler with the same distribution as the reference:
    uniform origin height on the rod, uniform sphere direction
    (uniform cos-theta x uniform azimuth == rejection-disc direction)."""
    ku, ky, kp = jax.random.split(key, 3)
    lp = jnp.asarray(light_pos, jnp.float32)
    lx, ly, lz = lp[0], lp[1], lp[2]
    u_height = jax.random.uniform(ku, (n,), dtype=jnp.float32)
    orig = jnp.stack(
        [jnp.full((n,), lx), ly + u_height * jnp.float32(light_length), jnp.full((n,), lz)],
        axis=-1,
    )
    dir_y = jax.random.uniform(ky, (n,), dtype=jnp.float32, minval=-1.0, maxval=1.0)
    phi = jax.random.uniform(kp, (n,), dtype=jnp.float32, minval=0.0, maxval=2.0 * np.pi)
    r = jnp.sqrt(jnp.maximum(0.0, 1.0 - dir_y * dir_y))
    direction = jnp.stack([r * jnp.cos(phi), dir_y, r * jnp.sin(phi)], axis=-1)
    return RayBatch(orig=orig, dir=direction)


def _stratum_grid(g: int, height_bands: int = 1) -> tuple[int, int, int]:
    """Factor g packets into (rod-height bands) x (cos-theta bands) x
    (azimuth sectors). Height bands shrink the packet frustum's *origin*
    spread — the 1 m rod otherwise fattens every packet's footprint and
    inflates the traversal's cluster visits (PERF.md)."""
    gh = height_bands
    # height banding spends strata; keep >=64 direction cells so small
    # launches don't get fat direction cones
    while gh > 1 and (g % gh or g // gh < 64):
        gh //= 2
    rest = g // gh
    gy = max(1, int(np.sqrt(rest)))
    while rest % gy:
        gy -= 1
    return gh, gy, rest // gy


def generate_stratified(key: jax.Array, n: int, light_pos, light_length,
                        packet: int = 1024, height_bands: int = 4) -> RayBatch:
    """Packet-stratified sphere sampler — packet-coherent and lower-variance.

    The unit sphere (in Lambert cylindrical coordinates: cos-theta = dir_y,
    azimuth phi — an equal-area parameterization) is divided into n/packet
    equal-solid-angle cells; every ray packet samples uniformly *within one
    cell*, so all rays of a packet form a tight direction cone. Marginally
    each photon is still uniform over the sphere and the dose estimator stays
    unbiased — variance strictly decreases (stratification), and packet
    coherence is what keeps the clustered traversal's per-packet cluster
    budget small (ops/traverse_clustered.py).

    The reference has no analogue — its photons are i.i.d. uniform
    (cl/generate.cl:20-33); this is a deliberate redesign.

    n must be a multiple of `packet`.
    """
    assert n % packet == 0, (n, packet)
    g = n // packet
    gh, gy, gphi = _stratum_grid(g, height_bands=height_bands)
    ku, ky, kp = jax.random.split(key, 3)
    lp = jnp.asarray(light_pos, jnp.float32)
    lx, ly, lz = lp[0], lp[1], lp[2]

    cell = jnp.arange(n, dtype=jnp.int32) // packet
    ih = (cell // (gy * gphi)).astype(jnp.float32)
    iy = ((cell // gphi) % gy).astype(jnp.float32)
    ip = (cell % gphi).astype(jnp.float32)

    uh = jax.random.uniform(ku, (n,), dtype=jnp.float32)
    u_height = (ih + uh) / gh
    orig = jnp.stack(
        [jnp.full((n,), lx), ly + u_height * jnp.float32(light_length), jnp.full((n,), lz)],
        axis=-1,
    )
    uy = jax.random.uniform(ky, (n,), dtype=jnp.float32)
    up = jax.random.uniform(kp, (n,), dtype=jnp.float32)
    dir_y = -1.0 + 2.0 * (iy + uy) / gy
    phi = (2.0 * np.pi) * (ip + up) / gphi
    r = jnp.sqrt(jnp.maximum(0.0, 1.0 - dir_y * dir_y))
    direction = jnp.stack([r * jnp.cos(phi), dir_y, r * jnp.sin(phi)], axis=-1)
    return RayBatch(orig=orig, dir=direction)
