"""The chunked wavefront launch — ONE pipeline for every execution mode.

`launch_counts` is the single implementation of the inner hot loop
(generate -> traverse -> histogram [-> bounce] [-> texel], chunked with
`lax.scan`), used identically by:
  - the single-device Simulator path,
  - the shard_mapped multi-device path (uvtrace/parallel/sharded.py), where
    each device runs its own chunk range of the SAME global launch, and
  - the multi-device dry run (__graft_entry__.py).
Reference: ComputeSingleLightDosageMap (raytracer.cpp:75-88) + the wavefront
kernels cl/generate.cl / cl/extend.cl / cl/accumulate.cl.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from uvtrace.ops import accumulate as acc_ops
from uvtrace.ops import generate as gen_ops


@functools.partial(
    jax.jit,
    static_argnames=("t_count", "n", "chunk", "sampler", "method", "extend_fn", "max_bounces", "n_texels"),
)
def launch_counts(
    scene,
    rng_in,
    lamp_xyz,
    light_length,
    *,
    t_count,
    n,
    chunk,
    sampler,
    method,
    extend_fn,
    max_bounces=0,
    normals=None,
    reflectance=None,
    atlas=None,
    n_texels=0,
    tri_v0=None,
    tri_e1=None,
    tri_e2=None,
    chunk_offset=0,
):
    """Original-order int32[t_count] hit counts for one lamp launch of n photons.

    The wavefront inner loop (ComputeSingleLightDosageMap, raytracer.cpp:75-88)
    as one fused jit: generate -> traverse -> histogram, chunked with
    `lax.scan` so device memory holds one ray chunk (not the reference's full
    1 GiB ray buffer, raytracer.cpp:137) and the traversal state stays bounded.

    rng_in: PRNGKey (uint32 SEED for sampler='reference').
    lamp_xyz / light_length are traced so waypoint moves don't recompile.
    extend_fn(scene, orig, dir) -> (t, hit_original_ids[, overflow]); a
    budgeted backend's overflow is summed into the third output.
    chunk_offset (traced): global index of this call's first chunk. All RNG
    folding (photon ids in reference mode, chunk keys, bounce keys) uses the
    GLOBAL chunk index, so a sharded launch where device d runs chunks
    [d*k, (d+1)*k) draws bit-identically the same photon population as a
    single-device launch of all n*ndev photons (tests/test_parallel.py).
    """
    n_chunks = max(1, (n + chunk - 1) // chunk)
    chunk_offset = jnp.asarray(chunk_offset, jnp.int32)

    def texel_counts_of(orig, direction, t_hit, hit_ids):
        from uvtrace.ops import texel as texel_ops

        safe = jnp.maximum(hit_ids, 0)
        u, v = texel_ops.barycentrics(
            orig, direction, t_hit, tri_v0[safe], tri_e1[safe], tri_e2[safe]
        )
        slots = texel_ops.texel_ids(atlas, hit_ids, u, v)
        return acc_ops.hit_counts(slots, n_texels, method)

    def extend(orig, direction):
        res = extend_fn(
            scene, orig, direction, lamp_xyz=lamp_xyz, light_length=light_length
        )
        # budgeted backends (traverse_clustered with return_overflow) report
        # dropped clusters: a nonzero total means possible silent hit loss —
        # the Simulator redoes the launch (dose UNDER-estimation is the
        # dangerous direction in a disinfection simulator)
        ov = res[2] if len(res) > 2 else jnp.int32(0)
        return res[0], res[1], ov

    def one_chunk(carry, i):
        counts, tex_counts, overflow = carry
        gi = chunk_offset + i  # global chunk index (shard-aware RNG stream)
        if sampler == "reference":
            rays = gen_ops.generate_reference(
                chunk, lamp_xyz, light_length, global_seed=rng_in, start=gi * chunk
            )
        elif sampler == "stratified":
            key = jax.random.fold_in(rng_in, gi)
            rays = gen_ops.generate_stratified(
                key, chunk, lamp_xyz, light_length, packet=min(1024, chunk)
            )
        else:
            key = jax.random.fold_in(rng_in, gi)
            rays = gen_ops.generate_native(key, chunk, lamp_xyz, light_length)

        t_hit, hit_ids, ov = extend(rays.orig, rays.dir)
        overflow = overflow + ov
        # mask rays beyond n in the last (padded) chunk — LOCAL index
        valid = i * chunk + jnp.arange(chunk) < n
        hit_ids = jnp.where(valid, hit_ids, -1)
        counts = counts + acc_ops.hit_counts(hit_ids, t_count, method)
        if atlas is not None:
            tex_counts = tex_counts + texel_counts_of(rays.orig, rays.dir, t_hit, hit_ids)

        if max_bounces > 0:
            # diffuse interreflection with Russian roulette (ops/bounce.py);
            # bounced rays lose packet coherence, which a budget-free
            # extend backend does not pay for
            from uvtrace.ops.bounce import bounce_rays

            if sampler == "reference":
                base_key = jax.random.PRNGKey(0)
                base_key = jax.random.fold_in(base_key, rng_in.astype(jnp.int32))
            else:
                base_key = rng_in
            orig, direction, alive = rays.orig, rays.dir, valid
            for b in range(max_bounces):
                kb = jax.random.fold_in(jax.random.fold_in(base_key, 7919 + b), gi)
                orig, direction, alive = bounce_rays(
                    kb, orig, direction, t_hit, hit_ids, normals, reflectance, alive
                )
                t_hit, hit_b, ov = extend(orig, direction)
                overflow = overflow + ov
                hit_ids = jnp.where(alive, hit_b, -1)
                counts = counts + acc_ops.hit_counts(hit_ids, t_count, method)
                if atlas is not None:
                    tex_counts = tex_counts + texel_counts_of(orig, direction, t_hit, hit_ids)
        return (counts, tex_counts, overflow), None

    init = (
        jnp.zeros((t_count,), jnp.int32),
        jnp.zeros((n_texels,), jnp.int32) if atlas is not None else jnp.zeros((1,), jnp.int32),
        jnp.zeros((), jnp.int32),
    )
    (counts, tex_counts, overflow), _ = jax.lax.scan(
        one_chunk, init, jnp.arange(n_chunks, dtype=jnp.int32)
    )
    return counts, tex_counts, overflow
