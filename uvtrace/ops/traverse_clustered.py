"""Two-phase clustered traversal (pure JAX).

Replaces per-ray BVH descent with packet-granular dense work (SURVEY.md §7):

  phase 1: every ray packet (default 1024 rays) is tested against *all*
           cluster AABBs — a dense [packet, L] slab test with no gathers;
           the nearest `max_clusters` overlapped clusters per packet are
           selected with top_k on packet entry distance.
  phase 2: the packet is intersected against every (padded) triangle of its
           selected clusters — dense Möller–Trumbore over
           [packet, max_clusters * C] with contiguous cluster blocks —
           and the closest hit reduced with min/argmin.

Correct whenever the true closest-hit cluster is among the `max_clusters`
nearest overlapped clusters of its packet (always true when a packet overlaps
at most `max_clusters` clusters; coherent packets from stratified generation
keep that number small — see ops/generate.generate_stratified). The traversal
also returns the per-packet overflow count so callers/tests can verify the
budget (0 overflows => bit-identical to exhaustive intersection).

Unlike the reference's ordered DFS with early termination (cl/extend.cl:
40-81), closest-hit here is an order-independent min-reduction — wasted
intersections are traded for completely regular compute and memory.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from uvtrace.ops.cluster import ClusteredScene
from uvtrace.ops.intersect import BIG, intersect_aabb, intersect_tri, safe_inv_dir


class ClusterArrays(NamedTuple):
    """Device-resident clustered scene."""

    v0: jax.Array  # f32[L, C, 3]
    v1: jax.Array
    v2: jax.Array
    box_min: jax.Array  # f32[L, 3]
    box_max: jax.Array  # f32[L, 3]
    tri_idx: jax.Array  # i32[L, C] original tri ids, -1 = padding


def cluster_arrays(cs: ClusteredScene, dtype=jnp.float32) -> ClusterArrays:
    t = jnp.asarray(cs.tris, dtype)
    return ClusterArrays(
        v0=t[:, :, 0],
        v1=t[:, :, 1],
        v2=t[:, :, 2],
        box_min=jnp.asarray(cs.box_min, dtype),
        box_max=jnp.asarray(cs.box_max, dtype),
        tri_idx=jnp.asarray(cs.tri_idx, jnp.int32),
    )


def _packet_traverse(ca: ClusterArrays, o, d, max_clusters: int):
    """Closest hit for one packet: o, d float32[P,3]."""
    l_count, c_size = ca.tri_idx.shape
    k = min(max_clusters, l_count)
    inv = safe_inv_dir(d)

    # ---- phase 1: dense packet x cluster culling
    tmin = intersect_aabb(
        o[:, None, :], inv[:, None, :], ca.box_min[None], ca.box_max[None], BIG
    )  # [P, L]
    entry = jnp.min(tmin, axis=0)  # [L]; 1e30 when no ray in the packet hits
    neg_key, idx = jax.lax.top_k(-entry, k)  # nearest k overlapped clusters
    valid = -neg_key < BIG  # [k]
    overflow = jnp.maximum(jnp.sum(entry < BIG) - k, 0)

    # ---- phase 2: dense intersection against selected cluster blocks
    cand_v0 = ca.v0[idx].reshape(k * c_size, 3)
    cand_v1 = ca.v1[idx].reshape(k * c_size, 3)
    cand_v2 = ca.v2[idx].reshape(k * c_size, 3)
    t = intersect_tri(
        o[:, None, :], d[:, None, :], cand_v0[None], cand_v1[None], cand_v2[None]
    )  # [P, k*C]
    t = jnp.where(jnp.repeat(valid, c_size)[None, :], t, BIG)
    best = jnp.min(t, axis=1)
    slot = jnp.argmin(t, axis=1)
    cluster_of = idx[slot // c_size]
    hit_id = ca.tri_idx[cluster_of, slot % c_size]
    hit_id = jnp.where(best >= BIG, -1, hit_id)
    return best, hit_id, overflow


def traverse_clustered(
    ca: ClusterArrays,
    orig,
    direction,
    *,
    packet: int = 1024,
    max_clusters: int = 32,
    group: int = 16,
    return_overflow: bool = False,
    **_,
):
    """Batched closest-hit traversal over a clustered scene.

    Args:
      orig, direction: float32[R,3]; R must be a multiple of `packet`, and
        rays should be packet-coherent (stratified generation or sorted by
        direction) for the cluster budget to hold.
      max_clusters: phase-2 cluster budget per packet.
      group: packets processed per scan step (memory/parallelism trade-off).

    Returns:
      (t, hit_id[, overflow]): float32[R], int32[R] original triangle ids
      (-1 = miss), and optionally the total number of clusters dropped by the
      budget (0 => exhaustive within overlapped clusters).
    """
    r = orig.shape[0]
    packet = min(packet, r)
    # pad to a whole number of packets (and of scan groups) with dummy rays
    r_round = packet * (-(-r // packet))
    if r_round // packet > group:
        r_round = packet * group * (-(-r_round // (packet * group)))
    pad = r_round - r
    if pad:
        orig = jnp.concatenate([orig, jnp.zeros((pad, 3), orig.dtype)])
        direction = jnp.concatenate(
            [direction, jnp.broadcast_to(jnp.array([1.0, 0.0, 0.0], direction.dtype), (pad, 3))]
        )
    g_total = r_round // packet
    o = orig.reshape(g_total, packet, 3)
    d = direction.reshape(g_total, packet, 3)

    def run_group(os, ds):
        return jax.vmap(lambda oo, dd: _packet_traverse(ca, oo, dd, max_clusters))(os, ds)

    if g_total <= group:
        t, hit, ov = run_group(o, d)
    else:
        assert g_total % group == 0, (g_total, group)
        o = o.reshape(g_total // group, group, packet, 3)
        d = d.reshape(g_total // group, group, packet, 3)
        (t, hit, ov) = jax.lax.map(lambda od: run_group(od[0], od[1]), (o, d))
        t = t.reshape(g_total, packet)
        hit = hit.reshape(g_total, packet)
    t = t.reshape(r_round)[:r]
    hit = hit.reshape(r_round)[:r]
    if return_overflow:
        return t, hit, jnp.sum(ov)
    return t, hit
