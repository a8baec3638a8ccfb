"""BVH traversal in pure JAX (batched masked short-stack walk).

The reference traversal (cl/extend.cl:40-81) is a per-thread ordered
depth-first walk: near child first, 32-deep local stack, early AABB rejection
against the current best hit. Here the same walk runs for a whole ray batch
in lockstep inside one `lax.while_loop`: every lane carries its own
(node, stack, best-hit) state, leaf and internal steps are computed masked —
SIMT emulation on the VPU. No `lax.cond` under `vmap` (that would broadcast
the scene arrays per-ray: cond batching materializes `select_n` over hoisted
closure operands), and the leaf loop is a *static* `max_leaf`-bounded
iteration so shapes stay fixed.

This is the default extend backend on every device (ops/select.py) and is
checked against the brute-force oracle (ops/intersect.py).

Triangles are consumed in *leaf-sorted* order (FlatBVH.sorted_tris) so leaf
reads are near-contiguous gathers; returned hit ids are sorted-space indices
(map back with `bvh.tri_idx`).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from uvtrace.ops.intersect import BIG, intersect_aabb, intersect_tri, safe_inv_dir

STACK_DEPTH = 48  # reference uses 32 (cl/extend.cl:42); deeper for safety


class SceneArrays(NamedTuple):
    """Device-resident flat scene (built once from TriangleMesh + FlatBVH)."""

    node_min: jax.Array  # f32[N,3]
    node_max: jax.Array  # f32[N,3]
    left_first: jax.Array  # i32[N]
    tri_count: jax.Array  # i32[N]
    v0: jax.Array  # f32[T,3] sorted-order vertices
    v1: jax.Array
    v2: jax.Array
    tri_idx: jax.Array  # i32[T] sorted -> original


def scene_arrays(bvh, dtype=jnp.float32) -> SceneArrays:
    st = jnp.asarray(bvh.sorted_tris, dtype)
    return SceneArrays(
        node_min=jnp.asarray(bvh.node_min, dtype),
        node_max=jnp.asarray(bvh.node_max, dtype),
        left_first=jnp.asarray(bvh.left_first, jnp.int32),
        tri_count=jnp.asarray(bvh.tri_count, jnp.int32),
        v0=st[:, 0],
        v1=st[:, 1],
        v2=st[:, 2],
        tri_idx=jnp.asarray(bvh.tri_idx, jnp.int32),
    )


class _State(NamedTuple):
    node: jax.Array  # i32[R] current node per lane
    sp: jax.Array  # i32[R] stack pointer
    stack: jax.Array  # i32[R,STACK_DEPTH]
    t: jax.Array  # f32[R] best hit distance
    hit: jax.Array  # i32[R] best sorted tri id (-1 = miss)
    done: jax.Array  # bool[R]


def traverse(scene: SceneArrays, orig, direction, *, max_leaf: int = 8, **_):
    """Batched closest-hit traversal.

    Args:
      orig, direction: float32[R,3].
      max_leaf: static upper bound on leaf triangle count (from
        FlatBVH.max_leaf_size; larger leaves are silently truncated, so the
        builder must respect the same bound).

    Returns:
      (t, hit_id): float32[R], int32[R] *original* triangle ids;
      miss => (1e30, -1).
    """
    r = orig.shape[0]
    inv_dir = safe_inv_dir(direction)
    lanes = jnp.arange(r)

    def step(s: _State) -> _State:
        active = ~s.done
        lf = scene.left_first[s.node]  # i32[R]
        tc = scene.tri_count[s.node]
        is_leaf = tc > 0

        # ---- leaf path: test up to max_leaf triangles (masked static loop)
        def tri_body(i, carry):
            t_best, hit = carry
            j = jnp.clip(lf + i, 0, scene.v0.shape[0] - 1)
            t = intersect_tri(orig, direction, scene.v0[j], scene.v1[j], scene.v2[j])
            upd = active & is_leaf & (i < tc) & (t < t_best)
            return jnp.where(upd, t, t_best), jnp.where(upd, j, hit)

        t_new, hit_new = jax.lax.fori_loop(0, max_leaf, tri_body, (s.t, s.hit))

        # ---- internal path: ordered child tests
        c1 = lf
        c2 = lf + 1
        d1 = intersect_aabb(orig, inv_dir, scene.node_min[c1], scene.node_max[c1], t_new)
        d2 = intersect_aabb(orig, inv_dir, scene.node_min[c2], scene.node_max[c2], t_new)
        swap = d1 > d2
        near = jnp.where(swap, c2, c1)
        far = jnp.where(swap, c1, c2)
        dnear = jnp.minimum(d1, d2)
        dfar = jnp.maximum(d1, d2)
        miss_both = dnear >= BIG
        push_far = (~is_leaf) & (~miss_both) & (dfar < BIG)

        # ---- merge: next node / stack op per lane
        # pop when: leaf processed, or internal node missed both children
        pops = is_leaf | miss_both
        empty = s.sp == 0
        finish = active & pops & empty
        top = s.stack[lanes, jnp.maximum(s.sp - 1, 0)]
        new_node = jnp.where(pops, top, near)
        new_node = jnp.where(active, new_node, s.node)
        new_sp = jnp.where(
            active,
            jnp.where(pops, jnp.maximum(s.sp - 1, 0), s.sp + push_far.astype(jnp.int32)),
            s.sp,
        )
        do_push = active & push_far
        stack_new = s.stack.at[lanes, jnp.clip(s.sp, 0, STACK_DEPTH - 1)].set(
            jnp.where(do_push, far, s.stack[lanes, jnp.clip(s.sp, 0, STACK_DEPTH - 1)])
        )
        return _State(
            node=new_node,
            sp=new_sp,
            stack=stack_new,
            t=jnp.where(active, t_new, s.t),
            hit=jnp.where(active, hit_new, s.hit),
            done=s.done | finish,
        )

    init = _State(
        node=jnp.zeros((r,), jnp.int32),
        sp=jnp.zeros((r,), jnp.int32),
        stack=jnp.zeros((r, STACK_DEPTH), jnp.int32),
        t=jnp.full((r,), BIG, jnp.float32),
        hit=jnp.full((r,), -1, jnp.int32),
        done=jnp.zeros((r,), bool),
    )
    out = jax.lax.while_loop(lambda s: jnp.any(~s.done), step, init)
    hit_orig = jnp.where(out.hit >= 0, scene.tri_idx[jnp.maximum(out.hit, 0)], -1)
    return out.t, hit_orig
