"""The one place that picks and builds the extend (closest-hit) backend.

Two plain-JAX backends exist, and both compile for any XLA device:

- "jax" (ops/traverse.py): the per-ray BVH walk of the reference
  (cl/extend.cl:40-81), run as a masked lockstep loop. Budget-free.
- "clustered" (ops/traverse_clustered.py): packet-granular culling of SAH
  clusters, then a dense ray x triangle test over a per-packet budget of
  clusters; a launch must audit the overflow it reports.

"auto" is the BVH walk on every device and for every kind of ray: on an
H100 it measured faster than "clustered" for coherent primaries, iid
primaries, bounce segments and shadow rays alike (PERF.md). The choice
reads nothing about the platform, so one request compiles to the same
backend everywhere.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional

TRAVERSALS = ("auto", "clustered", "jax")


def check_traversal(traversal: str) -> None:
    """Reject a traversal name that no backend implements."""
    if traversal not in TRAVERSALS:
        raise ValueError(
            f"unknown traversal {traversal!r}; valid choices: "
            + ", ".join(TRAVERSALS)
        )


def resolve_traversal(traversal: str) -> str:
    """The backend that runs a request for `traversal`."""
    check_traversal(traversal)
    return "jax" if traversal == "auto" else traversal


class Extend(NamedTuple):
    """A built backend. `fn(scene, orig, direction)` returns
    (t f32[R], hit i32[R]) with original triangle ids (miss: 1e30, -1);
    the clustered backend appends the number of clusters its budget
    dropped."""

    backend: str
    scene: object
    fn: Callable
    n_clusters: int = 0  # clustered only: a budget this large drops nothing


def build_extend(
    tris,
    backend: str,
    *,
    max_clusters: Optional[int] = None,
    bvh=None,
    max_leaf_size: Optional[int] = 8,
    cluster_size: int = 128,
) -> Extend:
    """Build `backend` ("jax" or "clustered", already resolved) over
    float32[T,3,3] triangles. The native C++ builder is used when a
    compiler is present. max_clusters=None makes the clustered backend
    budget-free; `bvh` reuses a prebuilt FlatBVH for "jax"."""
    from uvtrace.bvh import native

    use_native = native.available()
    if backend == "jax":
        from uvtrace.ops.traverse import scene_arrays, traverse

        if bvh is None:
            if use_native:
                bvh = native.build_bvh_native(tris, max_leaf_size=max_leaf_size)
            else:
                from uvtrace.bvh.builder import build_bvh

                bvh = build_bvh(tris, max_leaf_size=max_leaf_size)
        return Extend(
            "jax", scene_arrays(bvh),
            functools.partial(traverse, max_leaf=bvh.max_leaf_size),
        )
    if backend != "clustered":
        raise ValueError(f"build_extend: unresolved backend {backend!r}")
    from uvtrace.ops.cluster import build_clusters
    from uvtrace.ops.traverse_clustered import cluster_arrays, traverse_clustered

    if use_native:
        cs = native.build_clusters_native(tris, cluster_size=cluster_size)
    else:
        cs = build_clusters(tris, cluster_size=cluster_size)
    budget = cs.n_clusters if max_clusters is None else min(max_clusters, cs.n_clusters)
    return Extend(
        "clustered", cluster_arrays(cs),
        functools.partial(traverse_clustered, max_clusters=budget, return_overflow=True),
        cs.n_clusters,
    )
