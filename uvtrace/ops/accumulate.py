"""Atomic-free per-triangle hit-count accumulation.

Replaces the reference's global-memory `atomic_inc(&tempPhotonMap[triID])`
(cl/extend.cl:95-98) with deterministic histogram formulations:

- `"sort"`: sort hit ids then count each bin with two vectorized
  binary searches (searchsorted diff). O(R log R) in XLA's sort, exact i32
  counts, no scatter at all. Default.
- `"segment"`: `jax.ops.segment_sum` of ones (XLA scatter-add).
- `"onehot"`: tile-wise one-hot reduction (exact in f32 for tile sizes
  <= 2^24).

All methods are deterministic (a test asset vs. the reference's atomics,
SURVEY.md §5) and differentiable where it matters (the backward pass of dose
accumulation is a gather, handled in uvtrace/diff).

The reference keeps a separate f64 cumulative map (cl/accumulate.cl:4-14:
photonMap += temp * timeStep; maxPhotonMap = max(...); temp = 0). JAX runs
without f64 by default; `accumulate_dose` keeps exact i32/i64 counts and does the duration
weighting in f32 (counts <= 2^25 are exact in f64 on the CPU oracle; the f32
path is covered by test tolerances).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def counts_sort(hit_ids: jax.Array, num_bins: int) -> jax.Array:
    """Histogram via sort + searchsorted. Misses (< 0) fall out naturally."""
    s = jnp.sort(hit_ids)
    bins = jnp.arange(num_bins, dtype=hit_ids.dtype)
    left = jnp.searchsorted(s, bins, side="left")
    right = jnp.searchsorted(s, bins, side="right")
    return (right - left).astype(jnp.int32)


def counts_segment(hit_ids: jax.Array, num_bins: int) -> jax.Array:
    """Histogram via segment_sum (XLA scatter-add). Misses mapped to an
    overflow bin that is dropped."""
    ids = jnp.where(hit_ids < 0, num_bins, hit_ids)
    ones = jnp.ones_like(ids, dtype=jnp.int32)
    return jax.ops.segment_sum(ones, ids, num_segments=num_bins + 1)[:num_bins]


def counts_onehot(hit_ids: jax.Array, num_bins: int, tile: int = 2048) -> jax.Array:
    """Histogram via one-hot sums over ray tiles, f32 accumulate."""
    n = hit_ids.shape[0]
    pad = (-n) % tile
    ids = jnp.concatenate([hit_ids, jnp.full((pad,), -1, hit_ids.dtype)]) if pad else hit_ids
    ids = ids.reshape(-1, tile)

    bins = jnp.arange(num_bins, dtype=jnp.int32)

    def body(carry, row):
        onehot = (row[:, None] == bins[None, :]).astype(jnp.float32)
        return carry + jnp.sum(onehot, axis=0), None

    total, _ = jax.lax.scan(body, jnp.zeros((num_bins,), jnp.float32), ids)
    return total.astype(jnp.int32)


_METHODS = {"sort": counts_sort, "segment": counts_segment, "onehot": counts_onehot}


def hit_counts(hit_ids: jax.Array, num_bins: int, method: str = "sort") -> jax.Array:
    """int32[num_bins] histogram of non-negative hit ids."""
    return _METHODS[method](hit_ids, num_bins)


def accumulate_dose(photon_map, max_photon_map, counts, time_step):
    """One accumulate step (cl/accumulate.cl:4-14).

    photon_map += counts * time_step (duration-weighted cumulative);
    max_photon_map = max(max_photon_map, counts).
    Returns the new (photon_map, max_photon_map).
    """
    counts_f = counts.astype(photon_map.dtype)
    return (
        photon_map + counts_f * jnp.asarray(time_step, photon_map.dtype),
        jnp.maximum(max_photon_map, counts_f),
    )
