"""Differentiable dose IMAGE — pixel gradients (BASELINE north-star:
"pixel gradients allclose to finite-difference oracle").

The forward `Simulator.dose_grid` (sim/simulator.py) is a res x res
top-down probe image of the count-based dose — all non-differentiable
machinery. This module ships its differentiable counterpart:

  1. `plan_dose_image` fixes the pixel -> surface assignment ONCE (probe
     rays through the scene's own traversal backend, the same skip-ceiling
     re-cast as dose_grid) — geometry only, independent of every lamp
     parameter, so it is constant under differentiation by construction
     (the same piecewise-constant contract as visibility: estimator.py).
  2. `dose_image` evaluates the differentiable point-irradiance estimator
     (`_points_direct`, plus the multi-bounce source-field transfer when a
     reflectance is given) at the planned pixel points for every route
     waypoint: jax.grad of any pixel w.r.t. lamp xz / durations / power /
     reflectance flows through the same G x V factorization as route_dose.

Semantics note vs the forward dose_grid: a pixel here reports the POINT
dose at the probe's hit point; the count pipeline reports that point's
TRIANGLE-average dose. The two converge as tessellation refines —
tests/test_diff_image.py pins image-mean agreement on a box room and the
FD pixel-gradient check.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from uvtrace.diff.estimator import (
    DiffScene,
    _points_direct,
    _receiver_transfer,
    _source_field,
)


class ImagePlan(NamedTuple):
    """Fixed pixel -> surface assignment (geometry only; no lamp params)."""

    points: jax.Array  # f32[P,3] first-hit surface points (pixel centers)
    normals: jax.Array  # f32[P,3] unit normals of the hit triangles
    tri: jax.Array  # i32[P] hit triangle id (-1 = miss)
    mask: jax.Array  # bool[P] probe hit something
    res: int


def plan_dose_image(
    scene: DiffScene,
    res: int = 64,
    *,
    skip_ceiling: bool = True,
    ceiling_margin: float = 0.05,
) -> ImagePlan:
    """Cast the res x res top-down probe grid once and record each pixel's
    surface point + normal. Probe layout and ceiling-band re-cast are the
    SAME code Simulator.dose_grid runs (ops/probes.py — the forward/diff
    image comparison tests assume identical probe geometry; the height-band
    caveat is documented there)."""
    from uvtrace.ops.probes import first_hits_skip_ceiling, probe_rays

    verts = jnp.concatenate(
        [scene.v0, scene.v0 + scene.e1, scene.v0 + scene.e2], axis=0
    )
    lo = np.asarray(jnp.min(verts, axis=0))
    hi = np.asarray(jnp.max(verts, axis=0))
    orig, direction = probe_rays(lo, hi, res)

    def extend2(o, d):
        return scene.extend_fn(scene.trav_scene, o, d)[:2]

    t_hit, hit = first_hits_skip_ceiling(
        extend2, orig, direction, float(lo[1]), float(hi[1]),
        skip_ceiling=skip_ceiling, ceiling_margin=ceiling_margin,
    )
    mask = hit >= 0
    safe = jnp.maximum(hit, 0)
    points = orig + t_hit[:, None] * direction
    # nudge the point a hair toward the probe so its own surface does not
    # occlude the shadow rays evaluated at it
    points = points + 1e-4 * jnp.array([0.0, 1.0, 0.0], jnp.float32)
    return ImagePlan(
        points=jnp.where(mask[:, None], points, 1e6),
        normals=scene.normal[safe],
        tri=jnp.where(mask, hit, -1),
        mask=mask,
        res=res,
    )


def dose_image(
    scene: DiffScene,
    plan: ImagePlan,
    waypoints_xz,
    durations,
    rod_base_y,
    rod_length,
    power,
    key,
    *,
    n_samples: int = 8,
    reflectance=None,
    areas=None,
    n_sources: int = 64,
    n_bounces: int = 1,
    source_chunk: int = 16,
) -> jax.Array:
    """Differentiable res x res cumulative-dose image [mJ/cm^2].

    pixel = 0.1 * sum_w duration_w * E_point(p_pixel)  (Report §3 Eq. 1
    units at the pixel's fixed surface point; miss pixels are 0).

    All of waypoints_xz, durations, power, reflectance are differentiable;
    the pixel assignment (plan) and visibility are the fixed piecewise-
    constant part of the contract. Fix `key` for common random numbers so
    finite differences of the same estimator are meaningful.
    """
    if reflectance is not None and areas is None:
        raise ValueError("dose_image(reflectance=...) needs areas=mesh.areas")
    waypoints_xz = jnp.asarray(waypoints_xz)
    durations = jnp.asarray(durations)
    p_count = plan.points.shape[0]

    def one(w, acc):
        kw_ = jax.random.fold_in(key, w)
        e = _points_direct(
            scene, plan.points, plan.normals, waypoints_xz[w], rod_base_y,
            rod_length, power, kw_, n_rod=n_samples,
        )  # [P]
        if reflectance is not None:
            keys = jax.random.split(jax.random.fold_in(kw_, 1), 4)
            x_m, n_m, strength, wgt = _source_field(
                scene, waypoints_xz[w], rod_base_y, rod_length, power,
                jnp.broadcast_to(
                    jnp.asarray(reflectance, jnp.float32), (scene.v0.shape[0],)
                ),
                areas, keys,
                n_samples=n_samples, n_sources=n_sources, n_bounces=n_bounces,
            )
            e = e + wgt * _receiver_transfer(
                scene, plan.points, plan.normals, x_m, n_m, strength,
                source_chunk,
            )
        return acc + durations[w] * e

    acc = jax.lax.fori_loop(
        0, waypoints_xz.shape[0], one, jnp.zeros((p_count,))
    )
    img = jnp.where(plan.mask, 0.1 * acc, 0.0)
    return img.reshape(plan.res, plan.res)
