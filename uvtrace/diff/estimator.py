"""Differentiable dose estimator.

The reference's count-based estimator (photon hits per triangle,
cl/extend.cl + cl/shade.cl) is piecewise-constant in the lamp parameters —
its a.e. derivative is zero, so a differentiable layer needs a different
formulation (BASELINE north-star: "gradients flow from dose maps back to lamp
position/route waypoints").

We use the next-event factorization  E_t = G_t(theta) * V_t :

  irradiance of triangle t from a vertical rod lamp (power P, length L,
  isotropic emission per rod point — the distribution of cl/generate.cl):

    E_t(theta) = P * mean_{r on rod, q on tri} [ V(r,q) * |cos theta_q| / (4 pi |q-r|^2) ]

  - G (geometry term): closed-form in lamp x/z, rod base height, rod length,
    triangle geometry -> differentiated exactly by JAX AD.
  - V (visibility): Monte-Carlo binary occlusion, estimated by tracing
    shadow rays with the regular traversal, and held piecewise-constant
    (`stop_gradient`) — the documented differentiability contract: gradients
    are exact wherever visibility is locally constant; visibility-boundary
    (silhouette) terms are ignored. With common random numbers this matches
    finite differences of the same estimator away from silhouettes.

Expected values match the reference estimator: a photon from rod point r hits
triangle t with probability A_t |cos| / (4 pi d^2) (solid-angle measure, both
faces — Möller–Trumbore accepts backfaces, cl/extend.cl:6-27), so
E[count-dose] == this estimator. Tests cross-validate the two.

Units follow RayTracer::Shade (raytracer.cpp:96-116): multiply irradiance
(W/m^2) by 100 for µW/cm^2, time-integrate and multiply by 0.1 for mJ/cm^2.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


class DiffScene(NamedTuple):
    """Static geometry for the differentiable estimator."""

    v0: jax.Array  # f32[T,3]
    e1: jax.Array  # f32[T,3] v1-v0
    e2: jax.Array  # f32[T,3] v2-v0
    normal: jax.Array  # f32[T,3] unit normals
    # occluder representation for shadow rays: extend_fn(trav_scene, o, d)
    # -> (t, original triangle ids[, overflow])
    trav_scene: object
    extend_fn: object


def make_diff_scene(mesh, backend: str = "auto", device_mesh=None) -> DiffScene:
    """Build the differentiable scene; `backend` picks the shadow-ray
    traversal (ops/select.py). Visibility is consumed under stop_gradient
    and only reads t_hit, so any exact backend is legal there. Shadow rays
    point from a few source points to samples spread over EVERY triangle,
    so a packet's frustum covers the whole scene: the clustered backend is
    built budget-free here, because any nearest-entry budget would silently
    drop occluders (V=1 where shadowed: over-estimated dose AND wrong
    gradients).

    device_mesh: optional 1-D ('rays',) jax.sharding.Mesh — shadow-ray
    batches then shard over the ray axis (shard_map + tiled all_gather of
    the t results; scene replicated, a few MB), scaling optimize-route /
    dose_image like every other launch. Results are bit-identical to the
    single-device scene (visibility is deterministic and per-ray)."""
    from uvtrace.ops.select import build_extend, resolve_traversal

    tris = jnp.asarray(mesh.tris)
    v0, v1, v2 = tris[:, 0], tris[:, 1], tris[:, 2]
    e1, e2 = v1 - v0, v2 - v0
    n = jnp.cross(e1, e2)
    n = n / jnp.maximum(jnp.linalg.norm(n, axis=-1, keepdims=True), 1e-20)
    ext = build_extend(mesh.tris, resolve_traversal(backend))
    scene = DiffScene(
        v0=v0, e1=e1, e2=e2, normal=n, trav_scene=ext.scene, extend_fn=ext.fn
    )
    return _shard_extend(scene, device_mesh)


def _shard_extend(scene: DiffScene, device_mesh) -> DiffScene:
    """Wrap the scene's extend_fn in a shard_map over the mesh's 'rays'
    axis: each device traces its slice of the shadow-ray batch, a tiled
    all_gather replicates the (t, hit) results (8 B/ray), so
    callers see ordinary replicated arrays — eager slicing included. No-op
    without a mesh."""
    if device_mesh is None:
        return scene
    import math

    from jax.sharding import Mesh, PartitionSpec as P

    # AUTO axis types: jax.make_mesh defaults to EXPLICIT sharding-in-types
    # axes, whose avals escape the shard_map and break eager grad traces
    # ("Length of device assignment 1 is not equal to the size of the
    # mesh"); the plain Mesh constructor keeps the classic auto semantics
    # this wrapper wants.
    device_mesh = Mesh(device_mesh.devices, device_mesh.axis_names)
    ndev = math.prod(device_mesh.devices.shape)
    inner = scene.extend_fn

    def fn(trav, o, d):
        r = inner(trav, o, d)
        t, h = r[0], r[1]
        t = jax.lax.all_gather(t, "rays", tiled=True)
        h = jax.lax.all_gather(h, "rays", tiled=True)
        return t, h

    # NOT wrapped in its own jax.jit: a nested jit over explicitly-sharded
    # avals fails inside an outer grad trace ("enter your jit into a mesh
    # context"); callers jit the whole objective anyway (optimize_route's
    # value_and_grad), which compiles this shard_map along with it.
    sharded = jax.shard_map(
        fn,
        mesh=device_mesh,
        in_specs=(P(), P("rays"), P("rays")),
        out_specs=(P(), P()),
        check_vma=False,
    )
    step = ndev * 1024  # whole 1024-ray packets per shard

    def extend(trav, o, d):
        r = o.shape[0]
        pad = (-r) % step
        if pad:  # park padding rays far outside the scene
            o = jnp.concatenate([o, jnp.full((pad, 3), 1e6, o.dtype)])
            d = jnp.concatenate(
                [d,
                 jnp.broadcast_to(jnp.array([0.0, 1.0, 0.0], d.dtype), (pad, 3))]
            )
        t, h = sharded(trav, o, d)
        return t[:r], h[:r]

    return scene._replace(extend_fn=extend)


def _sample_triangle_points(scene: DiffScene, key, n_samples: int):
    """Uniform points on each triangle: q = v0 + u*e1 + v*e2, (u,v) uniform
    on the unit triangle. Returns f32[S,T,3] (differentiable in geometry)."""
    t_count = scene.v0.shape[0]
    ku, kv = jax.random.split(key)
    u = jax.random.uniform(ku, (n_samples, t_count, 1))
    v = jax.random.uniform(kv, (n_samples, t_count, 1))
    flip = (u + v) > 1.0
    u = jnp.where(flip, 1.0 - u, u)
    v = jnp.where(flip, 1.0 - v, v)
    return scene.v0[None] + u * scene.e1[None] + v * scene.e2[None]


def _visibility(scene: DiffScene, rod_points, qs, eps: float = 1e-3):
    """Binary visibility between rod points r[S,3]-broadcastable and surface
    points q[S,T,3]: 1.0 if the shadow ray reaches q before any other hit.
    Non-differentiable by construction: gradients are severed at the INPUTS
    (not just the output) — endpoints entering a shadow ray contribute no
    tangents, which is the documented piecewise-constant contract AND keeps
    the traversal out of the differentiated program (its tangents would be
    pure wasted compute)."""
    rod_points = jax.lax.stop_gradient(rod_points)
    qs = jax.lax.stop_gradient(qs)
    d = qs - rod_points
    dist = jnp.linalg.norm(d, axis=-1)
    direction = d / jnp.maximum(dist[..., None], 1e-20)
    s, t_count = qs.shape[0], qs.shape[1]
    orig = jnp.broadcast_to(rod_points, qs.shape).reshape(s * t_count, 3)
    dirs = direction.reshape(s * t_count, 3)
    t_hit, _ = scene.extend_fn(scene.trav_scene, orig, dirs)[:2]
    t_hit = t_hit.reshape(s, t_count)
    # visible if nothing closer than the target point (within tolerance)
    return (t_hit >= dist * (1.0 - eps) - eps).astype(jnp.float32)


def irradiance(
    scene: DiffScene,
    lamp_xz,
    rod_base_y,
    rod_length,
    power,
    key,
    *,
    n_samples: int = 8,
) -> jax.Array:
    """Differentiable per-triangle irradiance E_t in W/m^2.

    Args:
      lamp_xz: f32[2] lamp floor position (differentiable).
      rod_base_y: rod base world height (floor + light_height).
      rod_length: rod length (m).
      power: lamp power P (W).
      key: PRNG key — fix it for common random numbers across evaluations.
      n_samples: (rod point, triangle point) sample pairs per triangle.
    """
    keys = jax.random.split(key, 3)
    t_count = scene.v0.shape[0]
    qs = _sample_triangle_points(scene, keys[0], n_samples)  # [S,T,3]
    u_rod = jax.random.uniform(keys[1], (n_samples, 1))
    rod_y = rod_base_y + u_rod * rod_length  # [S,1]
    rod_points = jnp.concatenate(
        [
            jnp.broadcast_to(lamp_xz[0], (n_samples, 1)),
            rod_y,
            jnp.broadcast_to(lamp_xz[1], (n_samples, 1)),
        ],
        axis=-1,
    )[:, None, :]  # [S,1,3]

    d = qs - rod_points  # [S,T,3]
    dist2 = jnp.sum(d * d, axis=-1)  # [S,T]
    dist = jnp.sqrt(jnp.maximum(dist2, 1e-12))
    cos = jnp.abs(jnp.sum(d * scene.normal[None], axis=-1)) / dist
    g = cos / (4.0 * np.pi * jnp.maximum(dist2, 1e-12))  # [S,T]

    vis = jax.lax.stop_gradient(_visibility(scene, rod_points, qs))
    return power * jnp.mean(g * vis, axis=0)  # [T]


def _points_direct(
    scene: DiffScene, pts, normals, lamp_xz, rod_base_y, rod_length, power,
    key, n_rod: int,
):
    """Differentiable direct irradiance at arbitrary surface points
    pts f32[M,3] with unit normals f32[M,3] — the same rod-sampled
    G x V estimator as `irradiance`, point-wise. Returns f32[M]."""
    u_rod = jax.random.uniform(key, (n_rod, 1))
    rod_points = jnp.concatenate(
        [
            jnp.broadcast_to(lamp_xz[0], (n_rod, 1)),
            rod_base_y + u_rod * rod_length,
            jnp.broadcast_to(lamp_xz[1], (n_rod, 1)),
        ],
        axis=-1,
    )[:, None, :]  # [R,1,3]
    d = pts[None] - rod_points  # [R,M,3]
    dist2 = jnp.sum(d * d, axis=-1)
    dist = jnp.sqrt(jnp.maximum(dist2, 1e-12))
    cos = jnp.abs(jnp.sum(d * normals[None], axis=-1)) / dist
    g = cos / (4.0 * np.pi * jnp.maximum(dist2, 1e-12))
    qs = jnp.broadcast_to(pts[None], (n_rod,) + pts.shape)  # [R,M,3]
    vis = jax.lax.stop_gradient(_visibility(scene, rod_points, qs))
    return power * jnp.mean(g * vis, axis=0)  # [M]


def bounce_irradiance(
    scene: DiffScene,
    lamp_xz,
    rod_base_y,
    rod_length,
    power,
    reflectance,
    areas,
    key,
    *,
    n_samples: int = 4,
    n_sources: int = 64,
    n_bounces: int = 1,
    source_chunk: int = 16,
) -> jax.Array:
    """Differentiable MULTI-BOUNCE (diffuse interreflection) irradiance
    sum_{k=1..n_bounces} E^k_t in W/m^2 with per-triangle reflectance
    f32[T] — the differentiable counterpart of the count-based bounce mode
    (ops/bounce.py: survive w.p. rho, re-emit cosine-weighted; its expected
    per-triangle arrival flux over k bounce segments equals A_t * sum E^k_t).

    Estimator (virtual-point-light / Neumann iteration): area-weighted
    source points x_m (prob ∝ A_s, importance weight w = A_total/M) carry
    per-level incident irradiance

      E_0(m) = E_dir(x_m)                         (rod-sampled direct term)
      E_k(m) = w * sum_{m'≠m} rho_m' E_{k-1}(m') F(x_m', x_m)   k >= 1

    with the Lambertian form factor F(x,y) = cos_x cos_y / (pi |x-y|^2)
    V(x,y) — i.e. the M x M transfer matrix applied k-1 times. Receiver
    irradiance is ONE chunked transfer pass because it is linear in the
    source exitance:

      sum_k E^k_t = mean_q  w * sum_m  rho_m (sum_{k=0}^{B-1} E_k(m))
                                      * F(x_m, q)

    Bias/variance notes: reusing the SAME M points across operator
    applications is the standard many-light estimator — each term is
    consistent with O(1/M) correlation bias; the m'==m diagonal is excluded
    (a point does not light itself; its F is singular). Truncation at B
    bounces leaves a residual bounded by rho_max^(B+1)/(1-rho_max) of the
    direct term — at the rooms' rho<=0.5 and B=2 that is <12.5% of an
    already-few-percent correction.

    Gradients: EXACT polynomials in `reflectance` (degree n_bounces);
    lamp/rod/power gradients flow through E_dir (same stop-gradient
    visibility contract as `irradiance`). Double-sided cosines match the
    reference's backface-accepting Möller–Trumbore (cl/extend.cl:6-27).

    source_chunk: receiver-transfer sources per lax.map step — bounds peak
    memory at [chunk, S, T, 3] independently of n_sources (the full
    [M,S,T,3] broadcast was ~multi-hundred-MB at production scale).

    areas: f32[T] triangle areas (mesh.areas).
    """
    keys = jax.random.split(key, 4)
    x_m, n_m, strength, w = _source_field(
        scene, lamp_xz, rod_base_y, rod_length, power, reflectance, areas,
        keys, n_samples=n_samples, n_sources=n_sources, n_bounces=n_bounces,
    )

    qs = _sample_triangle_points(scene, keys[3], n_samples)  # [S,T,3]
    s, t = qs.shape[0], qs.shape[1]
    acc = _receiver_transfer(
        scene, qs.reshape(s * t, 3),
        jnp.broadcast_to(scene.normal[None], (s, t, 3)).reshape(s * t, 3),
        x_m, n_m, strength, source_chunk,
    ).reshape(s, t)
    return w * jnp.mean(acc, axis=0)  # [T]


def _source_field(
    scene, lamp_xz, rod_base_y, rod_length, power, reflectance, areas, keys,
    *, n_samples, n_sources, n_bounces,
):
    """Sample the virtual-point-light field: area-weighted source points
    x_m with normals, and per-source exitance strength rho_m * sum_k E_k(m)
    after n_bounces-1 applications of the M x M Lambertian transfer matrix
    (see bounce_irradiance docstring). Returns (x_m, n_m, strength, w)."""
    t_count = scene.v0.shape[0]
    areas = jnp.asarray(areas)
    probs = areas / jnp.sum(areas)
    src = jax.random.choice(keys[0], t_count, (n_sources,), p=probs)
    ku, kv = jax.random.split(keys[1])
    u = jax.random.uniform(ku, (n_sources, 1))
    v = jax.random.uniform(kv, (n_sources, 1))
    flip = (u + v) > 1.0
    u = jnp.where(flip, 1.0 - u, u)
    v = jnp.where(flip, 1.0 - v, v)
    x_m = scene.v0[src] + u * scene.e1[src] + v * scene.e2[src]  # [M,3]
    n_m = scene.normal[src]
    rho_m = jnp.asarray(reflectance)[src]
    w = jnp.sum(areas) / n_sources

    e_dir = _points_direct(
        scene, x_m, n_m, lamp_xz, rod_base_y, rod_length, power,
        keys[2], n_rod=max(4, n_samples),
    )  # [M]

    e_sum = e_dir
    if n_bounces > 1:
        # source-to-source Lambertian transfer matrix F[m', m] (M x M):
        # one M^2 shadow-ray batch, zero diagonal (self-lighting excluded)
        d_ss = x_m[None] - x_m[:, None]  # [M',M,3]
        dist2_ss = jnp.sum(d_ss * d_ss, axis=-1)
        dist_ss = jnp.sqrt(jnp.maximum(dist2_ss, 1e-12))
        cos_src = jnp.abs(jnp.sum(d_ss * n_m[:, None, :], axis=-1)) / dist_ss
        cos_rcv = jnp.abs(jnp.sum(d_ss * n_m[None, :, :], axis=-1)) / dist_ss
        vis_ss = jax.lax.stop_gradient(
            _visibility(
                scene,
                x_m[:, None, :],  # [M',1,3]
                jnp.broadcast_to(x_m[None], (n_sources, n_sources, 3)),
            )
        )
        eye = jnp.eye(n_sources)
        f_ss = (
            cos_src * cos_rcv / (np.pi * jnp.maximum(dist2_ss, 1e-12))
            * vis_ss * (1.0 - eye)
        )  # [M', M]
        e_sum = _neumann_sum(e_dir, rho_m, f_ss, w, n_bounces)
    return x_m, n_m, rho_m * e_sum, w


def _neumann_sum(e_dir, rho_m, f_ss, w, n_bounces: int):
    """sum_{k=0}^{B-1} E_k over the source field, with E_0 = e_dir and
    E_k(n) = w * sum_m rho_m E_{k-1}(m) F[m, n] (F: f_ss, zero diagonal)."""
    e_k = e_sum = e_dir
    for _ in range(1, n_bounces):
        # the one float32 contraction on the product path: HIGHEST, so that
        # a GPU does not run it in TF32 (~3 decimal digits), which would
        # shift the bounce term and its gradients
        e_k = w * jnp.einsum(
            "m,mn->n", rho_m * e_k, f_ss, precision=jax.lax.Precision.HIGHEST
        )
        e_sum = e_sum + e_k
    return e_sum


def _receiver_transfer(scene, pts, normals, x_m, n_m, strength, source_chunk):
    """Chunked strength-weighted Lambertian transfer from the source field
    to arbitrary receiver points pts f32[P,3] with unit normals f32[P,3]:
    returns sum_m strength_m * F(x_m, p) as f32[P] (multiply by w outside).
    lax.map over source chunks bounds peak memory at [chunk, P, 3]
    independently of n_sources (round-4 advisor finding)."""
    n_sources = x_m.shape[0]
    p_count = pts.shape[0]
    chunk = max(1, min(source_chunk, n_sources))
    pad = (-n_sources) % chunk
    if pad:  # pad sources to whole chunks (weight 0 => no contribution)
        x_m = jnp.concatenate([x_m, jnp.broadcast_to(x_m[:1], (pad, 3))])
        n_m = jnp.concatenate([n_m, jnp.broadcast_to(n_m[:1], (pad, 3))])
        strength = jnp.concatenate([strength, jnp.zeros((pad,))])
    n_chunks = x_m.shape[0] // chunk

    def one_chunk(args):
        x_c, n_c, s_c = args  # [B,3],[B,3],[B]
        d = pts[None] - x_c[:, None, :]  # [B,P,3]
        dist2 = jnp.sum(d * d, axis=-1)
        dist = jnp.sqrt(jnp.maximum(dist2, 1e-12))
        cos_m = jnp.abs(jnp.sum(d * n_c[:, None, :], axis=-1)) / dist
        cos_p = jnp.abs(jnp.sum(d * normals[None], axis=-1)) / dist
        vis = jax.lax.stop_gradient(
            _visibility(
                scene,
                x_c[:, None, :],  # [B,1,3]
                jnp.broadcast_to(pts[None], (chunk, p_count, 3)),
            )
        )
        transfer = cos_m * cos_p / (np.pi * jnp.maximum(dist2, 1e-12)) * vis
        return jnp.sum(s_c[:, None] * transfer, axis=0)  # [P]

    chunks = (
        x_m.reshape(n_chunks, chunk, 3),
        n_m.reshape(n_chunks, chunk, 3),
        strength.reshape(n_chunks, chunk),
    )
    return jnp.sum(jax.lax.map(one_chunk, chunks), axis=0)  # [P]


def one_bounce_irradiance(
    scene: DiffScene,
    lamp_xz,
    rod_base_y,
    rod_length,
    power,
    reflectance,
    areas,
    key,
    *,
    n_samples: int = 4,
    n_sources: int = 64,
) -> jax.Array:
    """One-bounce special case of `bounce_irradiance` (kept as the named
    entry point the round-4 deliverable shipped with)."""
    return bounce_irradiance(
        scene, lamp_xz, rod_base_y, rod_length, power, reflectance, areas,
        key, n_samples=n_samples, n_sources=n_sources, n_bounces=1,
    )


def route_dose(
    scene: DiffScene,
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
) -> jax.Array:
    """Differentiable cumulative dose [mJ/cm^2] over a route.

    dose_t = 0.1 * sum_w duration_w * E_t(lamp_w)   (Report §3 Eq. 1 units)

    waypoints_xz: f32[W,2]; durations: f32[W] (both differentiable).
    reflectance: optional f32[T] — adds the differentiable interreflection
    terms (bounce_irradiance, n_bounces of them; requires `areas`);
    gradients then also flow w.r.t. the reflectances, matching the forward
    bounce simulator's transport depth (ops/bounce.py runs max_bounces
    count segments).
    """
    if reflectance is not None and areas is None:
        raise ValueError("route_dose(reflectance=...) needs areas=mesh.areas")

    def one(w, carry):
        acc = carry
        kw_ = jax.random.fold_in(key, w)
        e = irradiance(
            scene,
            waypoints_xz[w],
            rod_base_y,
            rod_length,
            power,
            kw_,
            n_samples=n_samples,
        )
        if reflectance is not None:
            e = e + bounce_irradiance(
                scene,
                waypoints_xz[w],
                rod_base_y,
                rod_length,
                power,
                reflectance,
                areas,
                jax.random.fold_in(kw_, 1),
                n_samples=n_samples,
                n_sources=n_sources,
                n_bounces=n_bounces,
            )
        return acc + durations[w] * e

    acc = jnp.zeros((scene.v0.shape[0],))
    acc = jax.lax.fori_loop(0, waypoints_xz.shape[0], one, acc)
    return 0.1 * acc
