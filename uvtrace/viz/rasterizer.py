"""Headless software rasterizer — the reference's OpenGL heatmap view
(myapp.cpp:180-205 + shaders/shader3D.*) replaced by a chunked z-buffered
edge-function rasterizer in jnp that renders per-triangle flat colors to an
image. Headless hosts have no GL; rendering to PNG files is the L5 parity path.

Algorithm: project triangles through the camera; for chunks of triangles,
evaluate edge functions over the full image, keep per-pixel (depth, color)
via a running min-z merge — fully vectorized, no scatter.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from uvtrace.viz.camera import Camera


def _project(tris, view, fov_deg, width, height):
    """World [T,3,3] -> screen xy [T,3,2], view-space depth [T,3], valid."""
    t_count = tris.shape[0]
    v = tris.reshape(-1, 3)
    vh = jnp.concatenate([v, jnp.ones((v.shape[0], 1), v.dtype)], axis=1)
    cam = (view @ vh.T).T  # [N,4], view space (-z forward)
    z = -cam[:, 2]
    f = 1.0 / jnp.tan(jnp.radians(fov_deg) / 2.0)
    aspect = width / height
    eps = 1e-6
    x_ndc = (cam[:, 0] * f / aspect) / jnp.maximum(z, eps)
    y_ndc = (cam[:, 1] * f) / jnp.maximum(z, eps)
    sx = (x_ndc * 0.5 + 0.5) * width
    sy = (1.0 - (y_ndc * 0.5 + 0.5)) * height
    xy = jnp.stack([sx, sy], axis=1).reshape(t_count, 3, 2)
    depth = z.reshape(t_count, 3)
    return xy, depth


@functools.partial(jax.jit, static_argnames=("width", "height", "chunk"))
def _render(tris, colors, view, fov_deg, width=640, height=480, chunk=256):
    xy, depth = _project(tris, view, fov_deg, width, height)
    behind = jnp.any(depth <= 1e-4, axis=1)  # drop tris crossing the camera

    px = jnp.arange(width, dtype=jnp.float32) + 0.5
    py = jnp.arange(height, dtype=jnp.float32) + 0.5
    gx = px[None, :]  # [1,W]
    gy = py[:, None]  # [H,1]

    t_count = tris.shape[0]
    pad = (-t_count) % chunk
    xy = jnp.pad(xy, ((0, pad), (0, 0), (0, 0)))
    depth = jnp.pad(depth, ((0, pad), (0, 0)), constant_values=1.0)
    colors = jnp.pad(colors, ((0, pad), (0, 0)))
    behind = jnp.pad(behind, (0, pad), constant_values=True)

    def chunk_step(carry, idx):
        zbuf, img = carry
        cxy = jax.lax.dynamic_slice_in_dim(xy, idx * chunk, chunk)
        cz = jax.lax.dynamic_slice_in_dim(depth, idx * chunk, chunk)
        cc = jax.lax.dynamic_slice_in_dim(colors, idx * chunk, chunk)
        cb = jax.lax.dynamic_slice_in_dim(behind, idx * chunk, chunk)

        def one_tri(i, carry):
            zbuf, img = carry
            a, b, c = cxy[i, 0], cxy[i, 1], cxy[i, 2]

            def edge(p, q):
                return (q[0] - p[0]) * (gy - p[1]) - (q[1] - p[1]) * (gx - p[0])

            e0 = edge(a, b)
            e1 = edge(b, c)
            e2 = edge(c, a)
            area = (b[0] - a[0]) * (c[1] - a[1]) - (b[1] - a[1]) * (c[0] - a[0])
            inside = jnp.where(
                area >= 0, (e0 >= 0) & (e1 >= 0) & (e2 >= 0), (e0 <= 0) & (e1 <= 0) & (e2 <= 0)
            )
            zmean = jnp.mean(cz[i])  # flat per-tri depth (adequate for heatmaps)
            covered = inside & (~cb[i]) & (zmean < zbuf) & (jnp.abs(area) > 1e-12)
            zbuf = jnp.where(covered, zmean, zbuf)
            img = jnp.where(covered[..., None], cc[i][None, None, :], img)
            return zbuf, img

        zbuf, img = jax.lax.fori_loop(0, chunk, one_tri, (zbuf, img))
        return (zbuf, img), None

    zbuf0 = jnp.full((height, width), jnp.inf)
    img0 = jnp.zeros((height, width, 3))
    (zbuf, img), _ = jax.lax.scan(
        chunk_step, (zbuf0, img0), jnp.arange((t_count + pad) // chunk)
    )
    return img


@functools.partial(jax.jit, static_argnames=("width", "height", "chunk"))
def _render_tex(tris, uvs, view, fov_deg, width=640, height=480, chunk=256):
    """Per-pixel perspective-correct UV rasterization.

    Instead of per-tri flat colors, composite (u, v) per pixel — interpolate
    uv/z and 1/z with barycentric weights from the edge functions (what the
    reference's GL pipeline does in hardware, simpleshader.vert/frag) — and
    let the caller sample the texture ONCE over the final image (per-pixel
    per-triangle texture gathers would be 45k x H x W)."""
    xy, depth = _project(tris, view, fov_deg, width, height)
    behind = jnp.any(depth <= 1e-4, axis=1)

    px = jnp.arange(width, dtype=jnp.float32) + 0.5
    py = jnp.arange(height, dtype=jnp.float32) + 0.5
    gx = px[None, :]
    gy = py[:, None]

    t_count = tris.shape[0]
    pad = (-t_count) % chunk
    xy = jnp.pad(xy, ((0, pad), (0, 0), (0, 0)))
    depth = jnp.pad(depth, ((0, pad), (0, 0)), constant_values=1.0)
    uvs = jnp.pad(uvs, ((0, pad), (0, 0), (0, 0)))
    behind = jnp.pad(behind, (0, pad), constant_values=True)

    def chunk_step(carry, idx):
        zbuf, uvbuf, hitbuf = carry
        cxy = jax.lax.dynamic_slice_in_dim(xy, idx * chunk, chunk)
        cz = jax.lax.dynamic_slice_in_dim(depth, idx * chunk, chunk)
        cu = jax.lax.dynamic_slice_in_dim(uvs, idx * chunk, chunk)
        cb = jax.lax.dynamic_slice_in_dim(behind, idx * chunk, chunk)

        def one_tri(i, carry):
            zbuf, uvbuf, hitbuf = carry
            a, b, c = cxy[i, 0], cxy[i, 1], cxy[i, 2]

            def edge(p, q):
                return (q[0] - p[0]) * (gy - p[1]) - (q[1] - p[1]) * (gx - p[0])

            e_bc = edge(b, c)  # ~ lambda_a * area
            e_ca = edge(c, a)  # ~ lambda_b * area
            e_ab = edge(a, b)  # ~ lambda_c * area
            area = (b[0] - a[0]) * (c[1] - a[1]) - (b[1] - a[1]) * (c[0] - a[0])
            inside = jnp.where(
                area >= 0,
                (e_bc >= 0) & (e_ca >= 0) & (e_ab >= 0),
                (e_bc <= 0) & (e_ca <= 0) & (e_ab <= 0),
            )
            inv_area = 1.0 / jnp.where(jnp.abs(area) < 1e-12, 1.0, area)
            la, lb, lc = e_bc * inv_area, e_ca * inv_area, e_ab * inv_area
            za, zb, zc = cz[i, 0], cz[i, 1], cz[i, 2]
            inv_z = la / za + lb / zb + lc / zc
            z_px = 1.0 / jnp.maximum(inv_z, 1e-12)
            u_px = (la * cu[i, 0, 0] / za + lb * cu[i, 1, 0] / zb + lc * cu[i, 2, 0] / zc) * z_px
            v_px = (la * cu[i, 0, 1] / za + lb * cu[i, 1, 1] / zb + lc * cu[i, 2, 1] / zc) * z_px
            covered = inside & (~cb[i]) & (z_px < zbuf) & (jnp.abs(area) > 1e-12)
            zbuf = jnp.where(covered, z_px, zbuf)
            uvbuf = jnp.where(
                covered[..., None], jnp.stack([u_px, v_px], axis=-1), uvbuf
            )
            hitbuf = hitbuf | covered
            return zbuf, uvbuf, hitbuf

        return jax.lax.fori_loop(0, chunk, one_tri, (zbuf, uvbuf, hitbuf)), None

    zbuf0 = jnp.full((height, width), jnp.inf)
    uv0 = jnp.zeros((height, width, 2))
    hit0 = jnp.zeros((height, width), bool)
    (zbuf, uvbuf, hitbuf), _ = jax.lax.scan(
        chunk_step, (zbuf0, uv0, hit0), jnp.arange((t_count + pad) // chunk)
    )
    return uvbuf, hitbuf


def render_textured(
    mesh,
    camera: Camera | None = None,
    width: int = 640,
    height: int = 480,
    gamma: bool = False,
) -> np.ndarray:
    """Render the scene with its scan texture, per-pixel (the reference's
    'photo scan' view: simpleshader + mesh texture, myapp.cpp:186-194).
    Falls back to per-triangle average colors when the mesh has no texture
    or no UVs."""
    if mesh.texture is None or mesh.uvs is None:
        return render_heatmap(
            mesh.tris, mesh.flat_texture_colors(), camera=camera,
            width=width, height=height, gamma=gamma,
        )
    tris = jnp.asarray(mesh.tris, jnp.float32)
    if camera is None:
        camera = default_camera(mesh.tris)
    uvbuf, hitbuf = _render_tex(
        tris,
        jnp.asarray(mesh.uvs, jnp.float32),
        jnp.asarray(camera.view),
        jnp.float32(camera.fov_deg),
        width=width,
        height=height,
    )
    uvbuf = np.asarray(uvbuf)
    hitbuf = np.asarray(hitbuf)
    tex = np.asarray(mesh.texture)
    h, w = tex.shape[:2]
    # GL_REPEAT + nearest sampling (the reference uploads with default
    # wrap/filter state, mesh.cpp:166-199). floor(u * w), NOT u * (w-1):
    # the latter shifts texels by up to a pixel across the image and samples
    # the baked atlas's zeroed gutters at block edges (black seams)
    tx = np.clip(np.floor((uvbuf[..., 0] % 1.0) * w).astype(np.int64), 0, w - 1)
    ty = np.clip(np.floor((uvbuf[..., 1] % 1.0) * h).astype(np.int64), 0, h - 1)
    img = np.where(hitbuf[..., None], tex[ty, tx].astype(np.float32) / 255.0, 0.0)
    img = np.clip(img, 0.0, 1.0)
    if gamma:
        img = np.sqrt(img)
    return (img * 255.0).astype(np.uint8)


def default_camera(mesh_tris) -> Camera:
    """Look-at from above the scene diagonal (used when no camera.xml)."""
    v = np.asarray(mesh_tris, np.float32).reshape(-1, 3)
    lo, hi = v.min(axis=0), v.max(axis=0)
    center = (lo + hi) / 2
    size = float(np.linalg.norm(hi - lo))
    eye = center + np.array([0.45, 0.75, 0.45]) * size
    return Camera.look_at(eye, center)


def render_heatmap(
    mesh_tris,
    colors,
    camera: Camera | None = None,
    width: int = 640,
    height: int = 480,
    gamma: bool = False,
) -> np.ndarray:
    """Render per-triangle RGB colors to a uint8 image [H,W,3].

    camera: defaults to a look-at from above the scene diagonal.
    gamma: sqrt-encode the output. The reference's display path is LINEAR —
    the template's gamma blit shader ships with the sqrt commented out
    (template/template.cpp:159: "f=/*sqrt*/(texture(c,u))") — so linear is
    the parity default and sqrt is opt-in (CLI --gamma).
    """
    tris = jnp.asarray(mesh_tris, jnp.float32)
    if camera is None:
        camera = default_camera(mesh_tris)
    img = _render(
        tris,
        jnp.asarray(colors, jnp.float32),
        jnp.asarray(camera.view),
        jnp.float32(camera.fov_deg),
        width=width,
        height=height,
    )
    img = jnp.clip(img, 0.0, 1.0)
    if gamma:
        img = jnp.sqrt(img)
    return np.asarray(img * 255.0).astype(np.uint8)


def project_points(points, camera: Camera, width: int, height: int):
    """World points [N,3] -> (screen xy [N,2], view depth [N]) — the same
    transform Draw3DLine applies (myapp.cpp:43-51)."""
    v = np.asarray(points, np.float64).reshape(-1, 3)
    vh = np.concatenate([v, np.ones((len(v), 1))], axis=1)
    cam = (np.asarray(camera.view, np.float64) @ vh.T).T
    z = -cam[:, 2]
    f = 1.0 / np.tan(np.radians(camera.fov_deg) / 2.0)
    aspect = width / height
    zs = np.maximum(z, 1e-6)
    sx = (cam[:, 0] * f / aspect / zs * 0.5 + 0.5) * width
    sy = (1.0 - (cam[:, 1] * f / zs * 0.5 + 0.5)) * height
    return np.stack([sx, sy], axis=1), z


def _paint_line(img, p0, p1, color, thickness=3):
    h, w = img.shape[:2]
    n = int(max(abs(p1[0] - p0[0]), abs(p1[1] - p0[1])) * 2) + 2
    xs = np.linspace(p0[0], p1[0], n)
    ys = np.linspace(p0[1], p1[1], n)
    r = thickness // 2
    for dx in range(-r, r + 1):
        for dy in range(-r, r + 1):
            xi = np.clip(np.round(xs + dx).astype(int), 0, w - 1)
            yi = np.clip(np.round(ys + dy).astype(int), 0, h - 1)
            keep = (xs + dx >= 0) & (xs + dx < w) & (ys + dy >= 0) & (ys + dy < h)
            img[yi[keep], xi[keep]] = color


def draw_route_markers(
    img: np.ndarray,
    camera: Camera,
    route,
    floor_height: float,
    light_height: float,
    light_length: float,
    selected: int = -1,
) -> np.ndarray:
    """Draw every waypoint's lamp rod as a 3-px projected line — white, the
    selected lamp (255,100,100) — exactly the reference's marker overlay
    (myapp.cpp:140-153: Draw3DLine from the rod base to base+lightLength).
    Mutates and returns the uint8 [H,W,3] image."""
    h, w = img.shape[:2]
    for i, wp in enumerate(route):
        base = np.array([wp.x, floor_height + light_height, wp.y])
        top = base + np.array([0.0, light_length, 0.0])
        (p0, p1), z = project_points(np.stack([base, top]), camera, w, h)
        if z.min() <= 1e-4:
            continue  # behind the camera
        color = (255, 100, 100) if i == selected else (255, 255, 255)
        _paint_line(img, p0, p1, np.array(color, np.uint8))
    return img


def draw_route_markers_grid(
    img: np.ndarray, aabb, route, selected: int = -1, cross: int = 4
) -> np.ndarray:
    """Waypoint crosses on a top-down dose-grid image (Simulator.dose_grid
    pixel mapping: x -> column over aabb x-range, z -> row over z-range)."""
    lo, hi = np.asarray(aabb[0]), np.asarray(aabb[1])
    h, w = img.shape[:2]
    for i, wp in enumerate(route):
        cx = (wp.x - lo[0]) / max(hi[0] - lo[0], 1e-9) * (w - 1)
        cy = (wp.y - lo[2]) / max(hi[2] - lo[2], 1e-9) * (h - 1)
        color = np.array((255, 100, 100) if i == selected else (255, 255, 255), np.uint8)
        _paint_line(img, (cx - cross, cy), (cx + cross, cy), color, thickness=1)
        _paint_line(img, (cx, cy - cross), (cx, cy + cross), color, thickness=1)
    return img
