"""Dose / irradiance unit conversion and heatmap coloring.

Reference: cl/shade.cl — `computeDosage` (:23-41): per-triangle
dose = scaled_power * photon_count / (area * photons_per_light), implementing
Report §3 Eq. 1 (cumulative dose, J/m^2 -> mJ/cm^2 via x0.1) and Eq. 2 (max
irradiance, W/m^2 -> µW/cm^2 via x100); `dosageToColor` (:43-71) with the
5-stop blue->cyan->green->yellow->red gradient (`greyscale_to_heatmap`,
:4-21) and the threshold view (sub-0.5 rendered as a dark blue ramp).

Pure jnp — XLA fuses these elementwise maps.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def triangle_areas(tris: jax.Array) -> jax.Array:
    """float[T] areas = |cross(v0-v1, v0-v2)|/2 (cl/shade.cl:31-36)."""
    v0, v1, v2 = tris[:, 0], tris[:, 1], tris[:, 2]
    c = jnp.cross(v0 - v1, v0 - v2)
    return 0.5 * jnp.linalg.norm(c, axis=-1)


def compute_dosage(photon_map, areas, photons_per_light, scaled_power):
    """dose_t = scaled_power * n_t / (area_t * photons_per_light)
    (cl/shade.cl:39)."""
    return (jnp.asarray(scaled_power, jnp.float32) * photon_map.astype(jnp.float32)) / (
        areas * jnp.asarray(photons_per_light, jnp.float32)
    )


def greyscale_to_heatmap(intensity: jax.Array) -> jax.Array:
    """5-stop heat gradient (cl/shade.cl:4-21); input scalar field ->
    float32[..., 3] RGB. Piecewise around min_dosage_color=0.5."""
    i = intensity
    min_c = 0.5
    upper = min_c + (1.0 - min_c) / 2  # 0.75
    lower = min_c / 2.0  # 0.25
    r = jnp.where(i > upper, 1.0, jnp.where(i > min_c, (i - min_c) / (upper - min_c), 0.0))
    g = jnp.where(
        i > upper,
        (1.0 - i) / (1.0 - upper),
        jnp.where(i > lower, 1.0, i / lower),
    )
    b = jnp.where(i > min_c, 0.0, jnp.where(i > lower, (min_c - i) / (min_c - lower), 1.0))
    return jnp.stack([r, g, b], axis=-1)


def dosage_to_color(dosage_map, min_value, threshold_view: bool = False):
    """Normalize by 2*min_value and colorize (cl/shade.cl:43-71).

    In threshold view, values below 0.5 (i.e. below the minimum dose) render
    as a dark blue ramp so compliant/non-compliant regions separate visually.
    Returns float32[T,3] RGB per triangle (the reference writes the same RGB
    to all 3 vertices of the triangle's color VBO slot — per-corner expansion
    is the renderer's concern here, viz/).
    """
    norm = dosage_map / (2.0 * jnp.asarray(min_value, jnp.float32))
    heat = greyscale_to_heatmap(norm)
    if threshold_view:
        dark_blue = jnp.stack(
            [jnp.zeros_like(norm), jnp.zeros_like(norm), norm * 2.0], axis=-1
        )
        heat = jnp.where((norm < 0.5)[..., None], dark_blue, heat)
    # the reference writes unclamped floats into a GL VBO and lets the
    # rasterizer clamp; we clamp here so exported images are valid
    return jnp.clip(heat, 0.0, 1.0)
