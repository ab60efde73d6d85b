"""Procedural sky / environment light.

Reproduces ``get_environment_light`` (shaders/ray_tracer.wgsl:297-304) and
its constants (shaders/ray_tracer.wgsl:100-104): horizon→zenith gradient with
a smoothstep ramp, flat ground color below the horizon, and a tight specular
sun lobe added only at/above the horizon. Pure elementwise jnp — XLA fuses it
into the shading epilogue.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

SKY_HORIZON = np.array([1.0, 1.0, 1.0], np.float32)
SKY_ZENITH = np.array([0.0788092, 0.36480793, 0.7264151], np.float32)
GROUND_COLOR = np.array([0.35, 0.3, 0.35], np.float32)
SUN_INTENSITY = np.float32(0.1)
SUN_FOCUS = np.float32(500.0)
SUN_DIR = np.array([0.1, 1.0, 0.1], np.float32)  # unnormalized, as reference


def smoothstep(edge0, edge1, x):
    t = jnp.clip((x - edge0) / (edge1 - edge0), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def environment_light(dirs):
    """Sky radiance for ray directions ``dirs`` (..., 3) → (..., 3).

    Note the reference evaluates the sky with the *unnormalized* ray
    direction (dir.y raw, dot(dir, sun) raw) — we keep that behavior for
    parity; callers pass the same unnormalized dirs the bounce loop carries.
    """
    y = dirs[..., 1]
    # pow(x, 0.35) has infinite slope at x=0 (every ray at/below the
    # horizon) → double-where keeps autodiff NaN-free.
    s = smoothstep(0.0, 0.4, y)
    s_ok = s > 0.0
    sky_t = jnp.where(s_ok, jnp.power(jnp.where(s_ok, s, 1.0), 0.35), 0.0)
    ground_to_sky = smoothstep(-0.01, 0.0, y)
    sky = SKY_HORIZON * (1.0 - sky_t[..., None]) + SKY_ZENITH * sky_t[..., None]
    # an elementwise dot: a matmul here could run in TF32 on the GPU
    sun_cos = (dirs[..., 0] * SUN_DIR[0] + dirs[..., 1] * SUN_DIR[1]
               + dirs[..., 2] * SUN_DIR[2])
    sun = jnp.power(jnp.maximum(0.0, sun_cos), SUN_FOCUS) * SUN_INTENSITY
    composite = (
        GROUND_COLOR * (1.0 - ground_to_sky[..., None])
        + sky * ground_to_sky[..., None]
        + sun[..., None] * (ground_to_sky >= 1.0)[..., None].astype(jnp.float32)
    )
    return composite
