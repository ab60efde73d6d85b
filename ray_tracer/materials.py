"""Branchless material scattering.

Re-designs the per-thread material branch of the reference bounce loop
(shaders/ray_tracer.wgsl:236-273) as masked lane arithmetic: every lane
computes the diffuse⊕glossy direction AND the dielectric direction, then a
``jnp.where`` on the material flag selects. This is a handful of
elementwise ops per lane — far cheaper than the intersection work — so
branchlessness costs ~nothing and keeps the whole wavefront in lockstep.

Math:
  * diffuse⊕glossy: dir' = mix(hemisphere_sample(n), reflect(d̂, n), s)
    (shaders/ray_tracer.wgsl:265-269)
  * dielectric (smoothness == -1): fixed IOR 1.5, front-face via dot(d, n),
    Schlick reflectance vs a uniform draw, reflect or refract
    (shaders/ray_tracer.wgsl:240-264, 284-295). The reference's ``refract``
    uses |r_perp| where Snell needs |r_perp|^2 (SURVEY quirk Q5); we
    implement correct Snell (deviation D9).
"""

from __future__ import annotations

import jax.numpy as jnp

from . import sampling

IOR_GLASS = 1.5  # fixed in the reference (shaders/ray_tracer.wgsl:250)


def reflect(d, n):
    """Mirror reflection (WGSL built-in `reflect`)."""
    return d - 2.0 * jnp.sum(d * n, axis=-1, keepdims=True) * n


def refract(unit_d, n, refraction_ratio):
    """Snell refraction (shaders/ray_tracer.wgsl:290-295, with the squared-
    length fix D9)."""
    cos_theta = jnp.minimum(jnp.sum(-unit_d * n, axis=-1, keepdims=True), 1.0)
    r_perp = refraction_ratio * (unit_d + cos_theta * n)
    r_perp_len2 = jnp.sum(r_perp * r_perp, axis=-1, keepdims=True)
    # clamp keeps d/dx sqrt finite at exact grazing (autodiff hygiene)
    r_par = -jnp.sqrt(jnp.maximum(jnp.abs(1.0 - r_perp_len2), 1e-12)) * n
    return r_perp + r_par


def schlick_reflectance(cosine, refraction_ratio):
    """Schlick approximation (shaders/ray_tracer.wgsl:284-288)."""
    r0 = (1.0 - refraction_ratio) / (1.0 + refraction_ratio)
    r0 = r0 * r0
    return r0 + (1.0 - r0) * jnp.power(1.0 - cosine, 5.0)


def scatter(state, d, normal, smoothness, cosine_sampling: bool = False,
            share_tile: int = 0):
    """Compute the scattered direction for every lane.

    Args:
      state: uint32 RNG state, shape (R,).
      d: incoming (unnormalized) ray directions (R, 3).
      normal: outward surface normals at the hit (R, 3), unit length.
      smoothness: per-lane material smoothness (R,); -1 marks dielectric.
      share_tile: if > 0 (and it divides R), all lanes of each
        ``share_tile``-ray tile share ONE unit-sphere draw for the diffuse
        lobe (coherent path tracing). Each ray's direction is still
        marginally exact — the shared draw is uniform on the sphere and
        the per-lane flip/normal-offset preserves the hemisphere /
        cosine distribution — so the estimator stays unbiased with
        identical per-pixel variance; only cross-pixel covariance within
        a tile (single-frame blockiness that averages out over frames)
        changes. What it buys: secondary-bounce kernel tiles carry a
        coherent direction cone, so cluster culling keeps working after
        the first bounce (~5% whole-frame on the open teapot scene, where
        87% of rays die at bounce 0; the win grows with bounce-survival —
        interior/occluded scenes).

    Returns:
      (state, new_dir (R, 3), is_dielectric (R,) bool).

    The dielectric draws one uniform for the reflect/refract choice; the
    diffuse path draws 6 for the hemisphere sample. To keep lanes in lockstep
    both are always drawn (RNG draws are a few integer ops; the per-lane draw
    *count* differs from the reference's divergent paths, which only shifts
    the stream — deviation D10, statistics unchanged).
    """
    unit_d = d / jnp.maximum(jnp.linalg.norm(d, axis=-1, keepdims=True), 1e-12)
    is_dielectric = smoothness < 0.0

    # --- diffuse ⊕ glossy path -------------------------------------------
    sharing = share_tile and state.shape[0] % share_tile == 0
    if sharing:
        # one sphere draw per tile, from a decorrelated copy of lane 0's
        # state (strided slice — no gather); broadcast is a free relayout
        tiles = state.shape[0] // share_tile
        tstate = state[::share_tile] ^ jnp.uint32(0x9E3779B1)
        _, sph_t = sampling.unit_sphere(tstate)
        sph = jnp.broadcast_to(sph_t[:, None, :],
                               (tiles, share_tile, 3)).reshape(-1, 3)
        # advance every lane once so per-lane streams stay decoupled from
        # the tile draw without a second generator
        state, _ = sampling.next_u32(state)
    if cosine_sampling:
        # cosine-weighted (RTiOW Lambertian): normalize(n + unit_sphere);
        # with throughput *= albedo this realizes f = albedo·cos/π
        if not sharing:
            state, sph = sampling.unit_sphere(state)
        v = normal + sph
        n2 = jnp.sum(v * v, axis=-1, keepdims=True)
        diffuse_dir = jnp.where(n2 > 1e-12, v / jnp.sqrt(jnp.maximum(n2, 1e-12)),
                                normal)
    elif sharing:
        # hemisphere flip of the shared sphere draw around each lane's
        # own normal (wgsl:211-214 semantics, shared base vector)
        sflip = jnp.sum(sph * normal, axis=-1, keepdims=True)
        diffuse_dir = sph * jnp.where(sflip >= 0.0, 1.0, -1.0)
    else:
        state, diffuse_dir = sampling.hemisphere(state, normal)
    specular_dir = reflect(unit_d, normal)
    s = jnp.clip(smoothness, 0.0, 1.0)[..., None]
    glossy_dir = diffuse_dir * (1.0 - s) + specular_dir * s

    # --- dielectric path ---------------------------------------------------
    # front_face: ray entering (dot(d, n) <= 0) per wgsl:243-247.
    front_face = jnp.sum(d * normal, axis=-1) <= 0.0
    ratio = jnp.where(front_face, 1.0 / IOR_GLASS, IOR_GLASS)
    cos_theta = jnp.minimum(jnp.sum(-unit_d * normal, axis=-1), 1.0)
    sin_theta = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_theta * cos_theta))
    cannot_refract = ratio * sin_theta > 1.0
    state, u = sampling.uniform(state)
    use_reflect = cannot_refract | (schlick_reflectance(cos_theta, ratio) > u)
    refr = refract(unit_d, normal, ratio[..., None])
    refl = reflect(unit_d, normal)
    dielectric_dir = jnp.where(use_reflect[..., None], refl, refr)

    new_dir = jnp.where(is_dielectric[..., None], dielectric_dir, glossy_dir)
    return state, new_dir, is_dielectric
