"""Explicit light sampling (next-event estimation).

An extension beyond the reference (which only finds light by randomly
scattering into it — shaders/ray_tracer.wgsl:271; BASELINE config 4 names
NEE as a target capability). Defaults OFF (`RenderParams.nee`) so reference
behavior is untouched.

Estimator consistency: the reference's implicit transport multiplies
throughput by albedo per bounce while scattering along
``dir = (1-s)·h + s·reflect`` with h a hemisphere sample — i.e. an
effective BRDF f(ω) = albedo · p_lobe(ω), where p_lobe is the scatter
direction's solid-angle density. NEE here integrates THE SAME f over the
light's solid angle using the closed-form p_lobe (``glossy_mix_pdf``), so
enabling NEE reduces variance without changing the converged image at
EVERY smoothness s < 1: at s=0 p_lobe is the hemisphere density (1/2π
uniform, cos/π with ``RenderParams.cosine_sampling``), and for glossy
blends it is the exact pushforward of that density through the lerp.
Perfect mirrors (s=1, a delta lobe) keep pure BSDF sampling.

Double-count suppression: when a bounce performed NEE, emission found by
the NEXT BSDF segment is not counted again (dielectric lanes can't NEE, so
their specular paths still pick up emission). Light table is a fixed-size
(MAX_LIGHTS) pytree selected by emitted power — fully static shapes. In
scenes with more than MAX_LIGHTS emitters, the overflow emitters are never
NEE-sampled, so the renderer suppresses only emitters present in the table
(``entry_valid`` + prim-id match in renderer.bounce) — light from the
overflow ones still arrives via BSDF sampling and the converged image is
unchanged.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from . import sampling
from .scene import Scene

MAX_LIGHTS = 16
TWO_PI = np.float32(2.0 * np.pi)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class LightTable:
    """Fixed-size emitter table.

    ``packed`` carries EVERYTHING a lane needs about its sampled light in
    one (L, 20) array: [p_light | area | emission(3) | prim_id | is_tri |
    center(3) | radius | v0(3) | v1(3) | v2(3)]. Per-lane selection is a
    one-hot (R, L) @ (L, 20) contraction instead of R-row gathers, and the
    contraction's VJP is a matmul (onehot^T @ g) rather than a
    scatter-add.
    """
    packed: jax.Array     # (L, 20) see above
    prim_id: jax.Array    # (L,) global prim id (for emission suppression)
    cdf: jax.Array        # (L,) normalized inclusive power CDF
    has_lights: jax.Array # () bool
    entry_valid: jax.Array  # (L,) bool: entry is a real (power > 0) emitter


def build_light_table(scene: Scene) -> LightTable:
    """Select the MAX_LIGHTS highest-power emitters (jnp; hoisted by XLA)."""
    SP = scene.padded_spheres
    # prim ids round-trip through an f32 column in the packed table —
    # exact only below 2^24; a bigger scene would silently corrupt NEE
    # self-hit exclusion (padded counts are static, so this is trace-time)
    if SP + scene.padded_tris >= 2 ** 24:
        raise ValueError(
            f"scene too large for NEE light table: {SP + scene.padded_tris}"
            f" prim ids exceed f32-exact integer range (2^24)")
    s_pow_mask = (scene.sphere_valid > 0.5) & (scene.sphere_emission_strength > 0.0)
    s_area = 4.0 * np.pi * scene.sphere_radius ** 2
    s_emit = scene.sphere_emission * scene.sphere_emission_strength[:, None]
    s_power = jnp.where(s_pow_mask, jnp.mean(s_emit, 1) * s_area, 0.0)

    e1 = scene.tri_v1 - scene.tri_v0
    e2 = scene.tri_v2 - scene.tri_v0
    t_area = 0.5 * jnp.linalg.norm(jnp.cross(e1, e2), axis=-1)
    t_pow_mask = (scene.tri_valid > 0.5) & (scene.tri_emission_strength > 0.0)
    t_emit = scene.tri_emission * scene.tri_emission_strength[:, None]
    t_power = jnp.where(t_pow_mask, jnp.mean(t_emit, 1) * t_area, 0.0)

    power = jnp.concatenate([s_power, t_power])
    emit = jnp.concatenate([s_emit, t_emit])
    area = jnp.concatenate([s_area, t_area])
    n = power.shape[0]
    top = jax.lax.top_k(power, min(MAX_LIGHTS, n))[1]
    top_power = power[top]
    kind = (top >= SP).astype(jnp.int32)
    index = jnp.where(top >= SP, top - SP, top).astype(jnp.int32)

    total = jnp.sum(top_power)
    has = total > 0.0
    cdf = jnp.cumsum(top_power) / jnp.where(has, total, 1.0)
    cdf_prev = jnp.concatenate([jnp.zeros((1,), cdf.dtype), cdf[:-1]])

    # resolve per-light geometry at build time (L rows — these gathers
    # are tiny and hoisted per scene); prim ids stay f32-exact < 2^24
    sidx = jnp.where(top >= SP, 0, top)
    tidx = jnp.where(top >= SP, top - SP, 0)
    packed = jnp.concatenate([
        (cdf - cdf_prev)[:, None],                 # 0  p_light
        area[top][:, None],                        # 1
        emit[top],                                 # 2:5  emission
        top.astype(jnp.float32)[:, None],          # 5  prim_id
        kind.astype(jnp.float32)[:, None],         # 6  is_tri
        scene.sphere_center[sidx],                 # 7:10
        scene.sphere_radius[sidx][:, None],        # 10
        scene.tri_v0[tidx],                        # 11:14
        scene.tri_v1[tidx],                        # 14:17
        scene.tri_v2[tidx],                        # 17:20
    ], axis=1)
    return LightTable(packed=packed, prim_id=top.astype(jnp.int32), cdf=cdf,
                      has_lights=has, entry_valid=top_power > 0.0)


def glossy_mix_pdf(wi_unit, refl, normal, s, cosine_sampling: bool):
    """Solid-angle pdf of the reference's glossy lerp lobe at direction
    ``wi_unit`` — the exact effective BRDF weight for NEE.

    The reference scatters ``dir = (1-s)·h + s·r`` (shaders/
    ray_tracer.wgsl:265-269; materials.scatter) with h a unit hemisphere
    sample (uniform 1/2π, or cosine cos/π) and r the unit mirror
    direction. The image of the unit h-sphere under that affine map is a
    sphere of radius (1-s) centered at s·r; projecting it radially onto
    directions gives a closed-form density. For a query direction ω with
    c = ω·r, points at t·ω on that sphere satisfy
        t² - 2·t·s·c + s² - (1-s)² = 0  →  t± = s·c ± √disc,
        disc = s²(c²-1) + (1-s)².
    Each real root t > 0 maps back to h = (t·ω - s·r)/(1-s) (unit by
    construction) and contributes (sphere-to-solid-angle Jacobian
    |h·ω| = √disc/(1-s), area scale (1-s)²):
        p(ω) += p_h(h) · t² / ((1-s)·√disc)       if h·n > 0.
    Both roots can be live when s > 1/2 (the origin falls outside the
    lobe sphere). At s = 0 this reduces exactly to p_h(ω); as s → 1 the
    lobe tends to a delta at r (callers exclude s = 1; the
    nee_smoothness_cutoff knob exists for *variance* control near 1 —
    with this pdf NEE is unbiased at every s < 1).

    Args: wi_unit (R,3) unit direction to the light point; refl (R,3)
    unit mirror direction; normal (R,3) unit shading normal; s (R,) in
    [0, 1); cosine_sampling: which hemisphere density h was drawn from.
    Returns (R,) pdf (0 where ω is outside the lobe's support).
    """
    c = jnp.sum(wi_unit * refl, axis=-1)
    one_s = jnp.maximum(1.0 - s, 1e-6)
    disc = s * s * (c * c - 1.0) + one_s * one_s
    sq = jnp.sqrt(jnp.maximum(disc, 1e-20))

    def root_contrib(sign):
        t = s * c + sign * sq
        h = (t[:, None] * wi_unit - s[:, None] * refl) / one_s[:, None]
        cos_hn = jnp.sum(h * normal, axis=-1)
        if cosine_sampling:
            p_h = jnp.maximum(cos_hn, 0.0) / np.pi
        else:
            p_h = jnp.where(cos_hn > 0.0, 1.0 / TWO_PI, 0.0)
        ok = t > 1e-6
        return jnp.where(ok, p_h * t * t / (one_s * sq), 0.0)

    pdf = root_contrib(1.0) + root_contrib(-1.0)
    return jnp.where(disc > 0.0, pdf, 0.0)


def sample_lights(lights: LightTable, scene: Scene, state, p):
    """Sample one light point per lane.

    Args:
      lights: LightTable. scene: unused (geometry now rides
      LightTable.packed; kept for call-site stability). state: (R,)
      uint32. p: (R, 3) hit points (shadow-ray origins).

    Returns (state, dict) with: wi (R,3) unnormalized direction to the light
    point, dist (R,), radiance (R,3) Le, inv_pdf_w (R,) solid-angle measure
    `area·|cos_l|/d² / P(light)`, light_prim (R,) global prim id, ok (R,)
    bool (a light was sampled and is front-facing).
    """
    L = lights.cdf.shape[0]
    state, u = sampling.uniform(state)
    # CDF inversion by compare-count (L is tiny)
    li = jnp.sum(u[:, None] > lights.cdf[None, :], axis=1).astype(jnp.int32)
    li = jnp.clip(li, 0, L - 1)
    # one-hot contraction replaces per-lane gathers (see LightTable).
    # precision="highest": a reduced-precision matmul (bf16, or TF32 on
    # the GPU) perturbs the packed vertex coords, pushing sampled light
    # points behind the emitter's own surface — every shadow ray then
    # self-occludes and NEE goes black (exact under f32).
    onehot = (li[:, None] == jnp.arange(L, dtype=jnp.int32)[None, :]
              ).astype(jnp.float32)                       # (R, L)
    row = jnp.matmul(onehot, lights.packed,
                     precision="highest")                 # (R, 20)
    p_light = row[:, 0]
    area = row[:, 1]
    radiance = row[:, 2:5]
    light_prim = row[:, 5].astype(jnp.int32)
    kind = row[:, 6]
    c, r = row[:, 7:10], row[:, 10]
    v0, v1, v2 = row[:, 11:14], row[:, 14:17], row[:, 17:20]

    # sphere light: uniform point on the surface
    state, sdir = sampling.unit_sphere(state)
    p_sphere = c + sdir * r[:, None]
    n_sphere = sdir

    # triangle light: uniform barycentric point
    state, u1 = sampling.uniform(state)
    state, u2 = sampling.uniform(state)
    su = jnp.sqrt(jnp.maximum(u1, 1e-12))
    b0 = 1.0 - su
    b1 = su * (1.0 - u2)
    b2 = su * u2
    p_tri = v0 * b0[:, None] + v1 * b1[:, None] + v2 * b2[:, None]
    ng = jnp.cross(v1 - v0, v2 - v0)
    n_tri = ng / jnp.maximum(jnp.linalg.norm(ng, axis=-1, keepdims=True), 1e-12)

    is_tri = kind > 0.5
    lp = jnp.where(is_tri[:, None], p_tri, p_sphere)
    ln = jnp.where(is_tri[:, None], n_tri, n_sphere)

    wi = lp - p
    d2 = jnp.sum(wi * wi, axis=-1)
    dist = jnp.sqrt(jnp.maximum(d2, 1e-20))
    wi_unit = wi / dist[:, None]
    # cos at the light: only points whose emitting face looks toward the
    # shading point contribute (back-face sphere samples would be blocked
    # by the light itself anyway; zeroing them here is identical and
    # cheaper — uniform-area sampling over the full sphere stays unbiased)
    cos_l = jnp.sum(-wi_unit * ln, axis=-1)
    front = cos_l > 1e-6

    inv_pdf_w = (area * jnp.abs(cos_l) / jnp.maximum(d2, 1e-20)
                 / jnp.maximum(p_light, 1e-12))
    ok = lights.has_lights & front & (p_light > 0.0)
    return state, dict(wi=wi, dist=dist, radiance=radiance,
                       inv_pdf_w=inv_pdf_w, light_prim=light_prim,
                       ok=ok)
