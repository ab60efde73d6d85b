"""Closest-hit intersection: pure-jnp oracle + backend dispatch.

The reference's intersection is a per-thread linear scan over all spheres
then all mesh triangles, keeping the closest hit
(shaders/ray_tracer.wgsl:149-185; sphere test :106-123, Möller–Trumbore
:125-147). Here it is a two-stage design:

  1. ``nearest_hit``: rays × primitives closest-hit search → per-ray
     ``(t, prim_id)``. Discrete, non-differentiable by construction (inputs
     are detached). Backends: the readable broadcast jnp oracle, or the
     culling Pallas kernel for the GPU (ops/pallas_intersect.py); the
     choice is made in ops/backend.py.
  2. ``hit_attributes``: gathers ONLY the winning primitive per ray and
     recomputes t / normal / material *differentiably*. O(rays), pure jnp.

This split is what makes the whole renderer differentiable without a custom
VJP through the search: the argmin index is detached (the standard
"detach discrete choices" treatment) while every continuous quantity is
recomputed from gathered primitive parameters, so gradients flow to sphere
centers/radii, triangle vertices, and material fields via the gather's
scatter-add transpose.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..scene import Scene
from .backend import resolve_backend

TRI_DET_EPS = 1e-6  # back-face / parallel cutoff (shaders/ray_tracer.wgsl:140)
# numpy scalar, NOT jnp: a jnp.float32() call materializes a device array,
# which would initialize the backend at import time
INF = np.float32(np.inf)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Hit:
    """Per-ray hit record (SoA analog of the WGSL Hit struct, wgsl:91-97)."""

    t: jax.Array                  # (R,)
    hit: jax.Array                # (R,) bool
    prim_id: jax.Array            # (R,) int32 winner id (detached; 0 on
                                  # miss — gate on .hit)
    point: jax.Array              # (R, 3)
    normal: jax.Array             # (R, 3) unit, outward (never flipped —
                                  # matches wgsl sphere/tri normals)
    albedo: jax.Array             # (R, 3)
    emission: jax.Array           # (R, 3)
    emission_strength: jax.Array  # (R,)
    smoothness: jax.Array         # (R,)


# ---------------------------------------------------------------------------
# Stage 1: closest-hit search (oracle backend)
# ---------------------------------------------------------------------------

def sphere_ts(scene: Scene, o, d, t_min):
    """All ray-sphere hit distances, +inf on miss. (R, S).

    Near-root-only quadratic, exactly like wgsl:106-123 (no far root, no
    outward-normal flip), plus the t_min epsilon (deviation D2).
    """
    oc = o[:, None, :] - scene.sphere_center[None, :, :]        # (R, S, 3)
    a = jnp.sum(d * d, axis=-1)[:, None]                         # (R, 1)
    b = 2.0 * jnp.sum(oc * d[:, None, :], axis=-1)               # (R, S)
    c = jnp.sum(oc * oc, axis=-1) - scene.sphere_radius[None, :] ** 2
    disc = b * b - 4.0 * a * c
    t = (-b - jnp.sqrt(jnp.maximum(disc, 0.0))) / (2.0 * a)
    valid = (disc >= 0.0) & (t >= t_min) & (scene.sphere_valid[None, :] > 0.5)
    return jnp.where(valid, t, INF)


def triangle_ts(scene: Scene, o, d, t_min):
    """All ray-triangle hit distances, +inf on miss. (R, T).

    Möller–Trumbore in the cross/determinant form of wgsl:125-147: accepts
    det >= 1e-6 (back-face culled) and u, v, w >= 0.
    """
    e1 = scene.tri_v1 - scene.tri_v0                             # (T, 3)
    e2 = scene.tri_v2 - scene.tri_v0
    n = jnp.cross(e1, e2)                                        # (T, 3)
    ao = o[:, None, :] - scene.tri_v0[None, :, :]                # (R, T, 3)
    dao = jnp.cross(ao, d[:, None, :])                           # (R, T, 3)
    det = -jnp.sum(d[:, None, :] * n[None, :, :], axis=-1)       # (R, T)
    inv = 1.0 / det
    t = jnp.sum(ao * n[None, :, :], axis=-1) * inv
    u = jnp.sum(e2[None, :, :] * dao, axis=-1) * inv
    v = -jnp.sum(e1[None, :, :] * dao, axis=-1) * inv
    w = 1.0 - u - v
    valid = (
        (det >= TRI_DET_EPS) & (t >= t_min)
        & (u >= 0.0) & (v >= 0.0) & (w >= 0.0)
        & (scene.tri_valid[None, :] > 0.5)
    )
    return jnp.where(valid, t, INF)


def nearest_hit_jnp(scene: Scene, o, d, t_min):
    """Oracle closest-hit: returns (t (R,), prim_id (R,) int32).

    prim_id in [0, S_pad) = sphere index; [S_pad, S_pad+T_pad) = triangle
    index + S_pad; t = +inf encodes a miss.
    """
    ts = sphere_ts(scene, o, d, t_min)
    tt = triangle_ts(scene, o, d, t_min)
    all_t = jnp.concatenate([ts, tt], axis=1)
    prim_id = jnp.argmin(all_t, axis=1).astype(jnp.int32)
    best_t = jnp.min(all_t, axis=1)
    return best_t, prim_id


# ---------------------------------------------------------------------------
# Stage 2: differentiable winner recompute
# ---------------------------------------------------------------------------

def _safe_normalize(v, eps=1e-24):
    """Normalize with NaN-free gradients at ||v|| → 0 (double-where on the
    squared norm so the backward of rsqrt never sees 0)."""
    sq = jnp.sum(v * v, axis=-1, keepdims=True)
    ok = sq > eps
    inv = jax.lax.rsqrt(jnp.where(ok, sq, 1.0))
    return jnp.where(ok, v * inv, v)


def _pack_attrs(scene: Scene):
    """(S+T, 26|40) row-packed primitive attributes, indexed directly by
    prim_id: rows [0, S) are spheres (12 used columns, zero-padded), rows
    [S, S+T) are triangles. One table means the winner recompute costs one
    gather per ray, and its VJP transpose one scatter-add per bounce.
    Scene-only → hoisted out of the bounce scan by XLA.

    Sphere columns: 0:3 center, 3 radius², 4:7 albedo, 7:10 emission,
    10 strength, 11 smoothness.
    Triangle columns: 0:3 v0, 3:6 e1, 6:9 e2, 9:18 n0/n1/n2, 18:21 albedo,
    21:24 emission, 24 strength, 25 smoothness; textured scenes append
    26:32 uv0/uv1/uv2, 32:38 tan/bitan, 38 tex id, 39 ntex id.
    """
    width = 40 if scene.num_textures else 26
    sp = jnp.concatenate([
        scene.sphere_center, (scene.sphere_radius ** 2)[:, None],
        scene.sphere_albedo, scene.sphere_emission,
        scene.sphere_emission_strength[:, None],
        scene.sphere_smoothness[:, None],
    ], axis=1)
    sp = jnp.pad(sp, ((0, 0), (0, width - sp.shape[1])))
    cols = [
        scene.tri_v0, scene.tri_v1 - scene.tri_v0,
        scene.tri_v2 - scene.tri_v0,
        scene.tri_n0, scene.tri_n1, scene.tri_n2,
        scene.tri_albedo, scene.tri_emission,
        scene.tri_emission_strength[:, None],
        scene.tri_smoothness[:, None],
    ]
    if scene.num_textures:
        cols += [scene.tri_uv0, scene.tri_uv1, scene.tri_uv2,
                 scene.tri_tan, scene.tri_bitan,
                 scene.tri_tex[:, None].astype(jnp.float32),
                 scene.tri_ntex[:, None].astype(jnp.float32)]
    tp = jnp.concatenate(cols, axis=1)
    tp = jnp.pad(tp, ((0, 0), (0, width - tp.shape[1])))
    return jnp.concatenate([sp, tp], axis=0)


def _textured_shading(textures, albedo, normal, uv, tex, ntex, tan, bitan,
                      with_normal_maps=True, live=None):
    """Texture-map the shading attributes of rays whose winner carries
    texture ids: modulate albedo by the base-color map and rotate the
    normal by the tangent-frame normal map. ``tex``/``ntex`` = -1 lanes
    pass through unchanged (sample_bilinear returns white).
    ``with_normal_maps=False`` (static, from scene.num_normal_maps) elides
    the second texture fetch entirely. ``live`` ((R,) bool or None) gates
    the fetches to live ray tiles (sample_bilinear_gated); dead-tile lanes
    keep the untextured attributes, which are unused."""
    from ..texture import decode_normal_map, sample_bilinear_gated
    albedo = albedo * sample_bilinear_gated(textures, tex, uv, live)
    if with_normal_maps:
        nm = decode_normal_map(sample_bilinear_gated(textures, ntex, uv,
                                                     live))
        n_mapped = _safe_normalize(
            nm[:, 0:1] * tan + nm[:, 1:2] * bitan + nm[:, 2:3] * normal)
        normal = jnp.where((ntex >= 0)[:, None], n_mapped, normal)
    return albedo, normal


def _norm3(x, y, z, eps=1e-24):
    """Safe normalize on (R,) components (same math as _safe_normalize)."""
    sq = (x * x + y * y) + z * z
    ok = sq > eps
    inv = jax.lax.rsqrt(jnp.where(ok, sq, 1.0))
    return (jnp.where(ok, x * inv, x), jnp.where(ok, y * inv, y),
            jnp.where(ok, z * inv, z))


def _cross3(ax, ay, az, bx, by, bz):
    return (ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx)


def hit_attributes(scene: Scene, o, d, prim_id, miss, t_min):
    """Gather the winning primitive and recompute the hit differentiably.

    Args:
      scene: Scene pytree (differentiable leaves).
      o, d: ray origins/dirs (R, 3).
      prim_id: winner indices from stage 1 (detached ints).
      miss: (R,) bool, True where no primitive was hit.
      t_min: epsilon (only used to keep recomputed t consistent).

    Returns: Hit.

    ONE merged-table gather per ray (and one scatter-add in its VJP
    transpose): each ray reads its winner's row. The recompute runs on
    rank-1 (R,) components and stacks the Hit fields back to (R, 3) only
    at the end.

    Both the sphere and triangle recomputes run on every row,
    reinterpreting the columns per their type, and the per-type results are
    where-selected by prim_id. Cross-type garbage is fine: every recompute
    is double-where NaN-safe, and `where` zeroes the unselected branch's
    cotangents so no gradient flows through a misread column. Miss lanes
    (primitive 0's row) get t = 0 and are masked downstream via
    ``Hit.hit``.
    """
    S = scene.padded_spheres
    rows = _pack_attrs(scene)[
        jnp.clip(prim_id, 0, S + scene.padded_tris - 1)].T  # (26|40, R)
    is_tri = prim_id >= S
    ox, oy, oz = o[:, 0], o[:, 1], o[:, 2]
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]

    # --- sphere recompute (wgsl:106-123) ---------------------------------
    # NaN-safe for autodiff: lanes that actually missed (masked downstream)
    # still run this recompute, and d/dx sqrt(max(x,0)) at x<=0 is inf*0=NaN
    # which `where` masking does NOT stop in the backward pass. The standard
    # double-where makes the untaken branch differentiate a benign constant.
    cx, cy, cz = rows[0], rows[1], rows[2]
    r2 = rows[3]                        # radius SQUARED
    ocx, ocy, ocz = ox - cx, oy - cy, oz - cz
    a = (dx * dx + dy * dy) + dz * dz
    b = 2.0 * ((ocx * dx + ocy * dy) + ocz * dz)
    cc = ((ocx * ocx + ocy * ocy) + ocz * ocz) - r2
    disc = b * b - 4.0 * a * cc
    disc_ok = disc > 0.0
    safe_disc = jnp.where(disc_ok, disc, 1.0)
    t_sphere = (-b - jnp.where(disc_ok, jnp.sqrt(safe_disc), 0.0)) / (2.0 * a)
    psx = ox + dx * t_sphere
    psy = oy + dy * t_sphere
    psz = oz + dz * t_sphere
    nsx, nsy, nsz = _norm3(psx - cx, psy - cy, psz - cz)

    # --- triangle recompute (wgsl:125-147) --------------------------------
    v0x, v0y, v0z = rows[0], rows[1], rows[2]
    e1x, e1y, e1z = rows[3], rows[4], rows[5]
    e2x, e2y, e2z = rows[6], rows[7], rows[8]
    ngx, ngy, ngz = _cross3(e1x, e1y, e1z, e2x, e2y, e2z)
    aox, aoy, aoz = ox - v0x, oy - v0y, oz - v0z
    dax, day, daz = _cross3(aox, aoy, aoz, dx, dy, dz)
    det = -((dx * ngx + dy * ngy) + dz * ngz)
    inv = 1.0 / jnp.where(jnp.abs(det) < 1e-20, 1e-20, det)
    t_tri = ((aox * ngx + aoy * ngy) + aoz * ngz) * inv
    u = ((e2x * dax + e2y * day) + e2z * daz) * inv
    v = -((e1x * dax + e1y * day) + e1z * daz) * inv
    w = 1.0 - u - v
    nbx = rows[9] * w + rows[12] * u + rows[15] * v
    nby = rows[10] * w + rows[13] * u + rows[16] * v
    nbz = rows[11] * w + rows[14] * u + rows[17] * v
    ntx, nty, ntz = _norm3(nbx, nby, nbz)

    # --- UV/texture shading (extension; static no-op when untextured) ----
    tax, tay, taz = rows[18], rows[19], rows[20]
    if scene.num_textures:
        # the texture sampler works on row-major (R, ·) arrays. Liveness
        # (= not-miss: the kernel marks dead-on-entry lanes as misses)
        # gates the fetch to live ray tiles.
        uv = jnp.stack([rows[26] * w + rows[28] * u + rows[30] * v,
                        rows[27] * w + rows[29] * u + rows[31] * v],
                       axis=-1)
        tri_albedo_r, n_tri_r = _textured_shading(
            scene.textures,
            jnp.stack([tax, tay, taz], axis=-1),
            jnp.stack([ntx, nty, ntz], axis=-1), uv,
            rows[38].astype(jnp.int32), rows[39].astype(jnp.int32),
            rows[32:35].T, rows[35:38].T,
            with_normal_maps=scene.num_normal_maps > 0,
            live=jnp.logical_not(miss))
        tax, tay, taz = (tri_albedo_r[:, 0], tri_albedo_r[:, 1],
                         tri_albedo_r[:, 2])
        ntx, nty, ntz = n_tri_r[:, 0], n_tri_r[:, 1], n_tri_r[:, 2]

    # --- select ------------------------------------------------------------
    t = jnp.where(miss, 0.0, jnp.where(is_tri, t_tri, t_sphere))
    normal = jnp.stack([jnp.where(is_tri, ntx, nsx),
                        jnp.where(is_tri, nty, nsy),
                        jnp.where(is_tri, ntz, nsz)], axis=-1)
    point = o + d * t[:, None]
    albedo = jnp.stack([jnp.where(is_tri, tax, rows[4]),
                        jnp.where(is_tri, tay, rows[5]),
                        jnp.where(is_tri, taz, rows[6])], axis=-1)
    emission = jnp.stack([jnp.where(is_tri, rows[21], rows[7]),
                          jnp.where(is_tri, rows[22], rows[8]),
                          jnp.where(is_tri, rows[23], rows[9])], axis=-1)
    emission_strength = jnp.where(is_tri, rows[24], rows[10])
    smoothness = jnp.where(is_tri, rows[25], rows[11])

    hit = jnp.logical_not(miss)
    return Hit(
        t=t, hit=hit, prim_id=jax.lax.stop_gradient(prim_id), point=point,
        normal=normal, albedo=albedo,
        emission=emission, emission_strength=emission_strength,
        smoothness=smoothness,
    )


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------

def occluded(scene: Scene, o, d, t_min=1e-4, backend: str = "jnp",
             alive=None, interpret: bool = False):
    """Shadow query: True where some primitive blocks the segment o → o+d
    (a hit at t < 1-ε in units of |d|). The kernel backend runs the
    any-hit variant (first hit settles a ray); the oracle runs a full
    closest-hit. Non-differentiable by design (visibility gradients need
    edge sampling, grad/edges.py)."""
    o_s, d_s = jax.lax.stop_gradient(o), jax.lax.stop_gradient(d)
    scene_s = jax.lax.stop_gradient(scene)
    if resolve_backend(backend) == "pallas":
        from .pallas_intersect import anyhit_pallas
        return anyhit_pallas(scene_s, o_s, d_s, t_min, t_max=1.0 - 1e-3,
                             alive=alive, interpret=interpret)
    best_t, _ = nearest_hit_jnp(scene_s, o_s, d_s, t_min)
    return best_t < (1.0 - 1e-3)


def intersect(scene: Scene, o, d, t_min=1e-4, backend: str = "jnp",
              alive=None, interpret: bool = False) -> Hit:
    """Full closest-hit query → Hit. ``backend``: "jnp" | "pallas" | "auto"
    (ops/backend.py).

    ``alive`` ((R,) bool, optional): wavefront liveness. The kernel skips
    dead rays; the jnp oracle is fully vectorized and ignores it (dead
    lanes' results are masked downstream either way). Both backends share
    the differentiable winner recompute (hit_attributes).
    """
    o_s, d_s = jax.lax.stop_gradient(o), jax.lax.stop_gradient(d)
    scene_s = jax.lax.stop_gradient(scene)
    if resolve_backend(backend) == "pallas":
        from .pallas_intersect import nearest_hit_pallas
        best_t, prim_id = nearest_hit_pallas(scene_s, o_s, d_s, t_min,
                                             alive=alive,
                                             interpret=interpret)
    else:
        best_t, prim_id = nearest_hit_jnp(scene_s, o_s, d_s, t_min)
    miss = jnp.isinf(best_t)
    return hit_attributes(scene, o, d, prim_id, miss, t_min)
