"""Wavefront path tracer: bounce-synchronous trace loop + progressive frames.

Replacement for the reference's per-pixel megakernel
(shaders/ray_tracer.wgsl:229-327) and the host frame orchestrator
(src/core/context.rs). Instead of one thread per pixel running its whole
path, ALL rays advance one bounce per step of a ``lax.scan``
(bounce-synchronous wavefront): each step is one intersection launch over
the whole wavefront (see ops/) plus masked elementwise shading. Dead rays are masked lanes — the reference's
``break`` on miss (wgsl:278) becomes an ``alive`` mask; the environment
contribution is added exactly once at the step a ray dies.

Radiance recurrence per bounce (wgsl:236-273):
    incoming   += emission * strength * throughput      (on hit)
    throughput *= albedo                                 (on hit; dielectric
                                                          forces white)
    incoming   += env(d) * throughput                    (on miss, skybox on)

Progressive accumulation follows wgsl:59-66 / context.rs:176-187:
    frame >= 1:  image = image * (1 - w) + frame_img * w,  w = 1/(frame + 1)
    else:        image = frame_img
with the host-side reset-to--1 semantics of ``clear_accumulation``
(src/core/context.rs:143-146).
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from . import materials, sampling
from .camera import Camera, CameraBasis, camera_basis, camera_rays
from .envlight import environment_light
from .lights import build_light_table, glossy_mix_pdf, sample_lights
from .ops.backend import resolve_backend
from .ops.intersect import intersect, occluded
from .scene import Scene
from .utils.config import RenderParams

_INV_2PI = 1.0 / (2.0 * np.pi)
_INV_PI = 1.0 / np.pi


def resolved_backend(params: RenderParams) -> str:
    return resolve_backend(params.backend)


# ---------------------------------------------------------------------------
# Wavefront compaction: spatial sort keys. Rays are reordered between
# bounces so the kernel's ray blocks stay coherent; radiance is scattered
# back to pixel slots at the end of the trace.
# ---------------------------------------------------------------------------

def _scene_aabb(scene: Scene):
    """(lo, hi) over valid primitives; jnp, hoisted by XLA per scene."""
    inf = jnp.inf
    sv = scene.sphere_valid[:, None] > 0.5
    slo = jnp.where(sv, scene.sphere_center - scene.sphere_radius[:, None], inf)
    shi = jnp.where(sv, scene.sphere_center + scene.sphere_radius[:, None], -inf)
    tv = scene.tri_valid[:, None] > 0.5
    pts_lo = [slo] + [jnp.where(tv, v, inf)
                      for v in (scene.tri_v0, scene.tri_v1, scene.tri_v2)]
    pts_hi = [shi] + [jnp.where(tv, v, -inf)
                      for v in (scene.tri_v0, scene.tri_v1, scene.tri_v2)]
    lo = jnp.min(jnp.concatenate(pts_lo, 0), axis=0)
    hi = jnp.max(jnp.concatenate(pts_hi, 0), axis=0)
    return lo, hi


def _spread8(x):
    """Interleave the low 8 bits of x with two zero bits (uint32)."""
    x = (x | (x << 8)) & jnp.uint32(0x00F00F)
    x = (x | (x << 4)) & jnp.uint32(0x0C30C3)
    x = (x | (x << 2)) & jnp.uint32(0x249249)
    return x


def _octant_order(d, alive):
    """O(R) stable counting-sort permutation by (alive, direction octant).

    Returns ``order`` such that ``x[order]`` groups live rays into 8
    direction-octant buckets (dead rays last), preserving pixel-block
    order within each bucket. Coherence this buys per 128-ray kernel tile:
    directions confined to a 90° cone AND origins still from adjacent
    pixel blocks (stability) — enough for cluster culling to engage on
    secondary bounces — at ~1/20 the cost of the Morton argsort path
    (cumsum + one scatter instead of a 2M-key sort).
    """
    R = d.shape[0]
    octant = ((d[:, 0] > 0).astype(jnp.int32)
              + ((d[:, 1] > 0).astype(jnp.int32) << 1)
              + ((d[:, 2] > 0).astype(jnp.int32) << 2))
    bucket = jnp.where(alive, octant, 8)                        # dead → last
    onehot = (bucket[None, :] == jnp.arange(9)[:, None]).astype(jnp.int32)
    within = jnp.cumsum(onehot, axis=1) - 1                     # (9, R)
    counts = within[:, -1] + 1
    offsets = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), jnp.cumsum(counts)[:-1]])
    pos = (jnp.sum(onehot * (offsets[:, None] + within), axis=0)
           .astype(jnp.int32))                                  # new slot
    return jnp.zeros((R,), jnp.int32).at[pos].set(
        jnp.arange(R, dtype=jnp.int32))


def _ray_sort_key(lo, hi, o, d, alive):
    """uint32 sort key: dead rays to the back; live rays grouped by 24-bit
    Morton cell of the ORIGIN first, direction octant last. Origin-major
    matters: the kernel's cluster culling keys off where rays start (the
    entering-cluster span), so origin locality per 128-ray tile is what
    buys skipped chunks; octant-major ordering scatters origins from the
    whole frame into each tile (measured 2× slower)."""
    ext = jnp.maximum(hi - lo, 1e-12)
    q = jnp.clip((o - lo) / ext * 255.0, 0.0, 255.0).astype(jnp.uint32)
    morton = ((_spread8(q[:, 0]) << 2) | (_spread8(q[:, 1]) << 1)
              | _spread8(q[:, 2]))
    octant = ((d[:, 0] > 0).astype(jnp.uint32)
              | ((d[:, 1] > 0).astype(jnp.uint32) << 1)
              | ((d[:, 2] > 0).astype(jnp.uint32) << 2))
    key = (morton << 3) | octant
    return jnp.where(alive, key, jnp.uint32(0xFFFFFFFF))


def trace(scene: Scene, o, d, state, params: RenderParams):
    """Trace a wavefront of rays to completion.

    Args:
      scene: Scene pytree.
      o, d: (R, 3) ray origins / (unnormalized) directions.
      state: (R,) uint32 RNG states.
      params: static RenderParams.

    Returns: (state, radiance (R, 3)).
    """
    R = o.shape[0]
    compaction = params.compaction
    if compaction is True:
        compaction = "morton"
    compacting = bool(compaction) and resolved_backend(params) == "pallas"
    if compacting and compaction == "morton":
        aabb_lo, aabb_hi = _scene_aabb(scene)
    if params.nee:
        light_table = build_light_table(scene)
    # Initial carries are derived from the ray arrays (o * 0) rather than
    # fresh constants so that under shard_map they inherit the rays'
    # varying-axes type (lax.scan requires carry-in/out types to match);
    # XLA constant-folds the arithmetic.
    zero3 = o * 0.0
    slot = state * 0 + jnp.arange(R, dtype=jnp.uint32)  # original ray slot
    all_true = zero3[:, 0] == 0.0
    # Scan carries are rank-1 components, not (R, 3) arrays; the (R, 3)
    # views are reassembled inside the body, where fusion keeps them
    # unmaterialized. Stack/slice round-trips are exact — images are
    # bit-identical (test-pinned).
    def _split3(v):
        return (v[:, 0], v[:, 1], v[:, 2])

    init = (
        *_split3(o), *_split3(d),
        *_split3(zero3 + 1.0),            # throughput (ray_color, wgsl:231)
        *_split3(zero3),                  # incoming light
        all_true,                         # alive
        all_true,                         # emission_ok (NEE double-count guard)
        zero3[:, 0],                      # prev_pdf: BSDF pdf of the previous
                                          # scatter direction (MIS weight input;
                                          # constant-folded away when nee off)
        state,
        slot,
    )

    def bounce(carry, seg_index):
        (ox, oy, oz, dx, dy, dz, tpx, tpy, tpz, inx, iny, inz, alive,
         emission_ok, prev_pdf, state, slot) = carry
        o = jnp.stack([ox, oy, oz], axis=-1)
        d = jnp.stack([dx, dy, dz], axis=-1)
        throughput = jnp.stack([tpx, tpy, tpz], axis=-1)
        incoming = jnp.stack([inx, iny, inz], axis=-1)
        if compacting:
            # wavefront compaction: reorder so kernel tiles stay coherent
            # and dead rays collapse into whole tiles the kernel skips
            if compaction == "morton":
                order = jnp.argsort(
                    _ray_sort_key(aabb_lo, aabb_hi, o, d, alive))
            else:  # "octant": O(R) counting sort, no argsort
                order = _octant_order(d, alive)
            (o, d, throughput, incoming, alive, emission_ok, prev_pdf,
             state, slot) = (
                x[order] for x in (o, d, throughput, incoming, alive,
                                   emission_ok, prev_pdf, state, slot))
        h = intersect(scene, o, d, t_min=params.t_min, backend=params.backend,
                      alive=alive, interpret=params.interpret)
        active_hit = alive & h.hit
        active_miss = alive & ~h.hit

        # Scatter every lane (branchless); only active-hit lanes keep results.
        if params.coherent_scatter:
            # coherent_tile=0 matches the kernel's ray block, so each
            # block of the secondary wavefront carries one direction cone;
            # see RenderParams.coherent_tile for the variance tradeoff
            share = params.coherent_tile
            if share == 0:
                from .ops.pallas_intersect import RB
                share = RB
        else:
            share = 0
        state, new_dir, is_dielectric = materials.scatter(
            state, d, h.normal, h.smoothness,
            cosine_sampling=params.cosine_sampling,
            share_tile=share)

        # Dielectric forces white albedo (wgsl:241).
        albedo = jnp.where(is_dielectric[:, None], 1.0, h.albedo)

        emitted = h.emission * h.emission_strength[:, None]
        if params.nee and params.mis:
            # Balance-heuristic MIS (BSDF side): the previous segment's
            # NEE attempt competed for this same emitter, so BSDF-found
            # emission is weighted by p_bsdf/(p_bsdf + p_nee) instead of
            # being fully suppressed. p_nee is the solid-angle pdf the
            # light sampler WOULD have had for this exact hit point:
            # P(light)·d² / (area·cos_l), recomputed from the SAME packed
            # table geometry sample_lights draws from (exact weight-sum-
            # to-1 needs both strategies' pdfs in the same measure).
            # Lanes whose previous segment did NOT attempt NEE
            # (emission_ok), and emitters NEE cannot reach (not in the
            # table, back-facing, zero power → p_nee = 0), get weight 1.
            onehot_hit = ((h.prim_id[:, None] == light_table.prim_id[None, :])
                          & light_table.entry_valid[None, :]
                          ).astype(jnp.float32)           # (R, L)
            row = jnp.matmul(onehot_hit, light_table.packed,
                             precision="highest")          # (R, 20)
            p_light, area_l, kind_l = row[:, 0], row[:, 1], row[:, 6]
            d_unit = d / jnp.maximum(
                jnp.linalg.norm(d, axis=-1, keepdims=True), 1e-12)
            # emitter geometric normal, exactly as sample_lights builds it
            ng_l = jnp.cross(row[:, 14:17] - row[:, 11:14],
                             row[:, 17:20] - row[:, 11:14])
            n_tri_l = ng_l / jnp.maximum(
                jnp.linalg.norm(ng_l, axis=-1, keepdims=True), 1e-12)
            n_sph_l = (h.point - row[:, 7:10]) / jnp.maximum(
                row[:, 10], 1e-12)[:, None]
            ln = jnp.where((kind_l > 0.5)[:, None], n_tri_l, n_sph_l)
            cos_l = jnp.sum(-d_unit * ln, axis=-1)
            wi_h = h.point - o
            d2h = jnp.sum(wi_h * wi_h, axis=-1)
            reachable = (cos_l > 1e-6) & (p_light > 0.0)
            p_nee_hit = jnp.where(
                reachable,
                p_light * d2h / jnp.maximum(area_l * cos_l, 1e-20), 0.0)
            w_b = jnp.where(emission_ok, 1.0,
                            prev_pdf / jnp.maximum(prev_pdf + p_nee_hit,
                                                   1e-20))
            incoming = incoming + jnp.where(
                active_hit[:, None], emitted * throughput * w_b[:, None],
                0.0)
        else:
            if params.nee:
                # Pure-suppression estimator (mis=False). Suppression only
                # applies to emitters the light table can actually sample:
                # the table holds the top MAX_LIGHTS emitters by power, and
                # a scene with more would otherwise lose all light from the
                # overflow emitters (never NEE-sampled, yet BSDF-
                # suppressed).
                in_table = jnp.any(
                    (h.prim_id[:, None] == light_table.prim_id[None, :])
                    & light_table.entry_valid[None, :], axis=1)
                count_emission = active_hit & (emission_ok | ~in_table)
            else:
                count_emission = active_hit
            incoming = incoming + jnp.where(
                count_emission[:, None], emitted * throughput, 0.0)

        if params.nee:
            # Next-event estimation: sample a light + shadow ray, add the
            # direct term under the SAME implicit BRDF as path scattering
            # (see lights.py docstring), then suppress the next segment's
            # BSDF-found emission on lanes that just did NEE.
            state, ls = sample_lights(light_table, scene, state, h.point)
            wi_unit = ls["wi"] / jnp.maximum(ls["dist"], 1e-12)[:, None]
            # No NEE at the deepest vertex: its direct term stands in for
            # the NEXT BSDF segment, which the depth budget would never
            # trace — sampling it would add a bounce of light the
            # BSDF-only estimator cannot see (depth-parity bias).
            not_last = seg_index < params.bounces
            # `attempted` = lanes whose direct integral NEE now owns. A
            # back-facing / occluded sample is a legitimate ZERO-valued
            # sample of that integral — those lanes must STILL suppress
            # the next BSDF emission, else direct light is double-counted
            # (~1.7x bright, measured).
            # The effective BRDF at the light direction is EXACT for every
            # glossy blend s < 1: albedo · pdf of the reference's lerp
            # lobe (lights.glossy_mix_pdf; reduces to the diffuse form at
            # s=0). The cutoff therefore only controls VARIANCE — lanes at
            # s >= cutoff (near-mirror: area-sampled NEE is noisy inside a
            # tight lobe) keep pure BSDF sampling, which is also unbiased.
            nee_material = h.smoothness < params.nee_smoothness_cutoff
            attempted = (active_hit & ~is_dielectric & nee_material
                         & not_last & light_table.has_lights)
            # NO shading-side cos gate here (r4 bias fix): the implicit
            # BRDF is albedo * p_lobe(omega) and p_lobe (pdf_l below) is
            # the EXACT reachability — it already vanishes where the lerp
            # lobe can't go. A cos(shading normal) > 0 gate is only valid
            # for physical BRDFs; the reference's hand-authored room
            # normals tilt AWAY from the light on whole walls while the
            # lobe (via its reflect component) still reaches it — the
            # gate zeroed NEE there while suppressing/down-weighting the
            # live BSDF path: measured 7% total image energy loss on the
            # room scene, both with and without MIS (tests pin the fix).
            unit_in = d / jnp.maximum(
                jnp.linalg.norm(d, axis=-1, keepdims=True), 1e-12)
            refl = materials.reflect(unit_in, h.normal)
            pdf_l = glossy_mix_pdf(wi_unit, refl, h.normal,
                                   jnp.clip(h.smoothness, 0.0, 1.0),
                                   params.cosine_sampling)
            # pdf_l == 0 lanes contribute zero whatever the occlusion —
            # keep them out of the any-hit query so their shadow lanes
            # (and on coherent tiles, whole shadow TILES) go dead
            nee_lane = attempted & ls["ok"] & (pdf_l > 0.0)
            blocked = occluded(scene, h.point, ls["wi"], t_min=params.t_min,
                               backend=params.backend, alive=nee_lane,
                               interpret=params.interpret)
            brdf = albedo * pdf_l[:, None]
            direct = brdf * ls["radiance"] * ls["inv_pdf_w"][:, None]
            if params.mis:
                # Balance-heuristic MIS (NEE side): weight the light
                # sample by p_nee/(p_nee + p_bsdf). inv_pdf_w = 1/p_nee,
                # so w_l = 1/(1 + p_bsdf·inv_pdf_w) — no division by the
                # light pdf needed.
                w_l = 1.0 / (1.0 + pdf_l * ls["inv_pdf_w"])
                direct = direct * w_l[:, None]
                # BSDF pdf of the sampled scatter direction — the weight
                # input for the NEXT segment's emission (the other half of
                # the estimator pair). Only attempted lanes carry it;
                # non-attempted lanes keep weight 1 via emission_ok.
                nd_unit = new_dir / jnp.maximum(
                    jnp.linalg.norm(new_dir, axis=-1, keepdims=True),
                    1e-12)
                pdf_scatter = glossy_mix_pdf(
                    nd_unit, refl, h.normal,
                    jnp.clip(h.smoothness, 0.0, 1.0 - 1e-6),
                    params.cosine_sampling)
                prev_pdf = jnp.where(attempted, pdf_scatter, 0.0)
            incoming = incoming + jnp.where(
                (nee_lane & ~blocked)[:, None], direct * throughput, 0.0)
            emission_ok = ~attempted
        throughput = jnp.where(active_hit[:, None], throughput * albedo, throughput)

        if params.skybox:
            incoming = incoming + jnp.where(
                active_miss[:, None], environment_light(d) * throughput, 0.0)

        o = jnp.where(active_hit[:, None], h.point, o)
        d = jnp.where(active_hit[:, None], new_dir, d)
        alive = active_hit
        if params.rr_start:
            # Russian roulette (extension; params.rr_start=0 keeps the
            # reference transport bitwise — no draw, no stream change).
            # Survival p = max-channel throughput clamped to [0.05, 1];
            # survivors divide by p, so the estimator stays unbiased while
            # dim paths die early, and whole dead ray blocks cost the
            # kernel almost nothing.
            state, u_rr = sampling.uniform(state)
            p_surv = jnp.clip(jnp.max(throughput, axis=-1), 0.05, 1.0)
            rr_on = seg_index >= params.rr_start
            kill = rr_on & (u_rr >= p_surv)
            boost = jnp.where(rr_on & ~kill, 1.0 / p_surv, 1.0)
            throughput = throughput * boost[:, None]
            alive = alive & ~kill
        return (*_split3(o), *_split3(d), *_split3(throughput),
                *_split3(incoming), alive, emission_ok, prev_pdf,
                state, slot), None

    # Inclusive loop: bounces+1 segments, matching `i <= number_of_bounces`
    # (wgsl:233; SURVEY quirk Q3 — kept, it defines the reference's look).
    bounce_fn = jax.checkpoint(bounce) if params.remat else bounce
    (*_, inx, iny, inz, alive, emission_ok, prev_pdf, state, slot), _ = \
        jax.lax.scan(bounce_fn, init,
                     jnp.arange(params.bounces + 1, dtype=jnp.int32))
    incoming = jnp.stack([inx, iny, inz], axis=-1)
    if compacting:
        # scatter radiance (and RNG state) back to original ray slots
        incoming = jnp.zeros_like(incoming).at[slot].set(incoming)
        state = jnp.zeros_like(state).at[slot].set(state)
    return state, incoming


def render_pixels(scene: Scene, basis: CameraBasis, params: RenderParams,
                  frame_index, pixel_ids):
    """Render a flat array of pixel ids → (N, 3) radiance.

    ``pixel_ids`` is the flattened pixel index (y * W + x, y=0 bottom row);
    taking it as an argument (instead of iota) is what lets shard_map hand
    each device its own tile with zero code changes (parallel/shard.py).
    """
    W, H = params.width, params.height
    x = (pixel_ids % W)
    y = (pixel_ids // W)
    state = sampling.seed_state(pixel_ids, jnp.abs(frame_index))
    if params.qmc:
        # per-pixel Cranley–Patterson rotation (stateless hash — does not
        # consume the ray RNG stream); the global sample counter walks the
        # R2 sequence so AA jitter is low-discrepancy ACROSS frames
        rot_x = sampling.hash_u32(pixel_ids)
        rot_y = sampling.hash_u32(pixel_ids ^ jnp.uint32(0x9E3779B9))

    def sample(carry, s):
        state, total = carry
        if params.qmc:
            n = (jnp.abs(frame_index).astype(jnp.uint32)
                 * jnp.uint32(params.rays_per_pixel) + s.astype(jnp.uint32))
            jit_xy = sampling.r2_point(n, rot_x, rot_y)
            st, o, d = camera_rays(basis, x, y, (W, H), state,
                                   jitter=jit_xy)
        else:
            st, o, d = camera_rays(basis, x, y, (W, H), state)
        st, rad = trace(scene, o, d, st, params)
        if params.clamp > 0.0:
            rad = jnp.minimum(rad, params.clamp)  # firefly suppression
        return (st, total + rad), None

    # total starts as a function of pixel_ids (varying under shard_map);
    # see the matching note in trace().
    total0 = jnp.zeros((pixel_ids.shape[0], 3), jnp.float32) * pixel_ids.astype(jnp.float32)[:, None]
    init = (state, total0)
    (state, total), _ = jax.lax.scan(
        sample, init, jnp.arange(params.rays_per_pixel, dtype=jnp.int32))
    return total / jnp.float32(params.rays_per_pixel)


@functools.lru_cache(maxsize=16)
def _blocked_order(W: int, H: int, bw: int = 16, bh: int = 8):
    """(order, inverse): pixel ids permuted so each run of 128 consecutive
    rays is a compact 16×8 pixel block instead of a 128-wide scanline strip.
    Tight blocks → tight per-block frustums → the kernel's cluster culling
    actually culls. Host-side constants, cached per resolution."""
    import numpy as np
    ys, xs = np.mgrid[0:H, 0:W]
    key = ((ys // bh) * (-(-W // bw)) + (xs // bw)) * (bw * bh) \
        + (ys % bh) * bw + (xs % bw)
    order = np.argsort(key.reshape(-1), kind="stable").astype(np.uint32)
    inverse = np.argsort(order, kind="stable").astype(np.int32)
    return order, inverse


def _unblock_image(img_flat, W: int, H: int, bw: int = 16, bh: int = 8):
    """Inverse of the blocked pixel order as reshape+transpose — a relayout
    XLA compiles far better than a 2M-element gather. Requires W % bw ==
    H % bh == 0 (render_frame falls back to the gather otherwise)."""
    return (img_flat.reshape(H // bh, W // bw, bh, bw, 3)
            .transpose(0, 2, 1, 3, 4).reshape(H * W, 3))


@functools.partial(jax.jit, static_argnames=("params",))
def render_frame(scene: Scene, basis: CameraBasis, params: RenderParams,
                 frame_index):
    """One full frame → (H, W, 3) linear radiance. Row 0 = bottom (RTiOW
    convention; flip for display — io/image.py does).

    With ``params.chunk_pixels > 0`` the frame is traced in sequential pixel
    chunks (lax.map) to bound the rays × primitives working set of the jnp
    backend; the kernel backend streams the scene and doesn't need this.
    """
    W, H = params.width, params.height
    n = H * W
    # blocked pixel order whenever blocks matter: always for the kernel;
    # for the jnp backend too when coherent_scatter is on, so both
    # backends assign pixels to the same 128-ray blocks (bit-identical
    # sample streams → backend parity tests stay exact)
    blocked = (resolved_backend(params) == "pallas"
               or params.coherent_scatter)
    if blocked:
        order, inverse = _blocked_order(W, H)
        pixel_ids = jnp.asarray(order)
    else:
        pixel_ids = jnp.arange(n, dtype=jnp.uint32)
    chunk = params.chunk_pixels
    if chunk and chunk < n:
        if n % chunk:
            # pad to a whole number of chunks; surplus pixels are wasted
            # lanes (masked out on reshape below)
            pad = chunk - n % chunk
            pixel_ids = jnp.concatenate(
                [pixel_ids, jnp.full((pad,), n - 1, jnp.uint32)])
        chunks = pixel_ids.reshape(-1, chunk)
        img = jax.lax.map(
            lambda ids: render_pixels(scene, basis, params, frame_index, ids),
            chunks).reshape(-1, 3)[:n]
    else:
        img = render_pixels(scene, basis, params, frame_index, pixel_ids)
    if blocked:
        if W % 16 == 0 and H % 8 == 0:
            img = _unblock_image(img, W, H)
        else:
            img = img[jnp.asarray(inverse)]  # back to raster order
    return img.reshape(H, W, 3)


@functools.partial(jax.jit, static_argnames=("params", "aov"))
def render_aov(scene: Scene, basis: CameraBasis, params: RenderParams,
               aov: str = "depth"):
    """Primary-ray AOV (arbitrary output variable) image → (H, W, C).

    Extension beyond the reference (whose only output is beauty):
    deterministic per-pixel geometry channels for debugging, compositing,
    and as inverse-rendering targets — the whole pipeline stays
    differentiable, so e.g. depth-supervised geometry recovery works via
    jax.grad. Rays go through pixel centers (no AA jitter, no DOF): AOVs
    are aliased by convention.

    aov: "depth"  (H, W, 1) hit distance in units of |d| (+inf → 0),
         "normal" (H, W, 3) outward unit normal (0 on miss),
         "albedo" (H, W, 3) surface albedo (0 on miss),
         "hit"    (H, W, 1) binary coverage mask.
    """
    if aov not in ("depth", "normal", "albedo", "hit"):
        raise ValueError(f"unknown aov {aov!r}")
    W, H = params.width, params.height
    n = H * W
    # Same blocked 16×8 pixel order as render_frame: without it, AOV rays
    # go out in 128-wide raster strips whose fat per-block frustums defeat
    # the kernel's cluster culling.
    blocked = resolved_backend(params) == "pallas"
    if blocked:
        order, inverse = _blocked_order(W, H)
        pixel_ids = jnp.asarray(order)
    else:
        pixel_ids = jnp.arange(n, dtype=jnp.uint32)
    x = (pixel_ids % W).astype(jnp.float32) + 0.5
    y = (pixel_ids // W).astype(jnp.float32) + 0.5
    px = x / W
    py = y / H
    # pixel-center rays: camera_rays' math with jitter pinned to 0.5 and
    # no lens offset (AOVs are aliased and DOF-free by convention)
    d = (basis.lower_left + px[:, None] * basis.horizontal
         + py[:, None] * basis.vertical - basis.origin)
    o = jnp.broadcast_to(basis.origin, d.shape)
    h = intersect(scene, o, d, t_min=params.t_min, backend=params.backend,
                  alive=pixel_ids == pixel_ids, interpret=params.interpret)
    if aov == "depth":
        img = jnp.where(h.hit, h.t, 0.0)[:, None]
    elif aov == "normal":
        img = jnp.where(h.hit[:, None], h.normal, 0.0)
    elif aov == "albedo":
        img = jnp.where(h.hit[:, None], h.albedo, 0.0)
    else:
        img = h.hit.astype(jnp.float32)[:, None]
    if blocked:
        if W % 16 == 0 and H % 8 == 0:
            C = img.shape[-1]
            img = (img.reshape(H // 8, W // 16, 8, 16, C)
                   .transpose(0, 2, 1, 3, 4).reshape(n, C))
        else:
            img = img[jnp.asarray(inverse)]
    return img.reshape(H, W, -1)


def accumulate(prev, frame_img, frame_index):
    """Progressive blend (shaders/ray_tracer.wgsl:59-66)."""
    w = 1.0 / (jnp.float32(frame_index) + 1.0)
    return jnp.where(frame_index >= 1, prev * (1.0 - w) + frame_img * w, frame_img)


@functools.partial(jax.jit, static_argnames=("params", "frames"))
def _render_progressive_chunk(scene: Scene, basis: CameraBasis,
                              params: RenderParams, frames: int,
                              start_frame, image0):
    start = jnp.int32(start_frame)

    def step(img, k):
        f = start + k
        frame_img = render_frame(scene, basis, params, f)
        return accumulate(img, frame_img, f), None

    img, _ = jax.lax.scan(step, image0, jnp.arange(frames, dtype=jnp.int32))
    return img


def render_progressive(scene: Scene, basis: CameraBasis, params: RenderParams,
                       frames: int, start_frame=0, image0=None,
                       chunk: int = 8):
    """``frames`` progressive frames accumulated ON DEVICE via lax.scan —
    per-launch latency no longer multiplies with frame count, and the
    accumulation recurrence (wgsl:59-66) fuses into the frame loop. Work is
    issued in ``chunk``-frame compiled programs so one compilation serves
    any frame count. Returns the accumulated (H, W, 3) image.

    Equivalent to calling ``render_frame`` + ``accumulate`` per frame
    starting at ``start_frame`` (the Renderer class uses that pair for
    interactive stepping; use this for headless/batch rendering)."""
    H, W = params.height, params.width
    img = (jnp.zeros((H, W, 3), jnp.float32) if image0 is None else image0)
    done = 0
    while done < frames:
        k = min(chunk, frames - done)
        img = _render_progressive_chunk(scene, basis, params, k,
                                        start_frame + done, img)
        done += k
    return img


@functools.partial(jax.jit, static_argnames=("params", "frames"))
def _render_moments_chunk(scene: Scene, basis: CameraBasis,
                          params: RenderParams, frames: int,
                          start_frame, sums):
    """Accumulate per-pixel first/second moments over ``frames`` frames
    on device (the adaptive-sampling statistics)."""
    start = jnp.int32(start_frame)

    def step(carry, k):
        s, s2 = carry
        img = render_frame(scene, basis, params, start + k)
        return (s + img, s2 + img * img), None

    (s, s2), _ = jax.lax.scan(step, sums,
                              jnp.arange(frames, dtype=jnp.int32))
    return s, s2


@jax.jit
def _adaptive_stats(s, s2, n, target_rel_std):
    """(mean image, fraction of pixels NOT yet converged) — one scalar
    pull per check instead of an image pull."""
    nf = jnp.float32(n)
    mean = s / nf
    var = jnp.maximum(s2 / nf - mean * mean, 0.0)
    # std of the MEAN estimate, relative to a luminance floor (dark pixels
    # converge by the absolute floor, not a blown-up ratio)
    rel = jnp.sqrt(var / jnp.maximum(nf - 1.0, 1.0)) / jnp.maximum(
        jnp.max(mean, axis=-1, keepdims=True), 5e-2)
    return mean, jnp.mean((jnp.max(rel, axis=-1) > target_rel_std)
                          .astype(jnp.float32))


def render_adaptive(scene: Scene, basis: CameraBasis, params: RenderParams,
                    max_frames: int, target_rel_std: float = 0.02,
                    chunk: int = 16, converged_fraction: float = 0.99):
    """Variance-guided progressive rendering (extension beyond the
    reference, which renders a fixed frame count): accumulate frames in
    compiled ``chunk``-frame programs, tracking per-pixel Welford moments
    on device, and STOP once ≥``converged_fraction`` of pixels have a
    relative standard error of the mean below ``target_rel_std``. One
    scalar crosses the device boundary per chunk.

    Returns (mean image (H, W, 3), frames_rendered).
    """
    H, W = params.height, params.width
    s = jnp.zeros((H, W, 3), jnp.float32)
    s2 = jnp.zeros((H, W, 3), jnp.float32)
    n = 0
    while n < max_frames:
        k = min(chunk, max_frames - n)
        s, s2 = _render_moments_chunk(scene, basis, params, k, n, (s, s2))
        n += k
        mean, frac_noisy = _adaptive_stats(s, s2, n, target_rel_std)
        if float(frac_noisy) <= 1.0 - converged_fraction:
            break
    return mean, n


class Renderer:
    """Progressive renderer with reference frame-counter semantics
    (src/core/context.rs:143-146, 176-187).

    >>> r = Renderer(scene, camera, RenderParams(width=256, height=256))
    >>> for _ in range(16): r.step()
    >>> img = r.image   # (H, W, 3) linear, accumulated
    """

    def __init__(self, scene: Scene, camera: Camera, params: RenderParams):
        self.scene = scene
        self.camera = camera.replace(aspect=params.aspect)
        self.params = params
        self.frames = -1
        self._image: Optional[jax.Array] = None
        self._basis = camera_basis(self.camera)

    def clear_accumulation(self):
        """frames = -1: next step overwrites (context.rs:143-146)."""
        self.frames = -1

    def set_camera(self, camera: Camera):
        self.camera = camera.replace(aspect=self.params.aspect)
        self._basis = camera_basis(self.camera)
        self.clear_accumulation()

    def set_scene(self, scene: Scene):
        self.scene = scene
        self.clear_accumulation()

    def set_params(self, params: RenderParams):
        self.params = params
        # a resolution change (Context::resize, context.rs:126-142) also
        # changes the aspect baked into the camera basis
        self.camera = self.camera.replace(aspect=params.aspect)
        self._basis = camera_basis(self.camera)
        self._image = None  # shape may have changed
        self.clear_accumulation()

    def step(self) -> jax.Array:
        """Render one frame and blend it in; returns the accumulated image."""
        if self.params.accumulate:
            self.frames += 1
        frame_img = render_frame(
            self.scene, self._basis, self.params, jnp.int32(self.frames))
        if self._image is None or self.frames < 1:
            self._image = frame_img
        else:
            self._image = accumulate(self._image, frame_img, self.frames)
        return self._image

    @property
    def image(self) -> jax.Array:
        if self._image is None:
            self.step()
        return self._image


def render(scene: Scene, camera: Camera, params: RenderParams,
           frames: int = 1) -> jax.Array:
    """One-shot convenience: render ``frames`` progressive frames and return
    the accumulated (H, W, 3) image."""
    r = Renderer(scene, camera, params)
    for _ in range(max(1, frames)):
        img = r.step()
    return img
