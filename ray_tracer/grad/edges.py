"""Edge-sampled visibility (boundary) gradients.

The interior gradient path (ops/intersect.py: detached winner + continuous
recompute) cannot see SILHOUETTE motion: moving a sphere sideways changes
which pixels it covers, a discontinuity autodiff integrates to zero. The
missing boundary term (Li et al. 2018, "Differentiable Monte Carlo Ray
Tracing through Edge Sampling" — re-derived here, not ported) is

    dLoss/dθ |_boundary = ∮_silhouettes cot(pix(x)) · (L⁻(x) − L⁺(x))
                              · ( n̂(x) · ∂x_img/∂θ ) dl_img

where x runs over visibility discontinuity curves in IMAGE space, n̂ is a
unit normal of the curve, L± the radiance just to either side, and cot the
upstream pixel cotangent (∂Loss/∂pixel). The (L⁻ − L⁺)(n̂·v) form is
orientation-invariant — flipping n̂ flips both factors — so no inside/outside
classification is needed; occluded edges and interior (closed-mesh) edges
contribute ≈0 automatically because both sides see the same radiance.

Curves sampled:
  * every triangle edge (uniform over edges, uniform along the edge;
    non-silhouette edges are zero-contribution noise, not bias),
  * every sphere's silhouette circle — for camera origin o and sphere
    (c, r) with d = |o − c|, the tangency circle has center
    c + (r²/d²)(o − c) and radius r·sqrt(1 − r²/d²) in the plane ⊥ (o−c);
    differentiable w.r.t. (c, r) in closed form via autodiff.

The estimator returns gradients for tri_v0/v1/v2, sphere_center and
sphere_radius to be ADDED to the interior autodiff gradients
(see grad.inverse.make_train_step(edge_samples=...)).

Thin-lens cameras (aperture > 0): the rendered image is an expectation
over lens points l, so the boundary term is E_l of the same contour
integral taken per lens point — each MC sample draws its own l (uniform
disk on the (u, v) lens plane, like camera_rays), projects through l onto
the focal viewport plane, evaluates both side radiances from l, and (for
spheres) takes the silhouette circle as seen FROM l. At aperture 0 the
lens offset is exactly zero and this reduces to the pinhole estimator
bit-for-bit.
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..camera import CameraBasis
from ..renderer import trace
from ..scene import Scene
from ..utils.config import RenderParams


# ---------------------------------------------------------------------------
# Projection (inverse of the ray-gen map at aperture 0)
# ---------------------------------------------------------------------------

def project_to_image(basis: CameraBasis, x, width: int, height: int,
                     origin=None):
    """World point → image coordinates in PIXEL units (px right, py up,
    matching render_pixels' y-up pixel grid).

    Ray-gen (camera.py): dir = ll + px·h + py·v − o with px, py ∈ [0,1].
    Inverting: intersect the ray o→x with the viewport plane spanned by
    (h, v) anchored at ll. ``origin`` (default basis.origin) is the ray
    origin — a lens point for thin-lens cameras; the viewport plane is a
    fixed world plane (the focal plane), so projecting from a shifted
    origin is the exact inverse of the DOF ray-gen at that lens point."""
    origin = basis.origin if origin is None else origin
    rel = x - origin                                     # (..., 3)
    # viewport plane normal is w (basis is orthogonal: h ∥ u, v ∥ v̂, both ⊥ w)
    anchor = basis.lower_left - origin
    denom = jnp.sum(rel * basis.w, axis=-1, keepdims=True)
    tplane = jnp.sum(anchor * basis.w, axis=-1, keepdims=True) / jnp.where(
        jnp.abs(denom) < 1e-12, 1e-12, denom)
    hitp = rel * tplane                                   # point on plane - o
    offset = hitp - anchor
    px = (jnp.sum(offset * basis.horizontal, axis=-1)
          / jnp.maximum(jnp.sum(basis.horizontal ** 2, axis=-1), 1e-20))
    py = (jnp.sum(offset * basis.vertical, axis=-1)
          / jnp.maximum(jnp.sum(basis.vertical ** 2, axis=-1), 1e-20))
    return jnp.stack([px * width, py * height], axis=-1)


def _radiance_at(scene, basis, params: RenderParams, pix, state,
                 origins=None):
    """Radiance of the ray through image point ``pix`` (pixel units), from
    ``origins`` ((N, 3) lens points; default: the pinhole origin)."""
    W, H = params.width, params.height
    px = pix[:, 0] / W
    py = pix[:, 1] / H
    o = (jnp.broadcast_to(basis.origin, pix.shape[:1] + (3,))
         if origins is None else origins)
    d = (basis.lower_left + px[:, None] * basis.horizontal
         + py[:, None] * basis.vertical - o)
    _, rad = trace(scene, o, d, state, params)
    return rad


def _lookup_cot(cot_image, pix, width, height):
    """Nearest-pixel cotangent lookup; zero outside the frame."""
    x = jnp.floor(pix[:, 0]).astype(jnp.int32)
    y = jnp.floor(pix[:, 1]).astype(jnp.int32)
    inside = (x >= 0) & (x < width) & (y >= 0) & (y < height)
    xc = jnp.clip(x, 0, width - 1)
    yc = jnp.clip(y, 0, height - 1)
    cot = cot_image.reshape(height, width, 3)[yc, xc]
    return jnp.where(inside[:, None], cot, 0.0)


# ---------------------------------------------------------------------------
# Boundary gradient estimator
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("params", "n_tri_samples",
                                             "n_sph_samples"))
def boundary_gradients(scene: Scene, basis: CameraBasis, params: RenderParams,
                       cot_image, key, n_tri_samples: int = 4096,
                       n_sph_samples: int = 4096,
                       eps_px: float = 0.05,
                       topology=None) -> Dict[str, jax.Array]:
    """Monte-Carlo boundary-term gradients.

    Args:
      cot_image: (H, W, 3) upstream pixel cotangent ∂Loss/∂pixel.
      key: jax PRNG key (edge sampling is independent of the render RNG).
      n_tri_samples / n_sph_samples: MC sample counts (0 disables a family).
      eps_px: side-ray offset in pixels.
      topology: optional grad.topology.MeshTopology. STRONGLY recommended
        for meshes with shared edges: switches edge sampling from
        uniform-over-(tri, corner)-slots — which double-counts every
        interior edge (two slots per physical edge) and spends ~all samples
        on zero-contribution interior edges — to importance sampling over
        PHYSICAL edges classified as candidates per step: silhouette
        (front/back flip between adjacent faces, from the pinhole origin —
        exact at aperture 0, approximate near lens-dependent silhouettes),
        boundary (one adjacent face), or crease (shading-normal split),
        weighted by projected image length. Gradients are written to the
        representative (triangle, corner) slots; pull them back to unique
        vertices with topology.pull_back_vertex_grads when optimizing a
        vertex field.

    Returns dict with keys tri_v0, tri_v1, tri_v2, sphere_center,
    sphere_radius — shaped like the scene fields, zeros where inapplicable.
    """
    W, H = params.width, params.height
    out = {
        "tri_v0": jnp.zeros_like(scene.tri_v0),
        "tri_v1": jnp.zeros_like(scene.tri_v1),
        "tri_v2": jnp.zeros_like(scene.tri_v2),
        "sphere_center": jnp.zeros_like(scene.sphere_center),
        "sphere_radius": jnp.zeros_like(scene.sphere_radius),
    }
    k_tri, k_sph, k_rng, k_lens = jax.random.split(key, 4)
    scene_d = jax.lax.stop_gradient(scene)

    def lens_points(k, n):
        """(n, 3) per-sample ray origins: uniform-disk lens offsets on the
        (u, v) plane (camera_rays' DOF model). Exactly basis.origin at
        aperture 0."""
        k1, k2 = jax.random.split(k)
        rr = jnp.sqrt(jax.random.uniform(k1, (n,)))
        th = jax.random.uniform(k2, (n,)) * (2.0 * np.pi)
        rd = basis.lens_radius * jnp.stack(
            [rr * jnp.cos(th), rr * jnp.sin(th)], axis=-1)
        return (basis.origin + rd[:, 0:1] * basis.u
                + rd[:, 1:2] * basis.v)

    def side_terms(x_img, tangent_img, n_samples, state_seed, origins):
        """Common per-sample machinery: normal, side radiances, cot·ΔL.
        Both side rays share the sample's lens point (correlated sides —
        the difference ΔL is what matters)."""
        tlen = jnp.linalg.norm(tangent_img, axis=-1)
        that = tangent_img / jnp.maximum(tlen, 1e-12)[:, None]
        nhat = jnp.stack([-that[:, 1], that[:, 0]], axis=-1)
        p_minus = x_img - eps_px * nhat
        p_plus = x_img + eps_px * nhat
        state = state_seed
        L_minus = _radiance_at(scene_d, basis, params, p_minus, state,
                               origins)
        L_plus = _radiance_at(scene_d, basis, params, p_plus, state,
                              origins)
        cot = _lookup_cot(cot_image, x_img, W, H)
        # scalar weight per sample: Σ_c cot_c (L⁻ − L⁺)_c
        s = jnp.sum(cot * (L_minus - L_plus), axis=-1)
        return nhat, tlen, s

    # --- triangle edges ----------------------------------------------------
    TP = scene.padded_tris
    if n_tri_samples > 0 and scene.num_tris > 0:
        ke, kt = jax.random.split(k_tri)
        verts = jnp.stack([scene_d.tri_v0, scene_d.tri_v1, scene_d.tri_v2], 1)
        if topology is not None:
            topo = topology
            va_all = verts[topo.edge_tri, topo.edge_k]            # (E, 3)
            vb_all = verts[topo.edge_tri, (topo.edge_k + 1) % 3]

            def face_front(tri_ids):
                t = jnp.maximum(tri_ids, 0)
                a = scene_d.tri_v0[t]
                nf = jnp.cross(scene_d.tri_v1[t] - a,
                               scene_d.tri_v2[t] - a)
                cen = (a + scene_d.tri_v1[t] + scene_d.tri_v2[t]) / 3.0
                return jnp.sum(nf * (basis.origin - cen), axis=-1) > 0.0

            front_a = face_front(topo.edge_tri)
            front_b = face_front(topo.edge_tri2)
            has_b = topo.edge_tri2 >= 0
            # candidates: silhouette flips, boundary edges (either
            # orientation — winding-agnostic), shading creases
            cand = (jnp.where(has_b, front_a != front_b, True)
                    | (topo.edge_crease > 0.5))
            cand = cand & (scene_d.tri_valid[topo.edge_tri] > 0.5)
            # importance ∝ projected image length (contribution carries a
            # |dX/dt| factor); clipped so behind-camera blowups can't
            # starve the rest of the contour
            pa = project_to_image(basis, va_all, W, H)
            pb = project_to_image(basis, vb_all, W, H)
            ell = jnp.linalg.norm(pb - pa, axis=-1)
            wgt = jnp.where(cand, jnp.clip(ell, 1e-3, 1e4), 0.0)
            wsum = jnp.sum(wgt)
            logits = jnp.where(wgt > 0, jnp.log(jnp.maximum(wgt, 1e-30)),
                               -jnp.inf)
            eid = jax.random.categorical(ke, logits,
                                         shape=(n_tri_samples,))
            tri = topo.edge_tri[eid]
            edge = topo.edge_k[eid]
            va = va_all[eid]
            vb = vb_all[eid]
            p_e = wgt[eid] / jnp.maximum(wsum, 1e-30)
            inv_meas = jnp.where(
                wgt[eid] > 0, 1.0 / (jnp.maximum(p_e, 1e-30)
                                     * n_tri_samples), 0.0)
            valid = (wgt[eid] > 0) & (wsum > 0)
        else:
            # legacy uniform-over-slots path (correct only when no edge is
            # shared — e.g. isolated emitter triangles; see ``topology``)
            n_edges = 3 * TP
            eid = jax.random.randint(ke, (n_tri_samples,), 0, n_edges)
            tri = eid // 3
            edge = eid % 3
            va = verts[tri, edge]
            vb = verts[tri, (edge + 1) % 3]
            valid = scene_d.tri_valid[tri] > 0.5
            inv_meas = jnp.full((n_tri_samples,),
                                n_edges / n_tri_samples, jnp.float32)
        tparam = jax.random.uniform(kt, (n_tri_samples,))
        ol = lens_points(jax.random.fold_in(k_lens, 0), n_tri_samples)

        x_world = (1.0 - tparam)[:, None] * va + tparam[:, None] * vb
        x_img = project_to_image(basis, x_world, W, H, ol)
        # image-space tangent dX/dt via jvp along (vb - va)
        tangent = jax.vmap(lambda xw, dv, o_: jax.jvp(
            lambda p: project_to_image(basis, p, W, H, o_), (xw,), (dv,))[1]
        )(x_world, vb - va, ol)

        state = jax.random.bits(
            jax.random.fold_in(k_rng, 0), (n_tri_samples,), dtype=jnp.uint32)
        nhat, tlen, s = side_terms(x_img, tangent, n_tri_samples, state, ol)

        # measure: ∫ dl_img = ∫₀¹ |dX/dt| dt per edge; edge choice weighted
        # by inv_meas = 1/(pdf·N); the boundary velocity n̂·∂x/∂θ is the
        # material-point derivative (tangential reparametrization killed
        # by the n̂ projection)
        coeff = jnp.where(valid, s, 0.0) * tlen * inv_meas

        # ∂(n̂·x_img)/∂va = (1−t)·Jᵀn̂, ∂/∂vb = t·Jᵀn̂ via one vjp each
        def g_world(xw, nh, o_):
            _, vjp = jax.vjp(
                lambda p: project_to_image(basis, p, W, H, o_), xw)
            return vjp(nh)[0]
        gw = jax.vmap(g_world)(x_world, nhat, ol)         # (N, 3)
        ga = coeff[:, None] * (1.0 - tparam)[:, None] * gw
        gb = coeff[:, None] * tparam[:, None] * gw
        for k in range(3):
            sel_a = edge == k
            sel_b = (edge + 1) % 3 == k
            contrib = (jnp.where(sel_a[:, None], ga, 0.0)
                       + jnp.where(sel_b[:, None], gb, 0.0))
            key_name = f"tri_v{k}"
            out[key_name] = out[key_name].at[tri].add(contrib)

    # --- sphere silhouettes -----------------------------------------------
    SP = scene.padded_spheres
    if n_sph_samples > 0 and scene.num_spheres > 0:
        ks, kp = jax.random.split(k_sph)
        sid = jax.random.randint(ks, (n_sph_samples,), 0, SP)
        phi = jax.random.uniform(kp, (n_sph_samples,)) * 2.0 * np.pi
        valid = ((scene_d.sphere_valid[sid] > 0.5)
                 & (scene_d.sphere_radius[sid] > 0.0))
        ol = lens_points(jax.random.fold_in(k_lens, 1), n_sph_samples)

        def silhouette_point(c, r, phi_, o_):
            # the silhouette circle as seen FROM the sample's lens point
            oc = o_ - c
            d2 = jnp.maximum(jnp.sum(oc * oc), 1e-12)
            d1 = jnp.sqrt(d2)
            axis = oc / d1
            # visible only when the camera is outside (r < d)
            ratio2 = jnp.clip(r * r / d2, 0.0, 0.999999)
            center = c + oc * ratio2
            r_sil = r * jnp.sqrt(1.0 - ratio2)
            up = jnp.where(jnp.abs(axis[2]) < 0.9,
                           jnp.array([0.0, 0.0, 1.0]),
                           jnp.array([0.0, 1.0, 0.0]))
            e1 = jnp.cross(axis, up)
            e1 = e1 / jnp.maximum(jnp.linalg.norm(e1), 1e-12)
            e2 = jnp.cross(axis, e1)
            return center + r_sil * (jnp.cos(phi_) * e1 + jnp.sin(phi_) * e2)

        c = scene_d.sphere_center[sid]
        r = scene_d.sphere_radius[sid]
        x_world = jax.vmap(silhouette_point)(c, r, phi, ol)
        x_img = jax.vmap(
            lambda xw, o_: project_to_image(basis, xw, W, H, o_)
        )(x_world, ol)
        # tangent along the curve: dX/dφ via jvp
        tangent = jax.vmap(lambda cc, rr, ph, o_: jax.jvp(
            lambda p: project_to_image(
                basis, silhouette_point(cc, rr, p, o_), W, H, o_),
            (ph,), (1.0,))[1]
        )(c, r, phi, ol)

        state = jax.random.bits(
            jax.random.fold_in(k_rng, 1), (n_sph_samples,), dtype=jnp.uint32)
        nhat, tlen, s = side_terms(x_img, tangent, n_sph_samples, state, ol)
        inside_cam = jnp.sum((ol - c) ** 2, -1) > r * r
        # a silhouette point behind the lens is not in the image, though
        # its mirrored projection can land inside the frame (a large
        # ground sphere's silhouette circle passes behind the camera)
        in_front = jnp.sum((x_world - ol) * basis.w, -1) < 0.0
        keep = valid & inside_cam & in_front
        # measure: ∫ dl_img = ∫₀²π |dX/dφ| dφ, spheres picked uniformly
        coeff = (jnp.where(keep, s, 0.0) * tlen
                 * (SP * 2.0 * np.pi / n_sph_samples))

        def g_cr(cc, rr, ph, nh, o_):
            def f(cr):
                c_, r_ = cr[:3], cr[3]
                return jnp.sum(project_to_image(
                    basis, silhouette_point(c_, r_, ph, o_), W, H, o_) * nh)
            return jax.grad(f)(jnp.concatenate([cc, rr[None]]))
        g = jax.vmap(g_cr)(c, r, phi, nhat, ol)           # (N, 4)
        # dropped samples may carry non-finite projections: select, do
        # not multiply by zero
        g = jnp.where(keep[:, None], coeff[:, None] * g, 0.0)
        out["sphere_center"] = out["sphere_center"].at[sid].add(g[:, :3])
        out["sphere_radius"] = out["sphere_radius"].at[sid].add(g[:, 3])

    return out
