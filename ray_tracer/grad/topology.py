"""Mesh connectivity for geometry gradients (host-side build, jit-ready).

The scene stores PRE-GATHERED triangles (scene.py: tri_v0/v1/v2) — the
SoA layout has no vertex indexing left. Geometry recovery
needs it back, twice over:

  * a per-vertex offset field (BASELINE config 5 "recover teapot vertex
    offsets") must move every (tri, corner) slot of a physical vertex
    together, and pull the tri-slot cotangents back onto unique vertices;
  * the edge-sampled boundary estimator (grad/edges.py) must sample each
    PHYSICAL edge once. The uniform-over-slots sampler counts an interior
    edge twice — one per adjacent triangle — which overscales the boundary
    term exactly 2x on closed meshes (caught in round 5; the r3 "10-50x
    overscaled" observation was this plus non-silhouette noise), and it
    needs face adjacency to classify silhouettes at all.

``build_topology`` reconstructs connectivity by exact-bitwise position
dedup (valid because loaders emit single-indexed vertices — every shared
corner is the same f32 triple; hand-built scenes repeat tuples likewise).

All returned index arrays are jnp and shaped statically, so everything
downstream jits; the build itself is numpy on host (teapot: ~50k corners,
milliseconds).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..scene import Scene


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class MeshTopology:
    """Connectivity of a scene's valid triangles.

    Vertices: ``num_verts`` unique positions; ``tri2vert[t, k]`` maps the
    k-th corner of triangle t to its unique vertex id (padding triangles
    map to vertex 0 and are masked by ``tri_valid`` downstream).

    Edges: one entry per PHYSICAL undirected edge. ``edge_tri``/``edge_k``
    name a representative (triangle, corner) slot — the edge runs corner k
    → corner (k+1)%3 of that triangle; ``edge_tri2`` is the other adjacent
    triangle (-1 on boundary edges). ``edge_crease`` is 1.0 where shading
    normals differ across the edge (radiance can jump there even between
    two front-facing triangles).
    """

    tri2vert: jax.Array      # (T, 3) int32
    base_verts: jax.Array    # (V, 3) f32 unique positions at build time
    edge_tri: jax.Array      # (E,) int32
    edge_k: jax.Array        # (E,) int32
    edge_tri2: jax.Array     # (E,) int32, -1 = boundary
    edge_crease: jax.Array   # (E,) f32 {0, 1}
    edge_va: jax.Array       # (E,) int32 unique vertex id of corner k
    edge_vb: jax.Array       # (E,) int32 unique vertex id of corner k+1

    @property
    def num_verts(self) -> int:
        return self.base_verts.shape[0]

    @property
    def num_edges(self) -> int:
        return self.edge_tri.shape[0]


def build_topology(scene: Scene, crease_cos: float = 0.999) -> MeshTopology:
    """Host-side connectivity build over the scene's VALID triangles.

    crease_cos: an edge is flagged crease when the shading normals the two
    adjacent triangles assign to a shared endpoint disagree beyond this
    cosine — i.e. the mesh is intentionally faceted there.
    """
    v = [np.asarray(x, np.float32)
         for x in (scene.tri_v0, scene.tri_v1, scene.tri_v2)]
    n = [np.asarray(x, np.float32)
         for x in (scene.tri_n0, scene.tri_n1, scene.tri_n2)]
    valid = np.asarray(scene.tri_valid) > 0.5
    T = v[0].shape[0]

    corners = np.stack(v, axis=1).reshape(T * 3, 3)        # (T*3, 3)
    # exact-bitwise dedup: view rows as void records
    rec = np.ascontiguousarray(corners).view(
        np.dtype((np.void, corners.dtype.itemsize * 3))).reshape(-1)
    _, first_idx, inv = np.unique(rec, return_index=True,
                                  return_inverse=True)
    base_verts = corners[first_idx]
    tri2vert = inv.reshape(T, 3).astype(np.int32)

    normals = np.stack(n, axis=1)                          # (T, 3, 3)
    nrm = normals / np.maximum(
        np.linalg.norm(normals, axis=-1, keepdims=True), 1e-12)

    edges: dict = {}
    for t in range(T):
        if not valid[t]:
            continue
        for k in range(3):
            a, b = int(tri2vert[t, k]), int(tri2vert[t, (k + 1) % 3])
            if a == b:
                continue  # degenerate
            key = (a, b) if a < b else (b, a)
            edges.setdefault(key, []).append((t, k))

    e_tri, e_k, e_tri2, e_crease, e_va, e_vb = [], [], [], [], [], []
    for (a, b), insts in edges.items():
        t0, k0 = insts[0]
        e_tri.append(t0)
        e_k.append(k0)
        e_va.append(int(tri2vert[t0, k0]))
        e_vb.append(int(tri2vert[t0, (k0 + 1) % 3]))
        crease = 0.0
        if len(insts) >= 2:
            t1, k1 = insts[1]
            e_tri2.append(t1)
            # shading normals at the shared endpoints, matched by vertex id
            for vid in (a, b):
                s0 = int(np.where(tri2vert[t0] == vid)[0][0])
                s1 = int(np.where(tri2vert[t1] == vid)[0][0])
                if float(np.dot(nrm[t0, s0], nrm[t1, s1])) < crease_cos:
                    crease = 1.0
        else:
            e_tri2.append(-1)
        e_crease.append(crease)

    def arr(x, dt=np.int32):
        return jnp.asarray(np.asarray(x, dt))

    return MeshTopology(
        tri2vert=jnp.asarray(tri2vert),
        base_verts=jnp.asarray(base_verts),
        edge_tri=arr(e_tri), edge_k=arr(e_k), edge_tri2=arr(e_tri2),
        edge_crease=arr(e_crease, np.float32),
        edge_va=arr(e_va), edge_vb=arr(e_vb))


# ---------------------------------------------------------------------------
# Differentiable vertex-field plumbing (the demo/train-side consumers)
# ---------------------------------------------------------------------------

def apply_vertex_offsets(scene: Scene, topo: MeshTopology, offsets,
                         recompute_normals: bool = True) -> Scene:
    """Scene with ``offsets`` ((V, 3)) added to every slot of each unique
    vertex; differentiable w.r.t. offsets. With ``recompute_normals``,
    shading normals are rebuilt area-weighted from the DEFORMED positions
    (also differentiable), so interior shading gradients see geometry —
    frozen load-time normals would decouple shading from the offset field."""
    d0 = offsets[topo.tri2vert[:, 0]]
    d1 = offsets[topo.tri2vert[:, 1]]
    d2 = offsets[topo.tri2vert[:, 2]]
    m = scene.tri_valid[:, None]
    v0 = scene.tri_v0 + d0 * m
    v1 = scene.tri_v1 + d1 * m
    v2 = scene.tri_v2 + d2 * m
    kw = dict(tri_v0=v0, tri_v1=v1, tri_v2=v2)
    if recompute_normals:
        n0, n1, n2 = smooth_normals(topo, v0, v1, v2, scene.tri_valid)
        kw.update(tri_n0=n0, tri_n1=n1, tri_n2=n2)
    return dataclasses.replace(scene, **kw)


def smooth_normals(topo: MeshTopology, v0, v1, v2, tri_valid):
    """Area-weighted smooth vertex normals from (possibly deformed)
    positions, scattered onto unique vertices and gathered back to the
    (T, 3) corner slots. The cross product IS area-weighted — summing it
    un-normalized is the standard area weighting."""
    fn = jnp.cross(v1 - v0, v2 - v0) * tri_valid[:, None]   # (T, 3)
    V = topo.num_verts
    acc = jnp.zeros((V, 3), fn.dtype)
    for k in range(3):
        acc = acc.at[topo.tri2vert[:, k]].add(fn)
    acc = acc / jnp.maximum(
        jnp.linalg.norm(acc, axis=-1, keepdims=True), 1e-12)
    return (acc[topo.tri2vert[:, 0]], acc[topo.tri2vert[:, 1]],
            acc[topo.tri2vert[:, 2]])


def pull_back_vertex_grads(topo: MeshTopology, tri_grads: dict,
                           tri_valid) -> jax.Array:
    """Transpose of apply_vertex_offsets' gather: accumulate tri-slot
    cotangents (keys tri_v0/tri_v1/tri_v2) onto unique vertices → (V, 3).
    Used to add the boundary estimator's tri-space output to a vertex-space
    autodiff gradient."""
    V = topo.num_verts
    g = jnp.zeros((V, 3), jnp.float32)
    m = tri_valid[:, None]
    for k, key in enumerate(("tri_v0", "tri_v1", "tri_v2")):
        g = g.at[topo.tri2vert[:, k]].add(tri_grads[key] * m)
    return g


def laplacian_apply(topo: MeshTopology, x) -> jax.Array:
    """Combinatorial graph Laplacian over physical edges, per component:
    (L x)_i = Σ_{j∈N(i)} (x_i − x_j). Matrix-free (two scatter-adds)."""
    d = x[topo.edge_va] - x[topo.edge_vb]
    out = jnp.zeros_like(x)
    out = out.at[topo.edge_va].add(d)
    out = out.at[topo.edge_vb].add(-d)
    return out


def sobolev_precondition(topo: MeshTopology, g, lam, iters: int = 20):
    """Diffuse a vertex gradient through (I + λL)⁻¹ by matrix-free CG.

    Laplacian-preconditioned ("Sobolev") descent — the technique of
    "Large Steps in Inverse Rendering of Geometry" (Nicolet et al. 2021):
    raw image-loss gradients on a dense mesh are spatially rough, so
    first-order descent crumples the surface into high-frequency local
    minima long before the large-scale error modes move. Solving
    (I + λL) p = g re-expresses the step in a smoother Sobolev metric:
    low-frequency modes keep their magnitude while rough components are
    damped by ~1/(1+λ·spectrum), and p stays a descent direction because
    the operator is SPD. λ is dimensionless (combinatorial L); 0 returns
    g untouched."""
    if not lam:
        return g

    def mv(p):
        return p + lam * laplacian_apply(topo, p)

    p, _ = jax.scipy.sparse.linalg.cg(mv, g, x0=g, maxiter=iters)
    return p


def dirichlet_energy(topo: MeshTopology, offsets) -> jax.Array:
    """Graph-Laplacian smoothness prior on a vertex field: mean squared
    field GRADIENT across physical edges — ‖δ_i − δ_j‖² normalized by the
    base edge length ‖x_i − x_j‖², so the energy is dimensionless and a
    given prior weight transfers across mesh resolutions (an un-normalized
    mean edge difference scales with edge length, making the same weight
    ~100x weaker on a fine mesh than a coarse one). Regularizes geometry
    recovery — silhouette evidence is sparse (only silhouette vertices get
    boundary signal each view), and this propagates it inboard."""
    d = offsets[topo.edge_va] - offsets[topo.edge_vb]
    e = topo.base_verts[topo.edge_va] - topo.base_verts[topo.edge_vb]
    e2 = jnp.maximum(jnp.sum(e * e, axis=-1), 1e-20)
    return jnp.mean(jnp.sum(d * d, axis=-1) / e2)
