"""GPU closest-hit and any-hit kernel: Pallas on the Triton route.

One program traces one block of ``RB`` = 128 rays, one ray per thread. In
the renderer's blocked pixel order (renderer._blocked_order) a block is a
compact 16×8 pixel tile, so its rays share a tight frustum. The scene is
read from device memory as row-per-primitive plane arrays; the planes of a
16k-triangle mesh take about 1 MB and stay in the card's L2.

Culling is what a plain jnp program cannot express: there every ray tests
every primitive. Triangles arrive in the scene's median-split order
(scene._median_split_order), so each run of ``CLUSTER`` = 64 consecutive
triangles is a tight cluster and each run of ``SUPER`` = 8 clusters a tight
super-cluster. The kernel walks the super-clusters, slab-tests each box
against the block's rays, and enters it only when some live ray reaches the
box closer than its current best hit: a branch that is uniform across the
block. The same test gates each cluster inside an entered super-cluster.
The running best t and id stay in registers.

The any-hit variant answers shadow queries. A ray is settled by its first
hit below ``t_max``: its best t drops to -inf, so no later box test passes
for it, and once every ray of the block is settled every remaining box is
skipped. Dead rays (``alive`` False) start at -inf in both variants and
cost nothing past the first box tests.

The prim-id convention matches ops/intersect.py: spheres [0, SP), triangles
[SP, SP+TP); t = +inf encodes a miss, with id 0.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..scene import Scene
from .backend import kernel_interpret

RB = 128           # rays per program: one per thread at NUM_WARPS = 4
NUM_WARPS = 4
CLUSTER = 64       # triangles per cluster (scene._median_split_order leaf)
SUPER = 8          # clusters per super-cluster
BIG_ID = 2 ** 30   # "no winner yet"; plain int so it is not a captured const
TRI_DET_EPS = 1e-6  # back-face / parallel cutoff, as the oracle


def _tri_planes(scene: Scene):
    """(TP, 16) rows [v0(3) | e1(3) | e2(3) | n(3) | valid | pad(3)] with
    n = e1 × e2, the unnormalized geometric normal."""
    a = scene.tri_v0
    e1 = scene.tri_v1 - a
    e2 = scene.tri_v2 - a
    pad = jnp.zeros((a.shape[0], 3), jnp.float32)
    return jnp.concatenate([a, e1, e2, jnp.cross(e1, e2),
                            scene.tri_valid[:, None], pad], axis=1)


def _sphere_planes(scene: Scene):
    """(SP, 8) rows [center(3) | radius² | valid | pad(3)]."""
    pad = jnp.zeros((scene.sphere_center.shape[0], 3), jnp.float32)
    return jnp.concatenate([scene.sphere_center,
                            (scene.sphere_radius ** 2)[:, None],
                            scene.sphere_valid[:, None], pad], axis=1)


def _group_boxes(lo, hi, size: int):
    """Boxes over consecutive groups of ``size`` rows of (N, 3) lo/hi
    bounds → (ceil(N / size), 8) rows [lo(3) | hi(3) | pad(2)]. Missing
    rows of the last group are empty (+inf/-inf) and drop out."""
    n = lo.shape[0]
    groups = -(-n // size)
    pad = groups * size - n
    lo = jnp.pad(lo, ((0, pad), (0, 0)), constant_values=jnp.inf)
    hi = jnp.pad(hi, ((0, pad), (0, 0)), constant_values=-jnp.inf)
    lo = lo.reshape(groups, size, 3).min(1)
    hi = hi.reshape(groups, size, 3).max(1)
    return jnp.concatenate([lo, hi, jnp.zeros((groups, 2), jnp.float32)], 1)


def _boxes(scene: Scene):
    """(cluster boxes (C, 8), super-cluster boxes (NS, 8)) over the real
    triangles. Invalid triangles contribute empty bounds. An empty box
    passes the slab test vacuously (its per-axis interval is ±inf), which
    is harmless: the kernel visits only the C real clusters."""
    n = max(scene.num_tris, 1)
    verts = jnp.stack([scene.tri_v0, scene.tri_v1, scene.tri_v2], 1)[:n]
    valid = (scene.tri_valid[:n] > 0.5)[:, None]
    lo = jnp.where(valid, verts.min(1), jnp.inf)
    hi = jnp.where(valid, verts.max(1), -jnp.inf)
    clu = _group_boxes(lo, hi, CLUSTER)
    sup = _group_boxes(clu[:, 0:3], clu[:, 3:6], SUPER)
    return clu, sup


def _slab_test(lo, hi, o, invd, t_min):
    """AABB slab test of (x, y, z) bound triples against rays; returns
    (tn, tf) with the near end clamped at t_min."""
    t1 = [(lo[k] - o[k]) * invd[k] for k in range(3)]
    t2 = [(hi[k] - o[k]) * invd[k] for k in range(3)]
    tn = jnp.maximum(jnp.maximum(jnp.minimum(t1[0], t2[0]),
                                 jnp.minimum(t1[1], t2[1])),
                     jnp.maximum(jnp.minimum(t1[2], t2[2]), t_min))
    tf = jnp.minimum(jnp.minimum(jnp.maximum(t1[0], t2[0]),
                                 jnp.maximum(t1[1], t2[1])),
                     jnp.maximum(t1[2], t2[2]))
    return tn, tf


def _mt_pairs(a, e1, e2, n, o, d, t_min):
    """Möller–Trumbore in the cross/determinant form of the oracle
    (intersect.triangle_ts); returns (t, geometrically valid)."""
    aox, aoy, aoz = o[0] - a[0], o[1] - a[1], o[2] - a[2]
    det = -(d[0] * n[0] + d[1] * n[1] + d[2] * n[2])
    t_num = aox * n[0] + aoy * n[1] + aoz * n[2]
    daox = aoy * d[2] - aoz * d[1]                      # ao × d
    daoy = aoz * d[0] - aox * d[2]
    daoz = aox * d[1] - aoy * d[0]
    u_num = e2[0] * daox + e2[1] * daoy + e2[2] * daoz
    v_num = -(e1[0] * daox + e1[1] * daoy + e1[2] * daoz)
    inv = 1.0 / det
    t, u, v = t_num * inv, u_num * inv, v_num * inv
    ok = ((det >= TRI_DET_EPS) & (t >= t_min)
          & (u >= 0.0) & (v >= 0.0) & (1.0 - u - v >= 0.0))
    return t, ok


def _sphere_pairs(c, r2, o, d, a_quad, t_min):
    """Near-root sphere quadratic of the oracle (intersect.sphere_ts);
    returns (t, geometrically valid)."""
    ocx, ocy, ocz = o[0] - c[0], o[1] - c[1], o[2] - c[2]
    b = 2.0 * (ocx * d[0] + ocy * d[1] + ocz * d[2])
    cc = ocx * ocx + ocy * ocy + ocz * ocz - r2
    disc = b * b - 4.0 * a_quad * cc
    t = (-b - jnp.sqrt(jnp.maximum(disc, 0.0))) / (2.0 * a_quad)
    return t, (disc >= 0.0) & (t >= t_min)


def _any(mask):
    """Block-uniform 'any lane set' (Triton has no boolean reduction)."""
    return jnp.max(jnp.where(mask, 1, 0)) > 0


def _make_kernel(SP: int, n_sph: int, n_tri: int, n_clu: int, n_sup: int,
                 t_min: float, t_max: float, anyhit: bool):
    def kernel(ray_ref, sph_ref, tri_ref, clu_ref, sup_ref, *out_refs):
        o = tuple(ray_ref[k, :] for k in range(3))
        d = tuple(ray_ref[3 + k, :] for k in range(3))
        alive = ray_ref[6, :] > 0.5
        # substitute a huge finite reciprocal for axis-parallel rays: IEEE
        # inf would give 0 * inf = NaN where a box face meets the origin
        invd = tuple(1.0 / jnp.where(dk == 0.0, 1e-30, dk) for dk in d)
        a_quad = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]

        def fold(t, ok, pid, carry):
            bt, bi = carry
            better = ok & (t < bt)
            if anyhit:                  # settled: no later box passes
                return jnp.where(better, -jnp.inf, bt), bi
            return jnp.where(better, t, bt), jnp.where(better, pid, bi)

        def sphere_body(k, carry):
            t, ok = _sphere_pairs(
                (sph_ref[k, 0], sph_ref[k, 1], sph_ref[k, 2]),
                sph_ref[k, 3], o, d, a_quad, t_min)
            return fold(t, ok & (sph_ref[k, 4] > 0.5), k, carry)

        def tri_body(j, carry):
            row = [tri_ref[j, m] for m in range(13)]
            t, ok = _mt_pairs(row[0:3], row[3:6], row[6:9], row[9:12],
                              o, d, t_min)
            return fold(t, ok & (row[12] > 0.5), SP + j, carry)

        def entered(box_ref, b, bt):
            tn, tf = _slab_test(
                (box_ref[b, 0], box_ref[b, 1], box_ref[b, 2]),
                (box_ref[b, 3], box_ref[b, 4], box_ref[b, 5]),
                o, invd, t_min)
            return _any((tf >= tn) & (tn < bt))

        def cluster_body(c, carry):
            def run(cr):
                start = c * CLUSTER
                return jax.lax.fori_loop(
                    start, jnp.minimum(start + CLUSTER, n_tri), tri_body, cr)
            return jax.lax.cond(entered(clu_ref, c, carry[0]), run,
                                lambda cr: cr, carry)

        def super_body(s, carry):
            def run(cr):
                start = s * SUPER
                return jax.lax.fori_loop(
                    start, jnp.minimum(start + SUPER, n_clu), cluster_body,
                    cr)
            return jax.lax.cond(entered(sup_ref, s, carry[0]), run,
                                lambda cr: cr, carry)

        carry = (jnp.where(alive, t_max, -jnp.inf),
                 jnp.full(alive.shape, BIG_ID, jnp.int32))
        if n_sph:
            carry = jax.lax.cond(
                _any(carry[0] > -jnp.inf),
                lambda cr: jax.lax.fori_loop(0, n_sph, sphere_body, cr),
                lambda cr: cr, carry)
        if n_tri:
            carry = jax.lax.fori_loop(0, n_sup, super_body, carry)
        bt, bi = carry
        if anyhit:
            out_refs[0][...] = jnp.where((bt == -jnp.inf) & alive, 1, 0)
        else:
            hit = bi != BIG_ID
            out_refs[0][...] = jnp.where(hit, bt, jnp.inf)
            out_refs[1][...] = jnp.where(hit, bi, 0)

    return kernel


@functools.partial(jax.jit, static_argnames=("t_min", "t_max", "anyhit",
                                             "interpret"))
def _call(scene: Scene, o, d, alive, t_min, t_max, anyhit, interpret):
    R = o.shape[0]
    Rp = -(-R // RB) * RB
    alive_f = (jnp.ones((R,), jnp.float32) if alive is None
               else alive.astype(jnp.float32))
    rays = jnp.concatenate([o, d, alive_f[:, None]], axis=1).T    # (7, R)
    rays = jnp.pad(rays.astype(jnp.float32), ((0, 1), (0, Rp - R)))
    sph = _sphere_planes(scene)
    tri = _tri_planes(scene)
    clu, sup = _boxes(scene)
    kernel = _make_kernel(scene.padded_spheres, scene.num_spheres,
                          scene.num_tris, clu.shape[0], sup.shape[0],
                          float(t_min), float(t_max), anyhit)

    def whole(x):
        return pl.BlockSpec(x.shape, lambda i: (0, 0))

    lanes = pl.BlockSpec((RB,), lambda i: (i,))
    if anyhit:
        out_shape = [jax.ShapeDtypeStruct((Rp,), jnp.int32)]
    else:
        out_shape = [jax.ShapeDtypeStruct((Rp,), jnp.float32),
                     jax.ShapeDtypeStruct((Rp,), jnp.int32)]
    outs = pl.pallas_call(
        kernel,
        grid=(Rp // RB,),
        in_specs=[pl.BlockSpec((8, RB), lambda i: (0, i)),
                  whole(sph), whole(tri), whole(clu), whole(sup)],
        out_specs=[lanes] * len(out_shape),
        out_shape=out_shape,
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name="any_hit" if anyhit else "closest_hit",
    )(rays, sph, tri, clu, sup)
    if anyhit:
        return outs[0][:R] > 0
    return outs[0][:R], outs[1][:R]


def nearest_hit_pallas(scene: Scene, o, d, t_min=1e-4, alive=None,
                       interpret=False):
    """Closest hit for (R, 3) rays → (t (R,), prim_id (R,) int32), a
    drop-in for ops.intersect.nearest_hit_jnp (same id convention). R is
    padded to whole ray blocks internally. Dead lanes (``alive`` False)
    return a miss. Off the GPU the kernel runs only with ``interpret``."""
    return _call(scene, o, d, alive, t_min, float("inf"), False,
                 kernel_interpret(interpret))


def anyhit_pallas(scene: Scene, o, d, t_min=1e-4, t_max=1.0 - 1e-3,
                  alive=None, interpret=False):
    """Shadow query: True where some primitive intersects o + t·d with t
    in [t_min, t_max) (t in units of |d|, so d spans the segment). Dead
    lanes are never blocked."""
    return _call(scene, o, d, alive, t_min, float(t_max), True,
                 kernel_interpret(interpret))
