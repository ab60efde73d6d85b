"""Pallas closest-hit kernel vs the jnp oracle.

On the CPU test harness the kernel runs in the Pallas interpreter (asked
for explicitly); tests/test_kernel.py also runs its cases compiled on the
GPU.
"""

import numpy as np
import jax.numpy as jnp

import ray_tracer as rt
from ray_tracer.ops.intersect import nearest_hit_jnp, occluded
from ray_tracer.ops.pallas_intersect import nearest_hit_pallas

INTERPRET = True


def _random_rays(n, seed=0, spread=6.0):
    rng = np.random.default_rng(seed)
    o = jnp.asarray(rng.normal(size=(n, 3)) * spread, jnp.float32)
    d = jnp.asarray(rng.normal(size=(n, 3)), jnp.float32)
    return o, d


def _check(scene, o, d, t_min=1e-4):
    t_ref, id_ref = nearest_hit_jnp(scene, o, d, t_min)
    t_pal, id_pal = nearest_hit_pallas(scene, o, d, t_min, interpret=INTERPRET)
    t_ref, t_pal = np.asarray(t_ref), np.asarray(t_pal)
    id_ref, id_pal = np.asarray(id_ref), np.asarray(id_pal)
    hit_ref, hit_pal = np.isfinite(t_ref), np.isfinite(t_pal)
    np.testing.assert_array_equal(hit_ref, hit_pal)
    # tolerance covers fma/reassociation differences between the kernel's
    # explicit component math and the oracle's vector reductions
    np.testing.assert_allclose(t_pal[hit_pal], t_ref[hit_ref], rtol=3e-4,
                               atol=1e-5)
    # ids may legitimately differ on exact t ties; require t-equivalence
    diff = (id_pal != id_ref) & hit_ref
    if diff.any():
        np.testing.assert_allclose(t_pal[diff], t_ref[diff], rtol=3e-4)


def test_spheres_only():
    scene, _ = rt.builtin_scene("metal", pad=128)
    _check(scene, *_random_rays(256, seed=1))


def test_many_spheres():
    scene, _ = rt.builtin_scene("random_balls", seed=5, pad=128)
    _check(scene, *_random_rays(256, seed=2, spread=10.0))


def test_spheres_and_triangles():
    scene, _ = rt.builtin_scene("room", pad=128)
    _check(scene, *_random_rays(256, seed=3))


def test_triangles_only():
    rng = np.random.default_rng(7)
    b = rt.SceneBuilder()
    for t in rng.normal(size=(50, 3, 3)) * 4:
        b.add_mesh(t, np.ones((3, 3)), [0, 1, 2])
    scene = b.build(pad=128)
    _check(scene, *_random_rays(256, seed=4))


def test_ragged_ray_count():
    scene, _ = rt.builtin_scene("room", pad=128)
    _check(scene, *_random_rays(77, seed=5))  # not a multiple of RT=128


def test_all_miss():
    scene = rt.SceneBuilder().add_sphere((0, 0, -5), 0.5, (1, 1, 1)).build(pad=128)
    o = jnp.tile(jnp.asarray([[0.0, 0.0, 0.0]]), (128, 1))
    d = jnp.tile(jnp.asarray([[0.0, 0.0, 1.0]]), (128, 1))  # away from sphere
    t, pid = nearest_hit_pallas(scene, o, d, interpret=INTERPRET)
    assert np.isinf(np.asarray(t)).all()


def test_alive_mask_dead_lanes_miss():
    scene, _ = rt.builtin_scene("room", pad=128)
    o, d = _random_rays(256, seed=9)
    alive = jnp.asarray(np.arange(256) % 2 == 0)
    t, pid = nearest_hit_pallas(scene, o, d, alive=alive, interpret=INTERPRET)
    t_ref, _ = nearest_hit_jnp(scene, o, d, 1e-4)
    t, t_ref = np.asarray(t), np.asarray(t_ref)
    # dead lanes always miss; live lanes match the oracle
    assert np.isinf(t[1::2]).all()
    np.testing.assert_allclose(t[0::2][np.isfinite(t[0::2])],
                               t_ref[0::2][np.isfinite(t[0::2])], rtol=3e-4)


def test_morton_sort_preserves_images():
    verts = np.random.default_rng(11).normal(size=(60, 3, 3)) * 3
    def build(sort):
        b = rt.SceneBuilder()
        for t in verts:
            b.add_mesh(t, np.ones((3, 3)), [0, 1, 2])
        return b.build(pad=128, sort_tris=sort)
    s1, s2 = build(False), build(True)
    o, d = _random_rays(128, seed=12)
    t1, _ = nearest_hit_jnp(s1, o, d, 1e-4)
    t2, _ = nearest_hit_jnp(s2, o, d, 1e-4)
    np.testing.assert_allclose(np.asarray(t1), np.asarray(t2), rtol=1e-6)


def test_renderer_pallas_backend_matches_jnp():
    scene, cam = rt.builtin_scene("room", aspect=1.0)
    basis = rt.camera_basis(cam)
    from ray_tracer.renderer import render_frame
    p_j = rt.RenderParams(width=16, height=16, bounces=2, skybox=True,
                          backend="jnp")
    img_j = render_frame(scene, basis, p_j, jnp.int32(0))
    p_p = rt.RenderParams(width=16, height=16, bounces=2, skybox=True,
                          backend="pallas", interpret=True)
    img_p = render_frame(scene, basis, p_p, jnp.int32(0))
    np.testing.assert_allclose(np.asarray(img_j), np.asarray(img_p),
                               rtol=1e-4, atol=1e-5)


def test_renderer_backends_match_with_coherent_scatter():
    """coherent_scatter shares tile draws at the RENDERER level, so both
    backends (blocked pixel order for both) must stay bit-comparable."""
    scene, cam = rt.builtin_scene("room", aspect=1.0)
    basis = rt.camera_basis(cam)
    from ray_tracer.renderer import render_frame
    kw = dict(width=16, height=16, bounces=2, skybox=True,
              coherent_scatter=True)
    img_j = render_frame(scene, basis,
                         rt.RenderParams(backend="jnp", **kw), jnp.int32(0))
    img_p = render_frame(scene, basis,
                         rt.RenderParams(backend="pallas", interpret=True,
                                         **kw),
                         jnp.int32(0))
    np.testing.assert_allclose(np.asarray(img_j), np.asarray(img_p),
                               rtol=1e-4, atol=1e-5)


def test_anyhit_matches_oracle_room():
    """Kernel shadow query == jnp occlusion oracle (random segments)."""

    scene, _ = rt.builtin_scene("room", aspect=1.0)
    rng = np.random.default_rng(3)
    R = 640
    o = jnp.asarray(rng.uniform(-1.5, 1.5, (R, 3)) + [3, 1.5, 0], jnp.float32)
    tgt = jnp.asarray(rng.uniform(-2, 2, (R, 3)) + [3, 1.5, 0], jnp.float32)
    d = tgt - o
    got = np.asarray(occluded(scene, o, d, backend="pallas",
                              interpret=INTERPRET))
    t, _ = nearest_hit_jnp(scene, o, d, 1e-4)
    want = np.asarray(t < 1.0 - 1e-3)
    np.testing.assert_array_equal(got, want)


def test_anyhit_alive_mask_and_tmax():
    scene, _ = rt.builtin_scene("metal", aspect=1.0)
    R = 256
    # aim at the center sphere (at origin area) from z = +5
    o = jnp.tile(jnp.asarray([[0.0, 0.0, 3.0]], jnp.float32), (R, 1))
    d = jnp.tile(jnp.asarray([[0.0, 0.0, -6.0]], jnp.float32), (R, 1))
    alive = jnp.arange(R) % 2 == 0
    got = np.asarray(occluded(scene, o, d, backend="pallas", alive=alive,
                              interpret=INTERPRET))
    assert got[::2].all()          # live lanes: blocked by the spheres
    assert not got[1::2].any()     # dead lanes: never blocked
    # a segment too short to reach the sphere is unoccluded
    short = np.asarray(occluded(scene, o, d * 0.1, backend="pallas",
                                interpret=INTERPRET))
    assert not short.any()


def _mesh_with_sphere(n_tris, seed):
    rng = np.random.default_rng(seed)
    b = rt.SceneBuilder()
    for t in rng.normal(size=(n_tris, 3, 3)) * 5:
        b.add_mesh(t, np.ones((3, 3)), [0, 1, 2])
    b.add_sphere((0, 0, 0), 1.5, (1, 0.5, 0.2), smoothness=0.4)
    return b.build(pad=128)


def _check_rows(scene, o, d):
    """Hits, t and the winners' merged-table rows against the oracle."""
    from ray_tracer.ops.intersect import _pack_attrs
    _check(scene, o, d)
    t_ref, id_ref = map(np.asarray, nearest_hit_jnp(scene, o, d, 1e-4))
    _, id_pal = nearest_hit_pallas(scene, o, d, interpret=INTERPRET)
    same = np.isfinite(t_ref) & (np.asarray(id_pal) == id_ref)
    table = np.asarray(_pack_attrs(scene))
    np.testing.assert_array_equal(table[np.asarray(id_pal)[same]],
                                  table[id_ref[same]])


def test_supers_two_level_prepass_parity():
    """The two-level walk (super-clusters of 8 clusters of 64 triangles)
    must be invisible to results, including a partial last super-cluster
    and a triangle count that is no multiple of the cluster size."""
    from ray_tracer.ops.pallas_intersect import CLUSTER, SUPER
    scene = _mesh_with_sphere(1100, seed=21)
    assert scene.num_tris > 2 * CLUSTER * SUPER
    assert scene.num_tris % (CLUSTER * SUPER) and scene.num_tris % CLUSTER
    _check_rows(scene, *_random_rays(512, seed=22, spread=8.0))


def test_supers_room_scene_parity():
    scene, _ = rt.builtin_scene("room", pad=128)
    _check_rows(scene, *_random_rays(256, seed=23))


def test_anyhit_engines_match_oracle():
    """Shadow queries on a mesh of several super-clusters: blocked-mask
    parity against the closest-hit oracle."""
    scene = _mesh_with_sphere(1100, seed=41)
    o, d = _random_rays(384, seed=42, spread=8.0)
    t_ref, _ = nearest_hit_jnp(scene, o, d, 1e-4)
    want = np.asarray(t_ref) < (1.0 - 1e-3)
    assert want.any() and not want.all()
    got = np.asarray(occluded(scene, o, d, backend="pallas",
                              interpret=INTERPRET))
    np.testing.assert_array_equal(got, want)
