"""Larger scenes through the kernel vs the jnp oracle.

Scenes of a few thousand triangles span several super-clusters (8
clusters of 64 triangles each), so the kernel's two-level walk, winner
replacement across clusters and the cluster culling all take part. The
kernel runs in the Pallas interpreter here.
"""

import numpy as np
import jax.numpy as jnp

import ray_tracer as rt
from ray_tracer.ops.intersect import (hit_attributes, intersect,
                                      nearest_hit_jnp)
from ray_tracer.ops.pallas_intersect import nearest_hit_pallas

INTERPRET = True


def _random_rays(n, seed=0, spread=6.0):
    rng = np.random.default_rng(seed)
    o = jnp.asarray(rng.normal(size=(n, 3)) * spread, jnp.float32)
    d = jnp.asarray(rng.normal(size=(n, 3)), jnp.float32)
    return o, d


def _mesh_scene(n_tris=300, seed=3, with_spheres=True):
    rng = np.random.default_rng(seed)
    b = rt.SceneBuilder()
    for _ in range(n_tris):
        c = rng.normal(size=3) * 4.0
        v = c + rng.normal(size=(3, 3))
        n = np.cross(v[1] - v[0], v[2] - v[0])
        n /= max(np.linalg.norm(n), 1e-9)
        b.add_mesh([tuple(x) for x in v], [tuple(n)] * 3, [0, 1, 2],
                   albedo=tuple(rng.random(3)),
                   smoothness=float(rng.random()))
    if with_spheres:
        for _ in range(6):
            b.add_sphere(tuple(rng.normal(size=3) * 4.0),
                         0.5 + rng.random(),
                         albedo=tuple(rng.random(3)))
    return b.build(pad=128)


def _check_t_id(scene, o, d):
    t_ref, id_ref = nearest_hit_jnp(scene, o, d, 1e-4)
    t_blk, id_blk = nearest_hit_pallas(scene, o, d, 1e-4,
                                       interpret=INTERPRET)
    t_ref, t_blk = np.asarray(t_ref), np.asarray(t_blk)
    hit_ref, hit_blk = np.isfinite(t_ref), np.isfinite(t_blk)
    np.testing.assert_array_equal(hit_ref, hit_blk)
    np.testing.assert_allclose(t_blk[hit_blk], t_ref[hit_ref], rtol=3e-4,
                               atol=1e-5)
    diff = (np.asarray(id_blk) != np.asarray(id_ref)) & hit_ref
    if diff.any():  # id ties must be t-equivalent
        np.testing.assert_allclose(t_blk[diff], t_ref[diff], rtol=3e-4)


def test_blocked_matches_oracle_multiblock():
    scene = _mesh_scene(2400)  # 38 clusters in 5 super-clusters
    _check_t_id(scene, *_random_rays(384, seed=11, spread=8.0))


def test_blocked_attrs_winner_replacement():
    """Winner attributes must follow the winner even when a later cluster
    beats an earlier cluster's (or a sphere's) best hit: the Hit fields
    equal the oracle's wherever the ids agree, and miss lanes report no
    hit."""
    scene = _mesh_scene(2400, seed=5)
    o, d = _random_rays(384, seed=13, spread=8.0)
    h = intersect(scene, o, d, backend="pallas", interpret=INTERPRET)
    t_ref, id_ref = nearest_hit_jnp(scene, o, d, 1e-4)
    hitm = np.isfinite(np.asarray(t_ref))
    assert hitm.sum() > 30
    ref = hit_attributes(scene, o, d, id_ref, ~hitm, 1e-4)
    same = hitm & (np.asarray(h.prim_id) == np.asarray(id_ref))
    assert same.sum() > 30
    for field in ("t", "normal", "albedo", "smoothness"):
        np.testing.assert_array_equal(np.asarray(getattr(h, field))[same],
                                      np.asarray(getattr(ref, field))[same],
                                      err_msg=field)
    np.testing.assert_array_equal(np.asarray(h.hit), hitm)


def test_blocked_alive_mask_and_padding():
    """Dead lanes return miss; ray counts that don't divide the step pad
    correctly; an all-dead call survives."""
    scene = _mesh_scene(1200, seed=6, with_spheres=False)
    o, d = _random_rays(200, seed=14, spread=8.0)  # 200 % 128 != 0
    alive = jnp.asarray(np.arange(200) % 3 != 0)
    t, pid = nearest_hit_pallas(scene, o, d, alive=alive,
                                interpret=INTERPRET)
    assert np.isinf(np.asarray(t)[~np.asarray(alive)]).all()
    t_ref, _ = nearest_hit_jnp(scene, o, d, 1e-4)
    live = np.asarray(alive) & np.isfinite(np.asarray(t_ref))
    np.testing.assert_allclose(np.asarray(t)[live], np.asarray(t_ref)[live],
                               rtol=3e-4, atol=1e-5)
    t0, _ = nearest_hit_pallas(scene, o, d, alive=jnp.zeros(200, bool),
                               interpret=INTERPRET)
    assert np.isinf(np.asarray(t0)).all()


def test_blocked_occlusion_fallback():
    """occluded() through the kernel on a multi-super-cluster scene agrees
    with the jnp oracle."""
    from ray_tracer.ops.intersect import occluded
    scene = _mesh_scene(1200, seed=9)
    o, d = _random_rays(256, seed=17, spread=4.0)
    want = np.asarray(occluded(scene, o, d, backend="jnp"))
    got = np.asarray(occluded(scene, o, d, backend="pallas",
                              interpret=INTERPRET))
    assert want.any() and not want.all()
    np.testing.assert_array_equal(got, want)


def test_blocked_textured_fused():
    """The kernel path on a textured scene of several super-clusters:
    winners + texture fetch must match the hit_attributes oracle."""
    rng = np.random.default_rng(21)
    b = rt.SceneBuilder()
    tex = rng.random((8, 8, 3)).astype(np.float32)
    ti = b.add_texture(tex, srgb=False)
    for k in range(1100):  # 18 clusters in 3 super-clusters
        c = rng.normal(size=3) * 3.0
        v = c + rng.normal(size=(3, 3))
        n = np.cross(v[1] - v[0], v[2] - v[0])
        n /= max(np.linalg.norm(n), 1e-9)
        b.add_mesh([tuple(x) for x in v], [tuple(n)] * 3, [0, 1, 2],
                   albedo=(1.0, 0.9, 0.8), smoothness=0.2,
                   uvs=[(0, 0), (1, 0), (0, 1)], tex=ti)
    scene = b.build(pad=128)
    assert scene.padded_tris >= 256 and scene.num_textures == 1
    # origins inside the triangle cloud -> plenty of hit lanes
    o, d = _random_rays(256, seed=15, spread=1.0)

    fused = intersect(scene, o, d, backend="pallas", interpret=INTERPRET)
    t_ref, pid = nearest_hit_jnp(scene, o, d, 1e-4)
    ref = hit_attributes(scene, o, d, pid, jnp.isinf(t_ref), 1e-4)
    m = np.asarray(ref.hit)
    assert m.sum() > 30
    np.testing.assert_array_equal(np.asarray(fused.hit), m)
    for field in ("normal", "albedo", "t"):
        np.testing.assert_allclose(np.asarray(getattr(fused, field))[m],
                                   np.asarray(getattr(ref, field))[m],
                                   rtol=5e-4, atol=2e-5, err_msg=field)
