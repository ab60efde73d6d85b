"""Unit tests for the closest-hit oracle against analytic geometry
(reference semantics: shaders/ray_tracer.wgsl:106-185)."""

import numpy as np
import jax.numpy as jnp

from ray_tracer import SceneBuilder
from ray_tracer.ops.intersect import (
    intersect, nearest_hit_jnp, sphere_ts, triangle_ts)


def _rays(*pairs):
    o = jnp.asarray([p[0] for p in pairs], jnp.float32)
    d = jnp.asarray([p[1] for p in pairs], jnp.float32)
    return o, d


def test_sphere_hit_distance_and_normal():
    scene = SceneBuilder().add_sphere((0, 0, -3), 1.0, (1, 0, 0)).build()
    o, d = _rays(((0, 0, 0), (0, 0, -1)))
    h = intersect(scene, o, d)
    assert bool(h.hit[0])
    assert abs(float(h.t[0]) - 2.0) < 1e-5
    np.testing.assert_allclose(np.asarray(h.point[0]), [0, 0, -2], atol=1e-5)
    np.testing.assert_allclose(np.asarray(h.normal[0]), [0, 0, 1], atol=1e-5)
    np.testing.assert_allclose(np.asarray(h.albedo[0]), [1, 0, 0], atol=1e-6)


def test_sphere_near_root_only_and_behind_miss():
    scene = SceneBuilder().add_sphere((0, 0, -3), 1.0, (1, 1, 1)).build()
    # Ray pointing away: both roots negative → miss (wgsl:113 dst >= 0)
    o, d = _rays(((0, 0, 0), (0, 0, 1)))
    h = intersect(scene, o, d)
    assert not bool(h.hit[0])
    # Origin inside the sphere: near root negative → the reference's
    # near-root-only test misses (no far-root fallback, wgsl:112-118)
    o, d = _rays(((0, 0, -3), (0, 0, -1)))
    h = intersect(scene, o, d)
    assert not bool(h.hit[0])


def test_unnormalized_direction_scales_t():
    scene = SceneBuilder().add_sphere((0, 0, -4), 1.0, (1, 1, 1)).build()
    o, d = _rays(((0, 0, 0), (0, 0, -2)))
    h = intersect(scene, o, d)
    # t is in units of |d|: hit point at z=-3 → t = 1.5
    assert abs(float(h.t[0]) - 1.5) < 1e-5
    np.testing.assert_allclose(np.asarray(h.point[0]), [0, 0, -3], atol=1e-5)


def test_triangle_hit_barycentric_normal_and_backface_cull():
    verts = [(-1, -1, -2), (1, -1, -2), (0, 1, -2)]
    normals = [(1, 0, 0), (0, 1, 0), (0, 0, 1)]
    scene = (SceneBuilder()
             .add_mesh(verts, normals, [0, 1, 2], albedo=(0, 1, 0))
             .build())
    o, d = _rays(((0, -0.5, 0), (0, 0, -1)))
    h = intersect(scene, o, d)
    # Winding: e1=(2,0,0), e2=(1,2,0), n=e1×e2=(0,0,4); det=-d·n=4>0 → front
    assert bool(h.hit[0])
    assert abs(float(h.t[0]) - 2.0) < 1e-5
    # Barycentrics at (0,-0.5): a=(-1,-1), b=(1,-1), c=(0,1): u(b)=.375,
    # v(c)=.25, w(a)=.375 → blended normal ∝ (.375, .375, .25)
    n = np.asarray(h.normal[0])
    expected = np.array([0.375, 0.375, 0.25])
    expected /= np.linalg.norm(expected)
    np.testing.assert_allclose(n, expected, atol=1e-5)
    # Reversed ray direction → det < 0 → back-face culled (wgsl:140)
    o2, d2 = _rays(((0, -0.5, -4), (0, 0, 1)))
    h2 = intersect(scene, o2, d2)
    assert not bool(h2.hit[0])


def test_closest_of_sphere_and_triangle():
    verts = [(-2, -2, -1), (2, -2, -1), (0, 3, -1)]
    normals = [(0, 0, 1)] * 3
    scene = (SceneBuilder()
             .add_sphere((0, 0, -5), 1.0, (1, 0, 0))
             .add_mesh(verts, normals, [0, 1, 2], albedo=(0, 0, 1))
             .build())
    o, d = _rays(((0, 0, 0), (0, 0, -1)))
    h = intersect(scene, o, d)
    assert bool(h.hit[0])
    assert abs(float(h.t[0]) - 1.0) < 1e-5          # triangle wins at z=-1
    np.testing.assert_allclose(np.asarray(h.albedo[0]), [0, 0, 1], atol=1e-6)
    # From behind the triangle (back-face culled) the sphere wins
    o2, d2 = _rays(((0, 0, -8), (0, 0, 1)))
    h2 = intersect(scene, o2, d2)
    assert bool(h2.hit[0])
    np.testing.assert_allclose(np.asarray(h2.albedo[0]), [1, 0, 0], atol=1e-6)


def test_t_min_skips_self_intersection():
    scene = SceneBuilder().add_sphere((0, 0, -3), 1.0, (1, 1, 1)).build()
    # Origin exactly on the sphere pointing outward
    o, d = _rays(((0, 0, -2), (0, 0, 1)))
    h = intersect(scene, o, d, t_min=1e-4)
    assert not bool(h.hit[0])


def test_padding_is_inert():
    s64 = SceneBuilder().add_sphere((0, 0, -3), 1.0, (1, 1, 1)).build(pad=64)
    s256 = SceneBuilder().add_sphere((0, 0, -3), 1.0, (1, 1, 1)).build(pad=256)
    o = jnp.asarray(np.random.default_rng(0).normal(size=(32, 3)), jnp.float32)
    d = jnp.asarray(np.random.default_rng(1).normal(size=(32, 3)), jnp.float32)
    h1, h2 = intersect(s64, o, d), intersect(s256, o, d)
    np.testing.assert_array_equal(np.asarray(h1.hit), np.asarray(h2.hit))
    np.testing.assert_allclose(np.asarray(h1.t), np.asarray(h2.t), atol=1e-6)


def test_nearest_hit_matches_bruteforce_numpy():
    rng = np.random.default_rng(42)
    b = SceneBuilder()
    centers = rng.normal(size=(20, 3)) * 3
    radii = rng.uniform(0.2, 1.0, 20)
    for c, r in zip(centers, radii):
        b.add_sphere(tuple(c), float(r), (1, 1, 1))
    tris = rng.normal(size=(30, 3, 3)) * 3
    for t in tris:
        b.add_mesh(t, np.ones((3, 3)), [0, 1, 2])
    scene = b.build()

    o = jnp.asarray(rng.normal(size=(64, 3)) * 5, jnp.float32)
    d = jnp.asarray(rng.normal(size=(64, 3)), jnp.float32)
    t_best, pid = nearest_hit_jnp(scene, o, d, 1e-4)

    # independent: min over per-primitive t arrays
    ts = np.asarray(sphere_ts(scene, o, d, 1e-4))
    tt = np.asarray(triangle_ts(scene, o, d, 1e-4))
    expected = np.minimum(ts.min(1), tt.min(1))
    np.testing.assert_allclose(np.asarray(t_best), expected, rtol=1e-6)
