"""Winner attributes on the kernel path vs the jnp oracle path.

The kernel (in the Pallas interpreter here) finds the winners; both paths
share the differentiable recompute (hit_attributes)."""

import numpy as np
import jax
import jax.numpy as jnp

import ray_tracer as rt
from ray_tracer.ops.intersect import hit_attributes, intersect, nearest_hit_jnp


def kernel_intersect(scene, o, d, t_min, alive):
    return intersect(scene, o, d, t_min, backend="pallas", alive=alive,
                     interpret=True)


def _rand_rays(n, seed=0):
    rng = np.random.default_rng(seed)
    o = jnp.asarray(rng.normal(size=(n, 3)) * 5, jnp.float32)
    d = jnp.asarray(rng.normal(size=(n, 3)), jnp.float32)
    return o, d


def _check_scene(scene, o, d):
    fused = kernel_intersect(scene, o, d, 1e-4, None)
    t_ref, pid = nearest_hit_jnp(scene, o, d, 1e-4)
    ref = hit_attributes(scene, o, d, pid, jnp.isinf(t_ref), 1e-4)
    np.testing.assert_array_equal(np.asarray(fused.hit), np.asarray(ref.hit))
    m = np.asarray(ref.hit)
    for field in ("normal", "albedo", "emission"):
        np.testing.assert_allclose(np.asarray(getattr(fused, field))[m],
                                   np.asarray(getattr(ref, field))[m],
                                   rtol=5e-4, atol=2e-5, err_msg=field)
    np.testing.assert_allclose(np.asarray(fused.emission_strength)[m],
                               np.asarray(ref.emission_strength)[m], atol=1e-5)
    np.testing.assert_allclose(np.asarray(fused.smoothness)[m],
                               np.asarray(ref.smoothness)[m], atol=1e-5)
    np.testing.assert_allclose(np.asarray(fused.t)[m], np.asarray(ref.t)[m],
                               rtol=5e-4)


def test_fused_attrs_spheres_and_tris():
    scene, _ = rt.builtin_scene("room", pad=128)
    _check_scene(scene, *_rand_rays(384, seed=1))


def test_fused_attrs_many_spheres():
    scene, _ = rt.builtin_scene("random_balls", seed=3, pad=128)
    _check_scene(scene, *_rand_rays(384, seed=2))


def test_fused_attrs_mesh():
    rng = np.random.default_rng(5)
    b = rt.SceneBuilder()
    for t in rng.normal(size=(80, 3, 3)) * 4:
        b.add_mesh(t, rng.normal(size=(3, 3)), [0, 1, 2],
                   albedo=tuple(rng.random(3)),
                   emission=tuple(rng.random(3)),
                   emission_strength=float(rng.random()),
                   smoothness=float(rng.random()))
    scene = b.build(pad=128)
    _check_scene(scene, *_rand_rays(384, seed=4))


def _textured_scene():
    rng = np.random.default_rng(11)
    b = rt.SceneBuilder()
    tex = rng.random((8, 8, 3)).astype(np.float32)
    nmap = np.full((8, 8, 3), 0.5, np.float32)
    nmap[..., 2] = 1.0
    nmap[:4, :, 0] = 0.8            # non-trivial normal perturbation
    ti = b.add_texture(tex, srgb=False)
    ni = b.add_texture(nmap, srgb=False)
    b.add_mesh([(0, 0, 2), (1, 0, 2), (0, 1, 2)], [(0, 0, -1)] * 3,
               [0, 2, 1], albedo=(1, 1, 1), smoothness=0.1,
               uvs=[(0, 0), (1, 0), (0, 1)], tex=ti, normal_tex=ni)
    b.add_mesh([(-1, -1, 3), (0.5, -1, 3), (-1, 0.5, 3)], [(0, 0, -1)] * 3,
               [0, 2, 1], albedo=(0.5, 0.7, 0.9),
               uvs=[(0, 1), (1, 1), (0, 0)], tex=ti)
    b.add_sphere((0.2, 0.2, 4), 0.8, albedo=(0.9, 0.2, 0.1))
    return b.build(pad=128)


def test_fused_attrs_textured():
    """Textured scenes: albedo modulation and normal mapping through the
    kernel's winners must match the hit_attributes oracle on every hit
    lane."""
    scene = _textured_scene()
    assert scene.num_textures == 2
    n = 256
    th = np.linspace(-0.25, 0.25, n)
    o = jnp.zeros((n, 3), jnp.float32)
    d = jnp.asarray(np.stack([np.sin(th), np.sin(th[::-1]) * 0.8,
                              np.ones(n)], -1), jnp.float32)
    fused = kernel_intersect(scene, o, d, 1e-4, None)
    t_ref, pid = nearest_hit_jnp(scene, o, d, 1e-4)
    ref = hit_attributes(scene, o, d, pid, jnp.isinf(t_ref), 1e-4)
    m = np.asarray(ref.hit)
    assert m.sum() > 50
    np.testing.assert_array_equal(np.asarray(fused.hit), m)
    for field in ("normal", "albedo", "emission", "t"):
        np.testing.assert_allclose(np.asarray(getattr(fused, field))[m],
                                   np.asarray(getattr(ref, field))[m],
                                   rtol=5e-4, atol=2e-5, err_msg=field)
    # sphere winner must be untextured (tex=-1 passthrough: exact albedo)
    sph = m & (np.asarray(ref.prim_id) < scene.padded_spheres)
    if sph.any():
        want = np.broadcast_to([0.9, 0.2, 0.1],
                               np.asarray(fused.albedo)[sph].shape)
        np.testing.assert_allclose(np.asarray(fused.albedo)[sph], want,
                                   atol=2e-5)


def test_fused_gradients_match_oracle():
    """Gradients through the kernel path reproduce the jnp path's."""
    scene, _ = rt.builtin_scene("metal", pad=128)
    o, d = _rand_rays(128, seed=6)

    def loss_fused(albedo):
        import dataclasses
        s = dataclasses.replace(scene, sphere_albedo=albedo)
        h = kernel_intersect(s, o, d, 1e-4, None)
        return jnp.sum(jnp.where(h.hit[:, None], h.albedo + h.normal, 0.0))

    def loss_ref(albedo):
        import dataclasses
        s = dataclasses.replace(scene, sphere_albedo=albedo)
        h = intersect(s, o, d, backend="jnp")
        return jnp.sum(jnp.where(h.hit[:, None], h.albedo + h.normal, 0.0))

    g_fused = np.asarray(jax.grad(loss_fused)(scene.sphere_albedo))
    g_ref = np.asarray(jax.grad(loss_ref)(scene.sphere_albedo))
    np.testing.assert_allclose(g_fused, g_ref, rtol=1e-4, atol=1e-6)


def test_renderer_uses_fused_and_matches_jnp():
    scene, cam = rt.builtin_scene("room", aspect=1.0)
    basis = rt.camera_basis(cam)
    from ray_tracer.renderer import render_frame
    p_j = rt.RenderParams(width=16, height=16, bounces=2, skybox=True,
                          backend="jnp")
    p_p = p_j.replace(backend="pallas", interpret=True)
    a = np.asarray(render_frame(scene, basis, p_j, jnp.int32(0)))
    b = np.asarray(render_frame(scene, basis, p_p, jnp.int32(0)))
    np.testing.assert_allclose(a, b, rtol=2e-3, atol=1e-4)


def test_fused_bitexact_same_winner():
    """The kernel path and the oracle share the SAME recompute
    (hit_attributes) on the same table rows, so every Hit field must match
    exactly (not allclose) wherever the winner ids agree (they can differ
    only on exact-t ties)."""
    scene, _ = rt.builtin_scene("room", pad=128)
    o, d = _rand_rays(384, seed=7)
    fused = kernel_intersect(scene, o, d, 1e-4, None)
    t_ref, pid = nearest_hit_jnp(scene, o, d, 1e-4)
    ref = hit_attributes(scene, o, d, pid, jnp.isinf(t_ref), 1e-4)
    same = (np.asarray(ref.hit)
            & (np.asarray(fused.prim_id) == np.asarray(pid)))
    assert same.sum() > 50
    for field in ("t", "point", "normal", "albedo", "emission",
                  "emission_strength", "smoothness"):
        np.testing.assert_array_equal(
            np.asarray(getattr(fused, field))[same],
            np.asarray(getattr(ref, field))[same], err_msg=field)
