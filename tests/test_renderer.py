"""End-to-end renderer tests: accumulation law, energy sanity, scenes."""

import numpy as np
import jax.numpy as jnp

import ray_tracer as rt


def _small(width=32, height=32, **kw):
    kw.setdefault("backend", "jnp")
    return rt.RenderParams(width=width, height=height, **kw)


def test_accumulate_recurrence_matches_reference():
    """new = prev*(1-w) + frame*w, w = 1/(frames+1) (wgsl:59-63):
    after n frames the image is the mean of the n frame images."""
    prev = jnp.zeros((4, 4, 3))
    frames = [jnp.full((4, 4, 3), float(i)) for i in range(5)]
    img = frames[0]  # frame 0 overwrites
    for i in range(1, 5):
        img = rt.accumulate(img, frames[i], i)
    np.testing.assert_allclose(np.asarray(img), np.mean([float(i) for i in range(5)]),
                               rtol=1e-6)


def test_emissive_only_scene_radiance():
    """A single fully-emissive englobing sphere: every primary ray hits it,
    radiance = emission_strength * emission_color (throughput 1 on first
    hit)."""
    scene = (rt.SceneBuilder()
             .add_sphere((0, 0, -3), 1.0, (0, 0, 0), emission=(1.0, 0.5, 0.25),
                         emission_strength=2.0)
             .build())
    cam = rt.Camera(origin=(0, 0, 0), look_at=(0, 0, -1), fov=10.0, aspect=1.0,
                    focus_dist=1.0)
    img = rt.render(scene, cam, _small(16, 16, bounces=0))
    img = np.asarray(img)
    np.testing.assert_allclose(
        img, np.broadcast_to([2.0, 1.0, 0.5], img.shape), rtol=1e-5)


def test_skybox_off_miss_is_black():
    scene = rt.SceneBuilder().add_sphere((0, 0, 100), 1.0, (1, 1, 1)).build()
    cam = rt.Camera(origin=(0, 0, 0), look_at=(0, 0, -1), aspect=1.0)
    img = np.asarray(rt.render(scene, cam, _small(8, 8, skybox=False)))
    np.testing.assert_allclose(img, 0.0, atol=1e-7)


def test_skybox_on_miss_is_env():
    scene = rt.SceneBuilder().add_sphere((0, 0, 100), 1.0, (1, 1, 1)).build()
    cam = rt.Camera(origin=(0, 0, 0), look_at=(0, 1, 0), fov=5.0, aspect=1.0)
    img = np.asarray(rt.render(scene, cam, _small(8, 8, skybox=True)))
    # Looking straight up: every pixel ≈ zenith + sun
    assert img.min() > 0.0
    assert np.allclose(img.mean((0, 1)),
                       np.asarray(rt.render(scene, cam, _small(8, 8, skybox=True))).mean((0, 1)),
                       atol=1e-6)


def test_render_deterministic_same_frame():
    scene, cam = rt.builtin_scene("metal", aspect=1.0)
    p = _small(16, 16, skybox=True)
    a = np.asarray(rt.render(scene, cam, p, frames=1))
    b = np.asarray(rt.render(scene, cam, p, frames=1))
    np.testing.assert_array_equal(a, b)


def test_progressive_frames_reduce_variance():
    scene, cam = rt.builtin_scene("metal", aspect=1.0)
    p = _small(16, 16, skybox=True)
    r1 = rt.Renderer(scene, cam, p)
    f0 = np.asarray(r1.step())
    r2 = rt.Renderer(scene, cam, p)
    many = None
    for _ in range(8):
        many = r2.step()
    many = np.asarray(many)
    # Same scene → similar mean, accumulated image differs from single frame
    assert abs(f0.mean() - many.mean()) < 0.2
    assert not np.array_equal(f0, many)
    assert r2.frames == 7


def test_all_builtin_scenes_render_finite():
    for name in ["balls", "random_balls", "room", "metal"]:
        scene, cam = rt.builtin_scene(name, aspect=1.0)
        img = np.asarray(rt.render(scene, cam, _small(8, 8, bounces=2, skybox=True)))
        assert np.isfinite(img).all(), name
        assert img.shape == (8, 8, 3)


def test_clear_accumulation_semantics():
    scene, cam = rt.builtin_scene("metal", aspect=1.0)
    r = rt.Renderer(scene, cam, _small(8, 8))
    r.step(); r.step()
    assert r.frames == 1
    r.clear_accumulation()
    assert r.frames == -1
    r.step()
    assert r.frames == 0


def test_energy_conservation_no_emission_no_sky():
    """Non-emissive closed-ish scene with sky off: radiance must be 0."""
    scene, cam = rt.builtin_scene("metal", aspect=1.0)
    img = np.asarray(rt.render(scene, cam, _small(8, 8, skybox=False)))
    np.testing.assert_allclose(img, 0.0, atol=1e-7)


def test_room_scene_lit_by_ceiling():
    scene, cam = rt.builtin_scene("room", aspect=1.0)
    img = np.asarray(rt.render(scene, cam, _small(24, 24, bounces=3), frames=4))
    assert img.max() > 0.05  # emissive ceiling illuminates the room
    assert np.isfinite(img).all()


def test_render_aov_channels():
    """Primary-ray AOVs: depth positive exactly where coverage says hit,
    normals unit-length on hits, albedo matches the scene's, pallas/jnp
    backends agree."""
    import ray_tracer as rt
    from ray_tracer.renderer import camera_basis, render_aov

    scene, cam = rt.builtin_scene("metal", aspect=1.0)
    params = rt.RenderParams(width=32, height=32, backend="jnp")
    basis = camera_basis(cam)
    depth = np.asarray(render_aov(scene, basis, params, "depth"))
    hit = np.asarray(render_aov(scene, basis, params, "hit"))
    normal = np.asarray(render_aov(scene, basis, params, "normal"))
    albedo = np.asarray(render_aov(scene, basis, params, "albedo"))
    assert depth.shape == (32, 32, 1) and normal.shape == (32, 32, 3)
    m = hit[..., 0] > 0.5
    assert m.any() and not m.all()
    assert (depth[..., 0][m] > 0).all() and (depth[..., 0][~m] == 0).all()
    np.testing.assert_allclose(np.linalg.norm(normal[m], axis=-1), 1.0,
                               atol=1e-4)
    assert (normal[~m] == 0).all()
    # albedo values come from the scene's material table
    pal = np.unique(np.round(albedo[m], 3), axis=0)
    assert len(pal) <= scene.num_spheres + 1
    # backend parity (the kernel in the Pallas interpreter)
    d2 = np.asarray(render_aov(scene, basis, params.replace(
        backend="pallas", interpret=True), "depth"))
    np.testing.assert_allclose(depth, d2, rtol=3e-4, atol=1e-5)


def test_render_aov_differentiable():
    """Depth AOV gradients flow to geometry (inverse-rendering target)."""
    import jax
    import jax.numpy as jnp
    import dataclasses
    import ray_tracer as rt
    from ray_tracer.renderer import camera_basis, render_aov

    scene, cam = rt.builtin_scene("metal", aspect=1.0)
    params = rt.RenderParams(width=16, height=16, backend="jnp")
    basis = camera_basis(cam)

    def loss(centers):
        s = dataclasses.replace(scene, sphere_center=centers)
        return jnp.sum(render_aov(s, basis, params, "depth"))

    g = np.asarray(jax.grad(loss)(scene.sphere_center))
    assert np.isfinite(g).all() and (g != 0).any()


def test_adaptive_sampling():
    """Zero-variance view (pure emitter fills the frame) converges after
    ONE chunk; a noisy scene runs to the cap with target 0; and the
    adaptive mean equals the progressive accumulation for equal frames."""
    import jax.numpy as jnp
    import ray_tracer as rt
    from ray_tracer.renderer import (camera_basis, render_adaptive,
                                         render_progressive)

    flat = (rt.SceneBuilder()
            .add_sphere((0, 0, -3), 2.0, (0, 0, 0), emission=(1, 1, 1),
                        emission_strength=2.0).build(pad=8))
    cam = rt.Camera(origin=(0, 0, 0), look_at=(0, 0, -1), fov=10.0,
                    aspect=1.0)
    params = rt.RenderParams(width=16, height=16, bounces=1, backend="jnp")
    basis = camera_basis(cam)
    img, used = render_adaptive(flat, basis, params, 64, 0.05, chunk=4)
    assert used == 4  # converged at the first check
    np.testing.assert_allclose(np.asarray(img), 2.0, rtol=1e-5)

    scene, cam2 = rt.builtin_scene("room", aspect=1.0)
    b2 = camera_basis(cam2)
    p2 = rt.RenderParams(width=16, height=16, bounces=2, skybox=True,
                         backend="jnp")
    img_a, used_a = render_adaptive(scene, b2, p2, 12, 0.0, chunk=4)
    assert used_a == 12  # unreachable target -> runs to the cap
    ref = np.asarray(render_progressive(scene, b2, p2, 12))
    np.testing.assert_allclose(np.asarray(img_a), ref, rtol=1e-4, atol=1e-6)


def test_clamp_firefly_suppression():
    """clamp bounds per-sample radiance; clamp=0 is bitwise reference."""
    import jax.numpy as jnp
    import ray_tracer as rt
    from ray_tracer.renderer import camera_basis, render_frame

    b = rt.SceneBuilder()
    b.add_sphere((0, 0, -4), 1.0, (0, 0, 0), emission=(1, 1, 1),
                 emission_strength=50.0)
    scene = b.build(pad=8)
    cam = rt.Camera(origin=(0, 0, 0), look_at=(0, 0, -1), fov=20.0,
                    aspect=1.0)
    basis = camera_basis(cam)
    p = rt.RenderParams(width=16, height=16, bounces=1, backend="jnp")
    a = np.asarray(render_frame(scene, basis, p, 0))
    assert a.max() > 10.0
    c = np.asarray(render_frame(scene, basis, p.replace(clamp=2.0), 0))
    assert c.max() <= 2.0 + 1e-6
    b2 = np.asarray(render_frame(scene, basis, p.replace(clamp=0.0), 0))
    np.testing.assert_array_equal(a, b2)


def test_russian_roulette_unbiased_and_off_bitwise():
    """rr_start=0 must be bitwise the reference transport (no RNG draw);
    rr_start=N must leave the converged image unchanged (unbiased — the
    survivors' 1/p boost exactly compensates the killed paths) on an
    enclosed scene where deep bounces carry real energy."""
    from ray_tracer.renderer import render_frame
    scene, cam = rt.builtin_scene("room", aspect=1.0)
    basis = rt.camera_basis(cam)
    p0 = rt.RenderParams(width=20, height=20, bounces=4, skybox=False,
                         backend="jnp")
    a = np.asarray(render_frame(scene, basis, p0, jnp.int32(0)))
    b = np.asarray(render_frame(scene, basis, p0.replace(rr_start=0),
                                jnp.int32(0)))
    np.testing.assert_array_equal(a, b)

    def mean_img(params, frames=220):
        return np.mean([np.asarray(render_frame(scene, basis, params,
                                                jnp.int32(i)))
                        for i in range(frames)], 0)

    m_off = mean_img(p0)
    m_rr = mean_img(p0.replace(rr_start=2))
    # image-average agreement within sampling error
    assert abs(m_rr.mean() - m_off.mean()) < 0.02 * max(m_off.mean(), 1e-3), (
        m_rr.mean(), m_off.mean())


def test_render_aov_blocked_order_nondivisible():
    """render_aov on the kernel backend routes through the blocked 16x8
    pixel order — the inverse permutation must
    restore raster order exactly, including at resolutions where the
    reshape/transpose unblock doesn't apply (W % 16 != 0)."""
    import ray_tracer as rt
    from ray_tracer.renderer import camera_basis, render_aov

    scene, cam = rt.builtin_scene("metal", aspect=1.0)
    basis = camera_basis(cam)
    for w, h in ((24, 20), (32, 24)):
        params = rt.RenderParams(width=w, height=h, backend="jnp")
        a = np.asarray(render_aov(scene, basis, params, "normal"))
        b = np.asarray(render_aov(scene, basis, params.replace(
            backend="pallas", interpret=True), "normal"))
        np.testing.assert_allclose(a, b, rtol=3e-4, atol=1e-5,
                                   err_msg=f"{w}x{h}")
