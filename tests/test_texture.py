"""Texture/UV/normal-map shading tests (extension; SURVEY Q10, BASELINE
config 3)."""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import ray_tracer as rt
from ray_tracer.texture import sample_bilinear, srgb_to_linear
from ray_tracer.renderer import render_frame

ASSETS = "/root/reference/assets"
needs_assets = pytest.mark.skipif(
    not os.path.isdir(ASSETS), reason="reference assets not available")


def test_bilinear_exact_texel_centers():
    tex = jnp.asarray(np.arange(4 * 4 * 3, dtype=np.float32).reshape(1, 4, 4, 3))
    # uv at the center of texel (1, 2): u=(2+0.5)/4, v=(1+0.5)/4
    uv = jnp.asarray([[2.5 / 4, 1.5 / 4]])
    out = sample_bilinear(tex, jnp.asarray([0]), uv)
    expected = np.arange(48).reshape(4, 4, 3)[1, 2]
    np.testing.assert_allclose(np.asarray(out)[0], expected, rtol=1e-6)


def test_bilinear_interpolates_and_wraps():
    tex = np.zeros((1, 2, 2, 3), np.float32)
    tex[0, 0, 0] = 1.0  # one white texel
    tex = jnp.asarray(tex)
    # halfway between texel centers horizontally
    out = sample_bilinear(tex, jnp.asarray([0]), jnp.asarray([[0.5, 0.25]]))
    np.testing.assert_allclose(np.asarray(out)[0], 0.5, atol=1e-6)
    # repeat wrap: uv + 1 must sample identically
    a = sample_bilinear(tex, jnp.asarray([0]), jnp.asarray([[0.13, 0.77]]))
    b = sample_bilinear(tex, jnp.asarray([0]), jnp.asarray([[1.13, -0.23]]))
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-6)


def test_untextured_id_returns_white():
    tex = jnp.zeros((1, 2, 2, 3))
    out = sample_bilinear(tex, jnp.asarray([-1]), jnp.asarray([[0.5, 0.5]]))
    np.testing.assert_allclose(np.asarray(out)[0], 1.0)


def _checker_scene(emission_strength=0.0):
    """A textured quad facing +z with a 2x2 checkerboard."""
    b = rt.SceneBuilder(texture_resolution=8)
    checker = np.zeros((2, 2, 3), np.float32)
    checker[0, 0] = checker[1, 1] = 1.0
    tid = b.add_texture((checker * 255).astype(np.uint8), srgb=False)
    verts = [(-1, -1, 0), (1, -1, 0), (1, 1, 0), (-1, 1, 0)]
    normals = [(0, 0, 1)] * 4
    uvs = [(0, 1), (1, 1), (1, 0), (0, 0)]
    b.add_mesh(verts, normals, [0, 1, 2, 0, 2, 3], albedo=(1, 1, 1),
               emission=(1, 1, 1), emission_strength=emission_strength,
               uvs=uvs, tex=tid)
    return b.build(pad=8)


def test_textured_albedo_at_hit():
    from ray_tracer.ops.intersect import intersect
    scene = _checker_scene()
    # uv(0.25, 0.25) → checker texel (0,0) = white; uv(0.75, 0.25) → black
    o = jnp.asarray([[-0.5, 0.5, 2.0], [0.5, 0.5, 2.0]])
    d = jnp.asarray([[0.0, 0.0, -1.0], [0.0, 0.0, -1.0]])
    h = intersect(scene, o, d, backend="jnp")
    assert bool(h.hit.all())
    a = np.asarray(h.albedo)
    # nearest-region check (bilinear on an 8x8 resize blurs edges)
    assert a[0].mean() > 0.7   # white square
    assert a[1].mean() < 0.3   # black square


def test_texture_gradients_flow_to_texels():
    scene = _checker_scene(emission_strength=0.0)
    cam = rt.Camera(origin=(0, 0, 3), look_at=(0, 0, 0), fov=45, aspect=1.0)
    basis = rt.camera_basis(cam)
    # one bounce so the sky radiance is modulated by the textured albedo
    params = rt.RenderParams(width=8, height=8, bounces=1, skybox=True,
                             backend="jnp")

    def loss(textures):
        import dataclasses
        s = dataclasses.replace(scene, textures=textures)
        img = render_frame(s, basis, params, jnp.int32(0))
        return jnp.mean(img)

    g = np.asarray(jax.grad(loss)(scene.textures))
    assert np.isfinite(g).all()
    assert np.abs(g).max() > 0  # gradients reach texels


def test_normal_map_tilts_shading_normal():
    from ray_tracer.ops.intersect import intersect
    b = rt.SceneBuilder(texture_resolution=4)
    # normal map pointing uniformly toward +u tangent direction
    nm = np.zeros((2, 2, 3), np.float32)
    nm[..., 0] = 1.0   # x -> +1 after decode
    nm[..., 1] = 0.5   # y -> 0
    nm[..., 2] = 0.5   # z -> 0 (fully tangent — extreme tilt)
    ntid = b.add_texture(nm, srgb=False)
    verts = [(-1, -1, 0), (1, -1, 0), (1, 1, 0), (-1, 1, 0)]
    normals = [(0, 0, 1)] * 4
    uvs = [(0, 1), (1, 1), (1, 0), (0, 0)]
    b.add_mesh(verts, normals, [0, 1, 2, 0, 2, 3], uvs=uvs, normal_tex=ntid)
    scene = b.build(pad=8)
    o = jnp.asarray([[0.0, 0.0, 2.0]])
    d = jnp.asarray([[0.0, 0.0, -1.0]])
    h = intersect(scene, o, d, backend="jnp")
    n = np.asarray(h.normal)[0]
    # tangent (+u direction in world) is +x for this UV layout
    assert abs(n[0]) > 0.9
    assert abs(n[2]) < 0.2


class TestGatedFetch:
    """sample_bilinear_gated: liveness-gated fetch must match the plain
    fetch on live lanes bit for bit, at every budget tier, with matching
    texel gradients (r5: the textured frame's largest line item)."""

    def _data(self, n_tiles, live_tiles, seed=0):
        rng = np.random.default_rng(seed)
        R = n_tiles * 128
        stack = jnp.asarray(rng.random((2, 16, 16, 3), np.float32))
        tex_id = jnp.asarray(
            rng.integers(-1, 2, R).astype(np.int32))
        uv = jnp.asarray(rng.random((R, 2), np.float32) * 2.0 - 0.5)
        live = np.zeros((n_tiles, 128), bool)
        idx = rng.choice(n_tiles, live_tiles, replace=False)
        # live tiles are PARTIALLY live (random lanes) — the gate must key
        # off any-lane liveness, not all-lane
        live[idx] = rng.random((live_tiles, 128)) < 0.7
        live[idx, 0] = True
        return stack, tex_id, uv, jnp.asarray(live.reshape(R))

    @pytest.mark.parametrize("live_tiles", [1, 2, 10, 30, 64])
    def test_matches_plain_on_live_lanes(self, live_tiles):
        from ray_tracer.texture import sample_bilinear_gated
        stack, tex_id, uv, live = self._data(64, live_tiles)
        plain = np.asarray(sample_bilinear(stack, tex_id, uv))
        gated = np.asarray(jax.jit(sample_bilinear_gated)(
            stack, tex_id, uv, live))
        lm = np.asarray(live)
        # ulp-level tolerance: the compacted fetch runs the same per-lane
        # arithmetic at a different array shape, which lets the backend
        # vectorize (fma-fuse) differently
        np.testing.assert_allclose(gated[lm], plain[lm],
                                   rtol=3e-7, atol=1e-7)

    def test_dead_tiles_white(self):
        from ray_tracer.texture import sample_bilinear_gated
        stack, tex_id, uv, live = self._data(64, 2)
        gated = np.asarray(sample_bilinear_gated(stack, tex_id, uv, live))
        tile_dead = ~np.asarray(live).reshape(64, 128).any(1)
        lanes_dead = np.repeat(tile_dead, 128)
        np.testing.assert_array_equal(gated[lanes_dead], 1.0)

    def test_fallbacks_to_plain(self):
        from ray_tracer.texture import sample_bilinear_gated
        stack, tex_id, uv, live = self._data(64, 3)
        # live=None, non-divisible R, too few tiles → plain everywhere
        for args in ((stack, tex_id, uv, None),
                     (stack, tex_id[:-3], uv[:-3], live[:-3]),
                     (stack, tex_id[:128 * 8], uv[:128 * 8],
                      live[:128 * 8])):
            out = np.asarray(sample_bilinear_gated(*args))
            ref = np.asarray(sample_bilinear(*args[:3]))
            np.testing.assert_array_equal(out, ref)

    @pytest.mark.parametrize("live_tiles", [2, 10])
    def test_texel_gradients_match(self, live_tiles):
        from ray_tracer.texture import sample_bilinear_gated
        stack, tex_id, uv, live = self._data(64, live_tiles, seed=1)
        w = jnp.asarray(
            np.random.default_rng(2).random((64 * 128, 3), np.float32))
        # live-lane-masked loss: the exact situation the renderer is in
        # (dead-lane albedo cotangents are zero by construction)
        wm = w * live[:, None]

        def loss_plain(s):
            return jnp.sum(sample_bilinear(s, tex_id, uv) * wm)

        def loss_gated(s):
            return jnp.sum(
                sample_bilinear_gated(s, tex_id, uv, live) * wm)

        gp = np.asarray(jax.grad(loss_plain)(stack))
        gg = np.asarray(jax.grad(loss_gated)(stack))
        np.testing.assert_allclose(gg, gp, atol=1e-6)


@needs_assets
def test_cube_obj_loads_with_textures():
    from ray_tracer.io import load_meshes
    meshes = load_meshes(os.path.join(ASSETS, "cube.obj"))
    m = meshes[0]
    assert m.uvs is not None and m.uvs.shape[0] == m.positions.shape[0]
    assert m.material is not None
    assert m.material.get("diffuse_image") is not None
    assert m.material.get("normal_image") is not None


@needs_assets
def test_cube_obj_textured_render():
    """BASELINE config 3: cube.obj with diffuse+normal textures."""
    from ray_tracer.io import load_model
    b = rt.SceneBuilder(texture_resolution=64)
    load_model(os.path.join(ASSETS, "cube.obj"), b, placement="origin")
    scene = b.build()
    assert scene.num_textures == 2
    assert int((np.asarray(scene.tri_tex) >= 0).sum()) == scene.num_tris
    cam = rt.Camera(origin=(3, 3, 3), look_at=(0.5, 0.5, -0.5), aspect=1.0)
    p = rt.RenderParams(width=12, height=12, bounces=1, skybox=True,
                        backend="jnp")
    img = np.asarray(rt.render(scene, cam, p, frames=2))
    assert np.isfinite(img).all()
    assert img.std() > 0.01  # textured variation visible
