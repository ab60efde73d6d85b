"""Material scattering math tests (shaders/ray_tracer.wgsl:236-295)."""

import numpy as np
import jax.numpy as jnp

from ray_tracer import materials


def test_reflect():
    d = jnp.asarray([[1.0, -1.0, 0.0]])
    n = jnp.asarray([[0.0, 1.0, 0.0]])
    r = materials.reflect(d, n)
    np.testing.assert_allclose(np.asarray(r), [[1.0, 1.0, 0.0]], atol=1e-6)


def test_refract_snell_angle():
    # 45° incidence from vacuum into n=1.5: sin(theta_t) = sin(45°)/1.5
    s = np.sqrt(0.5)
    d = jnp.asarray([[s, -s, 0.0]])
    n = jnp.asarray([[0.0, 1.0, 0.0]])
    out = np.asarray(materials.refract(d, n, 1.0 / 1.5))[0]
    out = out / np.linalg.norm(out)
    sin_t = abs(out[0])
    assert abs(sin_t - s / 1.5) < 1e-6
    assert out[1] < 0  # continues downward


def test_schlick_limits():
    # Normal incidence: r0 = ((1-1.5)/(1+1.5))^2 = 0.04
    r = float(materials.schlick_reflectance(jnp.float32(1.0), 1.5))
    assert abs(r - 0.04) < 1e-6
    # Grazing: → 1
    r = float(materials.schlick_reflectance(jnp.float32(0.0), 1.5))
    assert abs(r - 1.0) < 1e-6


def test_scatter_pure_specular_is_mirror():
    R = 16
    state = jnp.arange(R, dtype=jnp.uint32)
    d = jnp.tile(jnp.asarray([[1.0, -1.0, 0.0]]), (R, 1))
    n = jnp.tile(jnp.asarray([[0.0, 1.0, 0.0]]), (R, 1))
    smooth = jnp.ones((R,))
    _, out, is_d = materials.scatter(state, d, n, smooth)
    assert not bool(np.asarray(is_d).any())
    expected = np.tile(np.array([[1.0, 1.0, 0.0]]) / np.sqrt(2.0), (R, 1))
    np.testing.assert_allclose(np.asarray(out), expected, atol=1e-5)


def test_scatter_diffuse_in_hemisphere():
    R = 4096
    state = jnp.arange(R, dtype=jnp.uint32)
    d = jnp.tile(jnp.asarray([[0.0, -1.0, 0.0]]), (R, 1))
    n = jnp.tile(jnp.asarray([[0.0, 1.0, 0.0]]), (R, 1))
    smooth = jnp.zeros((R,))
    _, out, _ = materials.scatter(state, d, n, smooth)
    assert np.asarray(out)[:, 1].min() >= 0.0


def test_scatter_dielectric_total_internal_reflection():
    # Grazing ray inside glass (back-face: dot(d, n) > 0 → ratio = 1.5):
    # ratio * sin_theta > 1 → must reflect regardless of RNG.
    R = 64
    state = jnp.arange(R, dtype=jnp.uint32)
    s = np.sqrt(0.5)
    d = jnp.tile(jnp.asarray([[s, s, 0.0]]), (R, 1))       # exiting upward
    n = jnp.tile(jnp.asarray([[0.0, 1.0, 0.0]]), (R, 1))   # outward normal
    smooth = -jnp.ones((R,))
    _, out, is_d = materials.scatter(state, d, n, smooth)
    assert bool(np.asarray(is_d).all())
    expected = np.tile(np.array([[s, -s, 0.0]]), (R, 1))
    np.testing.assert_allclose(np.asarray(out), expected, atol=1e-5)


def test_scatter_dielectric_mostly_refracts_at_normal_incidence():
    R = 10000
    state = jnp.arange(R, dtype=jnp.uint32)
    d = jnp.tile(jnp.asarray([[0.0, -1.0, 0.0]]), (R, 1))
    n = jnp.tile(jnp.asarray([[0.0, 1.0, 0.0]]), (R, 1))
    smooth = -jnp.ones((R,))
    _, out, _ = materials.scatter(state, d, n, smooth)
    frac_refracted = float((np.asarray(out)[:, 1] < 0).mean())
    # Schlick at normal incidence = 0.04 → ~96% refract
    assert 0.93 < frac_refracted < 0.99


def test_scatter_share_tile_one_draw_per_tile():
    """share_tile: all lanes of a tile share the diffuse base draw — with a
    constant normal the flip is identical too, so each tile yields exactly
    ONE direction, distinct across tiles."""
    R, T = 1024, 128
    state = (jnp.arange(R, dtype=jnp.uint32) * jnp.uint32(2654435761)
             + jnp.uint32(7))
    d = jnp.tile(jnp.asarray([[0.0, -1.0, 0.0]]), (R, 1))
    n = jnp.tile(jnp.asarray([[0.0, 1.0, 0.0]]), (R, 1))
    _, out, _ = materials.scatter(state, d, n, jnp.zeros((R,)), share_tile=T)
    out = np.asarray(out)
    assert out[:, 1].min() >= 0.0                      # hemisphere
    np.testing.assert_allclose(np.linalg.norm(out, axis=1), 1.0, atol=1e-5)
    tile_dirs = []
    for t in range(R // T):
        tile = out[t * T:(t + 1) * T]
        assert np.unique(tile.round(6), axis=0).shape[0] == 1
        tile_dirs.append(tile[0])
    assert np.unique(np.asarray(tile_dirs).round(6), axis=0).shape[0] > 4


def test_scatter_share_tile_marginal_is_uniform_hemisphere():
    """The shared draw is still marginally uniform on the hemisphere:
    E[d] = n/2 over many tiles (each tile contributes one iid draw)."""
    T, tiles = 128, 512
    R = T * tiles
    state = (jnp.arange(R, dtype=jnp.uint32) * jnp.uint32(1000003)
             + jnp.uint32(3))
    d = jnp.tile(jnp.asarray([[0.0, 0.0, -1.0]]), (R, 1))
    n = jnp.tile(jnp.asarray([[0.0, 0.0, 1.0]]), (R, 1))
    _, out, _ = materials.scatter(state, d, n, jnp.zeros((R,)), share_tile=T)
    mean = np.asarray(out)[::T].mean(axis=0)           # one lane per tile
    np.testing.assert_allclose(mean, [0.0, 0.0, 0.5], atol=0.12)
