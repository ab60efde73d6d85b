"""Edge-avoiding à-trous denoiser: noise drops, feature edges survive."""

import numpy as np
import jax.numpy as jnp

import ray_tracer as rt
from ray_tracer.denoise import denoise, denoise_render
from ray_tracer.renderer import camera_basis, render_aov, render_frame


def test_denoise_reduces_noise_preserves_edges():
    rng = np.random.default_rng(5)
    H = W = 64
    # two flat regions (a synthetic "object" and "background") + noise
    mask = np.zeros((H, W, 1), np.float32)
    mask[:, W // 2:] = 1.0
    clean = mask * np.array([0.8, 0.2, 0.1]) + (1 - mask) * 0.05
    noisy = clean + rng.normal(0, 0.15, clean.shape).astype(np.float32)
    # guides: the normal flips across the edge, depth differs
    normal = np.where(mask > 0, [0.0, 0.0, 1.0], [1.0, 0.0, 0.0])
    depth = np.where(mask > 0, 2.0, 5.0)[..., :1]

    out = np.asarray(denoise(jnp.asarray(noisy), jnp.asarray(normal,
                                                             jnp.float32),
                             jnp.asarray(depth, jnp.float32), iterations=3))
    # noise drops a lot INSIDE each region...
    inner_l = (slice(8, H - 8), slice(8, W // 2 - 8))
    inner_r = (slice(8, H - 8), slice(W // 2 + 8, W - 8))
    for sl in (inner_l, inner_r):
        assert (out[sl] - clean[sl]).std() < 0.35 * (noisy[sl]
                                                     - clean[sl]).std()
    # ...while the step edge stays a step (no bleed across the guide edge)
    left_mean = out[inner_l].mean(axis=(0, 1))
    right_mean = out[inner_r].mean(axis=(0, 1))
    np.testing.assert_allclose(left_mean, clean[inner_l].mean(axis=(0, 1)),
                               atol=0.05)
    np.testing.assert_allclose(right_mean, clean[inner_r].mean(axis=(0, 1)),
                               atol=0.05)


def test_denoise_render_end_to_end():
    """1-frame noisy render → filtered with its own AOV guides: pixel
    variance within the floor region drops, mean brightness is stable."""
    scene, cam = rt.builtin_scene("metal", aspect=1.0)
    params = rt.RenderParams(width=64, height=64, bounces=2, skybox=True,
                             backend="jnp")
    basis = camera_basis(cam)
    img = render_frame(scene, basis, params, jnp.int32(0))
    out = np.asarray(denoise_render(scene, basis, params, img))
    img = np.asarray(img)
    assert out.shape == img.shape and np.isfinite(out).all()
    # brightness preserved within a few percent
    assert abs(out.mean() - img.mean()) < 0.05 * max(img.mean(), 1e-6)
    # local noise (high-frequency energy) reduced
    def hf(x):
        return np.abs(np.diff(x, axis=0)).mean()
    assert hf(out) < 0.6 * hf(img)
