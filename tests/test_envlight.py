"""Environment light tests (shaders/ray_tracer.wgsl:100-104, 297-304)."""

import numpy as np
import jax.numpy as jnp

from ray_tracer import envlight


def test_straight_up_is_zenith_plus_sun():
    d = jnp.asarray([[0.0, 1.0, 0.0]])
    out = np.asarray(envlight.environment_light(d))[0]
    sun = max(0.0, 1.0) ** 500 * 0.1  # dot((0,1,0),(0.1,1,0.1)) = 1.0
    np.testing.assert_allclose(out, envlight.SKY_ZENITH + sun, atol=1e-5)


def test_horizontal_is_horizon_no_sun():
    d = jnp.asarray([[1.0, 0.0, 0.0]])
    out = np.asarray(envlight.environment_light(d))[0]
    # y=0: sky_t=0 → horizon; ground_to_sky = smoothstep(-0.01,0,0) = 1
    # sun dot = 0.1 → 0.1^500 ≈ 0
    np.testing.assert_allclose(out, envlight.SKY_HORIZON, atol=1e-5)


def test_below_horizon_is_ground():
    d = jnp.asarray([[0.0, -0.5, 0.0]])
    out = np.asarray(envlight.environment_light(d))[0]
    np.testing.assert_allclose(out, envlight.GROUND_COLOR, atol=1e-6)


def test_smoothstep_matches_glsl():
    xs = jnp.linspace(-1.0, 2.0, 31)
    out = np.asarray(envlight.smoothstep(0.0, 1.0, xs))
    t = np.clip(np.asarray(xs), 0.0, 1.0)
    np.testing.assert_allclose(out, t * t * (3 - 2 * t), atol=1e-6)


def test_sun_only_at_or_above_horizon():
    # slightly below horizon: ground_to_sky < 1 → no sun term
    d_below = jnp.asarray([[0.1, -0.005, 0.1]])
    d_above = jnp.asarray([[0.1, 0.9, 0.1]])
    out_b = np.asarray(envlight.environment_light(d_below))[0]
    out_a = np.asarray(envlight.environment_light(d_above))[0]
    assert np.isfinite(out_b).all() and np.isfinite(out_a).all()
    # above-horizon near-sun direction should be brighter than pure sky blend
    assert out_a.sum() > 0
