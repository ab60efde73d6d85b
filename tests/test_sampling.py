"""Tests for the lane RNG and sampling primitives.

The generator must be bit-exact to the reference hash
(shaders/ray_tracer.wgsl:205-210); distributions are checked statistically.
"""

import numpy as np
import jax.numpy as jnp

from ray_tracer import sampling


def _reference_next(seed: int):
    """Straight NumPy transcription of the WGSL generator for cross-checking."""
    seed = np.uint32((np.uint64(seed) * np.uint64(747796405) + np.uint64(2891336453)) & np.uint64(0xFFFFFFFF))
    shift = np.uint32((int(seed) >> 28) + 4)
    word = np.uint32((((int(seed) >> int(shift)) ^ int(seed)) * 277803737) & 0xFFFFFFFF)
    out = np.uint32((int(word) >> 22) ^ int(word))
    return seed, out


def test_next_u32_matches_reference_hash():
    states = jnp.asarray(np.array([0, 1, 12345, 0xDEADBEEF, 0xFFFFFFFF], np.uint32))
    new_states, outs = sampling.next_u32(states)
    for i, s in enumerate([0, 1, 12345, 0xDEADBEEF, 0xFFFFFFFF]):
        exp_state, exp_out = _reference_next(s)
        assert np.uint32(new_states[i]) == exp_state, f"state mismatch at seed {s}"
        assert np.uint32(outs[i]) == exp_out, f"output mismatch at seed {s}"


def test_uniform_range_and_mean():
    states = jnp.arange(200_000, dtype=jnp.uint32)
    _, u = sampling.uniform(states)
    u = np.asarray(u)
    assert u.min() >= 0.0 and u.max() <= 1.0
    assert abs(u.mean() - 0.5) < 5e-3
    assert abs(u.var() - 1 / 12) < 5e-3


def test_normal_moments():
    states = jnp.arange(200_000, dtype=jnp.uint32)
    _, x = sampling.normal(states)
    x = np.asarray(x)
    assert abs(x.mean()) < 1e-2
    assert abs(x.std() - 1.0) < 1e-2


def test_unit_sphere_is_unit_and_isotropic():
    states = jnp.arange(100_000, dtype=jnp.uint32)
    _, v = sampling.unit_sphere(states)
    v = np.asarray(v)
    np.testing.assert_allclose(np.linalg.norm(v, axis=-1), 1.0, atol=1e-5)
    assert np.abs(v.mean(0)).max() < 1e-2


def test_hemisphere_respects_normal():
    states = jnp.arange(10_000, dtype=jnp.uint32)
    n = jnp.tile(jnp.asarray([[0.0, 1.0, 0.0]]), (10_000, 1))
    _, v = sampling.hemisphere(states, n)
    assert np.asarray(v)[:, 1].min() >= 0.0


def test_unit_disk_uniform():
    states = jnp.arange(100_000, dtype=jnp.uint32)
    _, p = sampling.unit_disk(states)
    p = np.asarray(p)
    r = np.linalg.norm(p, axis=-1)
    assert r.max() <= 1.0 + 1e-6
    # For uniform disk, E[r^2] = 1/2
    assert abs((r ** 2).mean() - 0.5) < 5e-3
    assert np.abs(p.mean(0)).max() < 5e-3


def test_seed_state_decorrelates_frames():
    pix = jnp.arange(1000, dtype=jnp.uint32)
    s0 = sampling.seed_state(pix, 0)
    s1 = sampling.seed_state(pix, 1)
    assert not np.array_equal(np.asarray(s0), np.asarray(s1))


def test_r2_sequence_is_stratified():
    """Fixed-point R2 points are 2D-low-discrepancy: 64 consecutive
    samples spread over an 8×8 grid with no crowding (max cell count 3+
    and many empty cells are routine for 64 RANDOM points)."""
    import jax.numpy as jnp
    from ray_tracer import sampling

    n = jnp.arange(64, dtype=jnp.uint32)
    ax, ay = sampling.r2_point(n, jnp.uint32(0), jnp.uint32(0))
    cx = np.clip((np.asarray(ax) * 8).astype(int), 0, 7)
    cy = np.clip((np.asarray(ay) * 8).astype(int), 0, 7)
    counts = np.zeros((8, 8), int)
    np.add.at(counts, (cy, cx), 1)
    assert counts.max() <= 2, counts.max()
    assert (counts > 0).sum() >= 52, (counts > 0).sum()


def test_qmc_converges_faster_on_aa_edges():
    """bounces=0 emissive silhouette: radiance depends ONLY on the AA
    sample position, so this isolates the AA sampler. 16 accumulated QMC
    frames must beat 16 PCG frames against the converged image."""
    import jax.numpy as jnp
    import ray_tracer as rt
    from ray_tracer.renderer import camera_basis, render_progressive

    b = rt.SceneBuilder()
    b.add_sphere((0, 0, -4), 1.0, (0, 0, 0), emission=(1, 1, 1),
                 emission_strength=1.0)
    scene = b.build(pad=8)
    cam = rt.Camera(origin=(0, 0, 0), look_at=(0, 0, -1), fov=40.0,
                    aspect=1.0)
    basis = camera_basis(cam)
    p = rt.RenderParams(width=24, height=24, bounces=0, backend="jnp")
    ref = np.asarray(render_progressive(scene, basis,
                                        p.replace(qmc=True), 2048))
    err_pcg = np.abs(np.asarray(
        render_progressive(scene, basis, p, 16)) - ref).mean()
    err_qmc = np.abs(np.asarray(
        render_progressive(scene, basis, p.replace(qmc=True), 16))
        - ref).mean()
    assert err_qmc < 0.5 * err_pcg, (err_qmc, err_pcg)


def test_qmc_off_is_bitwise_reference():
    import jax.numpy as jnp
    import ray_tracer as rt
    from ray_tracer.renderer import camera_basis, render_frame

    scene, cam = rt.builtin_scene("room", aspect=1.0)
    p = rt.RenderParams(width=12, height=12, bounces=2, backend="jnp")
    basis = camera_basis(cam)
    a = np.asarray(render_frame(scene, basis, p, jnp.int32(0)))
    b = np.asarray(render_frame(scene, basis, p.replace(qmc=False),
                                jnp.int32(0)))
    np.testing.assert_array_equal(a, b)
