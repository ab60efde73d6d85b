"""Vectorized lane RNG and sampling primitives.

The reference uses a per-thread stateful u32 hash RNG
(shaders/ray_tracer.wgsl:187-227): an LCG state update followed by a
PCG-style output permutation. We keep the exact same generator but carry
the state as a ``uint32`` *array* with one lane per ray — every update is a
handful of integer ops, fully vectorized, with no cross-lane
dependencies. This reproduces the reference's sample statistics while being
idiomatic SPMD (no stateful pointers).

Distribution-level equivalences (documented in docs/DEVIATIONS.md):
  * unit-sphere sampling = normalized 3-Gaussian via Box-Muller, matching
    shaders/ray_tracer.wgsl:191-203 draw-for-draw.
  * unit-disk sampling is analytic polar (r=sqrt(u1)) instead of the
    reference's rejection loop (shaders/ray_tracer.wgsl:216-227). Both are
    exactly uniform on the disk; the analytic form is branch-free (a
    wavefront has no divergence to hide rejection loops in).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

_LCG_MUL = np.uint32(747796405)
_LCG_ADD = np.uint32(2891336453)
_MIX_MUL = np.uint32(277803737)
_U32_MAX_F = np.float32(4294967295.0)
TWO_PI = np.float32(2.0 * np.pi)


def seed_state(pixel_index, frame_index):
    """Initial per-ray RNG state.

    Mirrors the reference seeding intent at shaders/ray_tracer.wgsl:307-308:
    unique per pixel, decorrelated across frames via the 71939 stride. (The
    reference's `pixel_coord = i.pos * i.size` is a bug that still yields a
    per-pixel-unique seed; we use the plain pixel index — deviation D3.)
    """
    pixel_index = pixel_index.astype(jnp.uint32)
    frame = jnp.uint32(frame_index) if not isinstance(frame_index, jnp.ndarray) else frame_index.astype(jnp.uint32)
    return pixel_index + frame * np.uint32(71939)


def hash_u32(x):
    """Stateless hash of a uint32 array (one generator step seeded at x) —
    for per-pixel scramble values that must NOT consume the ray's RNG
    stream (e.g. the QMC Cranley–Patterson rotation)."""
    return next_u32(x.astype(jnp.uint32))[1]


# R2 low-discrepancy sequence (the plastic-number generalization of the
# golden ratio to 2D), as 0.32 fixed point: the n-th point is
# (n·G1 mod 2^32, n·G2 mod 2^32) — EXACT modular arithmetic, so
# stratification never degrades at high frame counts the way float
# frac(n·g) does.
R2_G1_U32 = np.uint32(3242174889)   # round(0.7548776662466927 * 2^32)
R2_G2_U32 = np.uint32(2447445414)   # round(0.5698402909980532 * 2^32)
_INV_2_32 = np.float32(1.0 / 4294967296.0)


def r2_point(n_u32, rot_x_u32, rot_y_u32):
    """n-th R2 point with per-lane rotation → (ax, ay) f32 in [0, 1)."""
    ax = (n_u32 * R2_G1_U32 + rot_x_u32).astype(jnp.float32) * _INV_2_32
    ay = (n_u32 * R2_G2_U32 + rot_y_u32).astype(jnp.float32) * _INV_2_32
    return ax, ay


def next_u32(state):
    """One step of the reference generator (shaders/ray_tracer.wgsl:205-210).

    Returns (new_state, random_u32). All ops wrap mod 2^32.
    """
    state = state * _LCG_MUL + _LCG_ADD
    shift = (state >> np.uint32(28)) + np.uint32(4)
    word = ((state >> shift) ^ state) * _MIX_MUL
    out = (word >> np.uint32(22)) ^ word
    return state, out


def uniform(state):
    """f32 in [0, 1] (inclusive, like the reference's /(2^32-1) at wgsl:188)."""
    state, bits = next_u32(state)
    return state, bits.astype(jnp.float32) / _U32_MAX_F


def normal(state):
    """Standard normal via Box-Muller (shaders/ray_tracer.wgsl:199-203)."""
    state, u1 = uniform(state)
    state, u2 = uniform(state)
    theta = TWO_PI * u1
    # Guard log(0): the reference would produce inf; clamp instead (D4).
    rho = jnp.sqrt(-2.0 * jnp.log(jnp.maximum(u2, 1e-10)))
    return state, rho * jnp.cos(theta)


def unit_sphere(state):
    """Uniform direction on the unit sphere = normalized 3-Gaussian
    (shaders/ray_tracer.wgsl:191-197). Returns (state, (..., 3))."""
    state, x = normal(state)
    state, y = normal(state)
    state, z = normal(state)
    v = jnp.stack([x, y, z], axis=-1)
    n = jnp.linalg.norm(v, axis=-1, keepdims=True)
    return state, v / jnp.maximum(n, 1e-12)


def hemisphere(state, normal_vec):
    """Sphere sample flipped into the hemisphere around ``normal_vec``
    (shaders/ray_tracer.wgsl:211-214). sign(0) in WGSL is 0 — we map the
    measure-zero tangential case to +1 to avoid zero directions (D5)."""
    state, d = unit_sphere(state)
    s = jnp.sum(d * normal_vec, axis=-1, keepdims=True)
    flip = jnp.where(s >= 0.0, 1.0, -1.0)
    return state, d * flip


def unit_disk(state):
    """Uniform point in the unit disk, analytic polar form. Statistically
    identical to the rejection sampler at shaders/ray_tracer.wgsl:216-227
    but branch-free. Returns (state, (..., 2))."""
    state, u1 = uniform(state)
    state, u2 = uniform(state)
    r = jnp.sqrt(u1)
    phi = TWO_PI * u2
    return state, jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi)], axis=-1)


def split_key_rng(key, shape):
    """jax.random based seeding helper for tests: returns uint32 states."""
    return jax.random.bits(key, shape, dtype=jnp.uint32)
