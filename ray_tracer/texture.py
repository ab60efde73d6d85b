"""Texture sampling: bilinear lookup from a fixed-size texture stack.

Extension beyond the reference (SURVEY quirk Q10: the reference ships
diffuse/normal-map images and MTL references but no shader path samples
them; BASELINE config 3 makes UV/texture shading a target). Design: all
textures live in ONE (K, R, R, 3) f32 stack (resized at build time) so a
batch of lanes samples with one flat gather — no per-texture
control flow, fully differentiable w.r.t. texels (texture recovery via
inverse rendering works out of the box).

UV convention: u right, v DOWN (image row = v * H). The OBJ loader flips
its bottom-left-origin vt records; glTF passes through unchanged.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def srgb_to_linear(x: np.ndarray) -> np.ndarray:
    """Inverse of the display transfer function — diffuse maps are authored
    in sRGB; shading happens in linear radiance."""
    x = np.asarray(x, np.float32)
    return np.where(x <= 0.04045, x / 12.92, ((x + 0.055) / 1.055) ** 2.4)


def prepare_texture(image, resolution: int, srgb: bool) -> np.ndarray:
    """uint8/float (H, W, 3|4) image → (resolution, resolution, 3) linear f32."""
    from PIL import Image

    arr = np.asarray(image)
    if arr.dtype != np.uint8:
        arr = (np.clip(arr, 0.0, 1.0) * 255).astype(np.uint8)
    if arr.ndim == 2:
        arr = np.stack([arr] * 3, -1)
    img = Image.fromarray(arr[..., :3], "RGB").resize(
        (resolution, resolution), Image.BILINEAR)
    out = np.asarray(img, np.float32) / 255.0
    return srgb_to_linear(out) if srgb else out


def sample_bilinear(stack, tex_id, uv):
    """Bilinear texture fetch with repeat wrapping.

    The four taps are folded into ONE gather: each texel row of the quad
    table holds its full 2×2 wrap-around
    neighborhood [c00 | c10 | c01 | c11] (12 floats). The quad table is a
    roll+concat of the stack — scene-invariant, so XLA hoists it out of
    the per-bounce/per-frame loops — and the gather transpose (scatter-add)
    keeps texel gradients exact for texture recovery.

    Args:
      stack: (K, R, R, 3) f32 texture stack.
      tex_id: (N,) int32, -1 = untextured (returns white).
      uv: (N, 2) f32.

    Returns (N, 3).
    """
    K, H, W, _ = stack.shape
    sx = jnp.roll(stack, -1, axis=2)             # x+1 neighbor (wrapped)
    sy = jnp.roll(stack, -1, axis=1)             # y+1
    sxy = jnp.roll(sx, -1, axis=1)               # x+1, y+1
    quad = jnp.concatenate([stack, sx, sy, sxy], -1).reshape(K * H * W, 12)
    tid = jnp.clip(tex_id, 0, K - 1)

    u = uv[:, 0] - jnp.floor(uv[:, 0])          # repeat wrap
    v = uv[:, 1] - jnp.floor(uv[:, 1])
    x = u * W - 0.5
    y = v * H - 0.5
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = (x - x0)[:, None]
    fy = (y - y0)[:, None]
    xi = jnp.mod(x0.astype(jnp.int32), W)
    yi = jnp.mod(y0.astype(jnp.int32), H)

    rows = quad[(tid * H + yi) * W + xi]         # (N, 12): the one gather
    c00, c10 = rows[:, 0:3], rows[:, 3:6]
    c01, c11 = rows[:, 6:9], rows[:, 9:12]
    top = c00 * (1 - fx) + c10 * fx
    bot = c01 * (1 - fx) + c11 * fx
    out = top * (1 - fy) + bot * fy
    return jnp.where((tex_id >= 0)[:, None], out, 1.0)


def sample_bilinear_gated(stack, tex_id, uv, live, tile: int = 128):
    """Liveness-gated bilinear fetch: skip whole dead ray tiles.

    The full-wavefront fetch runs every bounce even though liveness
    collapses tile-coherently (on open scenes most bounce-0 tiles are
    all-sky, and few tiles stay live past the first bounces).
    Rays arrive in the renderer's 16x8 blocked pixel order, so liveness is
    coherent per 128-lane tile; this wrapper compacts the LIVE tiles (tile
    index ops cost R/tile rows — trivial), fetches only their lanes, and
    scatters the results back. Two static budgets (T/16, T/4) with a
    ``lax.cond`` fallback to the plain full fetch keep shapes static and
    the estimator exact on any occupancy.

    Live lanes get bit-identical values to ``sample_bilinear`` (same rows,
    same arithmetic, per lane); lanes in all-dead tiles return white — their
    albedo is provably unused (throughput/NEE updates are gated on
    active-hit lanes) and their texel cotangents are exactly zero, so
    values, images, and texture-recovery gradients all match the ungated
    fetch. ``live=None``, non-tile-divisible R, or fewer than 16 tiles fall
    back to the plain fetch.
    """
    R = int(tex_id.shape[0])
    if live is None or R % tile or (R // tile) < 16:
        return sample_bilinear(stack, tex_id, uv)
    T = R // tile
    tile_live = jnp.any(live.reshape(T, tile), axis=1)
    n_live = jnp.sum(tile_live.astype(jnp.int32))
    uv_t = uv.reshape(T, tile, 2)
    id_t = tex_id.reshape(T, tile)

    def compact(budget):
        def go(_):
            # fill slots index T (out of range): their gather clips to the
            # last tile (harmless, just computed twice) and their scatter
            # is dropped, so dead tiles keep the white placeholder
            idx = jnp.nonzero(tile_live, size=budget, fill_value=T)[0]
            out = sample_bilinear(
                stack, id_t.at[idx].get(mode="clip").reshape(-1),
                uv_t.at[idx].get(mode="clip").reshape(-1, 2))
            full = jnp.ones((T, tile, 3), stack.dtype)
            full = full.at[idx].set(out.reshape(budget, tile, 3),
                                    mode="drop")
            return full.reshape(R, 3)
        return go

    def full_fetch(_):
        return sample_bilinear(stack, tex_id, uv)

    return jax.lax.cond(
        n_live <= T // 16, compact(T // 16),
        lambda _: jax.lax.cond(n_live <= T // 4, compact(T // 4),
                               full_fetch, None),
        None)


def decode_normal_map(rgb):
    """[0,1] RGB → tangent-space normal in [-1,1], z-positive."""
    n = rgb * 2.0 - 1.0
    return n
