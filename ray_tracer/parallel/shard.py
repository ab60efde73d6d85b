"""Data-parallel rendering: pixel tiles sharded over the device mesh.

The renderer analog of DP (SURVEY §2.3 / §7.1.6): the frame's flat pixel
array is split evenly across devices with ``shard_map``; the scene and
camera basis are replicated per device (they're small — a 16k-triangle
mesh is ~1.5 MB); forward rendering is embarrassingly parallel with ZERO
collectives. Inverse rendering all-reduces parameter gradients — that
psum is inserted automatically by shard_map's transpose because the scene
enters replicated (see grad/inverse.py).

``render_pixels`` already takes pixel ids as an argument, so the per-device
body is literally the single-chip code — this is the whole point of the
flat-pixel design in renderer.py.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..camera import CameraBasis
from ..renderer import (_blocked_order, _unblock_image, render_pixels,
                        resolved_backend)
from ..scene import Scene
from ..utils.config import RenderParams
from .mesh import AXIS, make_mesh, shard_map_fn


def _padded_ids(params: RenderParams, n_dev: int):
    """Flat pixel ids padded to a multiple of n_dev (surplus lanes repeat
    the last pixel; they're dropped after the gather).

    Uses the SAME blocked 16×8 pixel order as the single-device path
    (renderer.render_frame) whenever the kernel backend (or coherent
    scattering) is in play: each device's contiguous shard is then whole
    compact pixel blocks, so per-block frustums stay tight and the
    kernel's cluster culling works at full strength — a raw arange would
    hand every device 128-wide scanline strips.
    Returns (ids, blocked, inverse-or-None).
    """
    W, H = params.width, params.height
    n = W * H
    blocked = (resolved_backend(params) == "pallas"
               or params.coherent_scatter)
    if blocked:
        order, inverse = _blocked_order(W, H)
        base = jnp.asarray(order)
    else:
        base, inverse = jnp.arange(n, dtype=jnp.uint32), None
    per = -(-n // n_dev)
    pad = per * n_dev - n
    if pad:
        base = jnp.concatenate([base, jnp.broadcast_to(base[-1:], (pad,))])
    return base, blocked, inverse


@functools.partial(jax.jit, static_argnames=("params", "mesh"))
def _render_sharded(scene: Scene, basis: CameraBasis, params: RenderParams,
                    frame_index, mesh: Mesh):
    W, H = params.width, params.height
    n = W * H
    ids, blocked, inverse = _padded_ids(params, mesh.devices.size)

    def body(scene, basis, frame_index, ids):
        return render_pixels(scene, basis, params, frame_index, ids)

    # shard the flat pixel axis over EVERY mesh axis: works for the 1-D
    # ('devices',) mesh and the multi-host ('host', 'chip') mesh alike
    pix_spec = P(tuple(mesh.axis_names))
    fn = shard_map_fn(
        body, mesh,
        in_specs=(P(), P(), P(), pix_spec),
        out_specs=pix_spec,
    )
    ids = jax.device_put(ids, NamedSharding(mesh, pix_spec))
    img = fn(scene, basis, frame_index, ids)[:n]
    if blocked:
        if W % 16 == 0 and H % 8 == 0:
            img = _unblock_image(img, W, H)
        else:
            img = img[jnp.asarray(inverse)]  # back to raster order
    return img.reshape(H, W, 3)


def render_frame_distributed(scene: Scene, basis: CameraBasis,
                             params: RenderParams, frame_index,
                             mesh: Optional[Mesh] = None):
    """One frame rendered across all devices → (H, W, 3) on host logical
    layout (sharded along rows until materialized)."""
    mesh = mesh if mesh is not None else make_mesh()
    return _render_sharded(scene, basis, params, jnp.int32(frame_index), mesh)
