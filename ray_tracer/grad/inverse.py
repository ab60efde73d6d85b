"""Inverse rendering: differentiable loss + multi-device training step.

A brand-new capability on top of the reference pipeline (BASELINE.json north
star): because the renderer is pure JAX and the closest-hit search detaches
only the discrete winner index (ops/intersect.py), ``jax.grad`` flows from
pixel loss to sphere centers/radii, triangle vertices, albedos, emission and
smoothness for free. Visibility (edge) gradients are a separate estimator —
see docs/ROADMAP notes; the hit-index detachment matches the standard
reparameterization-free baseline.

Distributed: gradients of the replicated scene are all-reduced
automatically — the scene enters ``shard_map`` with spec P() (replicated),
so the transpose of the sharded render inserts the psum. This is the
renderer analog of DP gradient all-reduce (SURVEY §5 'Distributed
communication backend').
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import optax

from ..camera import CameraBasis
from ..renderer import render_frame
from ..parallel.shard import _render_sharded
from ..scene import Scene
from ..utils.config import RenderParams

# Continuous scene leaves that make sense to optimize.
DEFAULT_TRAINABLE = ("sphere_albedo", "sphere_center", "sphere_radius",
                     "tri_albedo", "tri_v0", "tri_v1", "tri_v2")


def split_scene(scene: Scene, fields: Sequence[str] = DEFAULT_TRAINABLE
                ) -> Tuple[Dict[str, jax.Array], Scene]:
    """Partition the scene into (trainable dict, frozen scene)."""
    trainable = {f: getattr(scene, f) for f in fields}
    return trainable, scene


def merge_scene(scene: Scene, trainable: Dict[str, jax.Array]) -> Scene:
    return dataclasses.replace(scene, **trainable)


def image_mse(trainable, scene: Scene, basis: CameraBasis,
              params: RenderParams, frame_index, target, mesh=None):
    """Mean-squared pixel loss of a 1-frame render against ``target``."""
    full = merge_scene(scene, trainable)
    if mesh is None:
        img = render_frame(full, basis, params, frame_index)
    else:
        img = _render_sharded(full, basis, params, frame_index, mesh)
    return jnp.mean((img - target) ** 2)


def _chunked_inputs(params, target, chunks: int):
    """Blocked-order pixel ids / targets / weights split into ``chunks``
    equal slabs, tail-padded with zero-weighted duplicates of the last
    pixel id when chunks doesn't divide W*H (e.g. 100x100 in 8 chunks).
    Chunks walk the
    same blocked 16x8 pixel order as render_frame so per-block frustums
    stay tight for the kernel's culling."""
    import numpy as np
    from ..renderer import _blocked_order

    W, H = params.width, params.height
    R = W * H
    order_np, _ = _blocked_order(W, H)
    n = -(-R // chunks)
    pad = chunks * n - R
    order_pad = np.concatenate(
        [order_np, np.full(pad, order_np[-1], order_np.dtype)])
    w_pad = np.concatenate(
        [np.ones(R, np.float32), np.zeros(pad, np.float32)])
    order = jnp.asarray(order_pad.astype(np.int32))
    ids = order.reshape(chunks, n)
    wts = jnp.asarray(w_pad).reshape(chunks, n, 1)
    tgt = target.reshape(R, 3)[order].reshape(chunks, n, 3)
    return ids, tgt, wts, jnp.float32(R * 3)


def _chunk_scan(trainable, render_pixels_fn, ids, tgt, wts, denom,
                reduce_fn=None):
    """fwd+bwd per pixel chunk inside a lax.scan, cotangents summed —
    only one chunk's backward residuals are ever live.

    ``reduce_fn(loss_c, grads_c)`` (optional) is applied to each CHUNK's
    contribution before accumulation. The sharded path passes a psum here
    so the cross-device all-reduce of chunk k runs while chunk k+1's
    forward+backward computes (XLA's latency-hiding scheduler
    overlaps the collective with the scan body) — the BASELINE north
    star's "gradient all-reduce overlapped with the backward bounce
    loop". Identical math: psum is linear, so Σ_k psum(g_k) == psum(Σ_k
    g_k) up to fp summation order."""
    def chunk_loss(tr, ids_c, tgt_c, w_c):
        rad = render_pixels_fn(tr, ids_c)
        return jnp.sum(w_c * (rad - tgt_c) ** 2) / denom

    zeros = jax.tree_util.tree_map(jnp.zeros_like, trainable)

    def body(carry, xs):
        loss_acc, grad_acc = carry
        ids_c, tgt_c, w_c = xs
        loss_c, g = jax.value_and_grad(chunk_loss)(trainable, ids_c, tgt_c,
                                                   w_c)
        if reduce_fn is not None:
            loss_c, g = reduce_fn(loss_c, g)
        return (loss_acc + loss_c,
                jax.tree_util.tree_map(jnp.add, grad_acc, g)), None

    (loss, grads), _ = jax.lax.scan(body, (jnp.float32(0.0), zeros),
                                    (ids, tgt, wts))
    return loss, grads


def chunked_mse_value_and_grad(trainable, render_pixels_fn, params,
                               target, chunks: int):
    """value_and_grad of ``mean((render - target)**2)`` accumulated over
    sequential pixel chunks — bounds backward-pass memory by ~1/chunks.

    Why this exists: bounds backward-pass device memory for frames/scenes
    past what a whole-frame gradient fits. Running fwd+bwd per
    chunk inside a lax.scan and summing the scene cotangents keeps only
    one chunk's residuals live; gradients are identical up to fp
    summation order (each pixel's radiance depends only on its own pixel
    id — sampling is seeded per pixel, not per array slot).

    ``render_pixels_fn(trainable, pixel_ids) -> (N, 3)`` radiance.
    """
    ids, tgt, wts, denom = _chunked_inputs(params, target, chunks)
    return _chunk_scan(trainable, render_pixels_fn, ids, tgt, wts, denom)


def sharded_chunked_mse_value_and_grad(trainable, render_pixels_fn, params,
                                       target, chunks: int, mesh):
    """The large-frame multi-device gradient (BASELINE config 5): pixel
    chunks sharded over the device mesh — each device scans its own
    ``chunks`` chunks (bounding per-device memory exactly like the
    single-device path), with a PER-CHUNK psum inside the scan so each
    chunk's all-reduce can overlap the next chunk's backward.

    Total pixel slabs = n_devices x chunks; the blocked pixel order means
    every slab is whole compact 16x8 blocks, so the kernel's per-block
    culling keeps full strength on every device.
    """
    from jax.sharding import NamedSharding, PartitionSpec as P
    from ..parallel.mesh import shard_map_fn

    n_dev = mesh.devices.size
    ids, tgt, wts, denom = _chunked_inputs(params, target, n_dev * chunks)
    # leading slab axis -> (devices, chunks_per_device, n)
    ids = ids.reshape(n_dev, chunks, -1)
    tgt = tgt.reshape(n_dev, chunks, -1, 3)
    wts = wts.reshape(n_dev, chunks, -1, 1)

    axes = tuple(mesh.axis_names)
    slab = P(axes)

    def per_chunk_psum(loss_c, grads_c):
        # all-reduce each chunk's cotangents as soon as its backward ends:
        # the collective for chunk k overlaps chunk k+1's fwd+bwd
        return jax.lax.psum(loss_c, axes), jax.lax.psum(grads_c, axes)

    def body(tr, ids_d, tgt_d, wts_d):
        return _chunk_scan(tr, render_pixels_fn, ids_d[0], tgt_d[0],
                           wts_d[0], denom, reduce_fn=per_chunk_psum)

    fn = shard_map_fn(body, mesh,
                      in_specs=(P(), slab, slab, slab),
                      out_specs=(P(), P()))
    ids = jax.device_put(ids, NamedSharding(mesh, slab))
    return fn(trainable, ids, tgt, wts)


def make_train_step(params: RenderParams, optimizer=None, mesh=None,
                    edge_samples: int = 0, grad_chunks: int = 0,
                    topology=None):
    """Build a jitted SGD/Adam step over trainable scene leaves.

    ``edge_samples > 0`` adds the edge-sampled visibility (boundary)
    gradients (grad/edges.py) for geometry fields — without them, autodiff
    sees only shading changes, not silhouette motion. Pass ``topology``
    (grad.topology.build_topology) for meshes with shared edges: it fixes
    the uniform sampler's interior-edge double count and concentrates
    samples on silhouette/boundary/crease edges.

    ``grad_chunks > 1`` accumulates the gradient over sequential pixel
    chunks (chunked_mse_value_and_grad) — for frames/scenes beyond what
    a whole-frame backward fits in device memory.
    With ``mesh`` it composes: each device scans ``grad_chunks`` chunks
    of its own pixel shard with a per-chunk psum overlapping the next
    chunk's backward (sharded_chunked_mse_value_and_grad — BASELINE
    config 5's multi-host gradient descent at production frame sizes).

    Returns (init_fn, step_fn):
      init_fn(scene, fields) -> (trainable, opt_state)
      step_fn(trainable, opt_state, scene, basis, target, frame_index)
          -> (trainable, opt_state, loss)
    """
    optimizer = optimizer or optax.adam(1e-2)

    def init_fn(scene: Scene, fields: Sequence[str] = DEFAULT_TRAINABLE):
        trainable, _ = split_scene(scene, fields)
        return trainable, optimizer.init(trainable)

    @functools.partial(jax.jit, static_argnames=())
    def step_fn(trainable, opt_state, scene, basis, target, frame_index):
        if grad_chunks > 1:
            from ..renderer import render_pixels

            def rp(tr, ids):
                return render_pixels(merge_scene(scene, tr), basis, params,
                                     frame_index, ids)

            if mesh is None:
                loss, grads = chunked_mse_value_and_grad(
                    trainable, rp, params, target, grad_chunks)
            else:
                loss, grads = sharded_chunked_mse_value_and_grad(
                    trainable, rp, params, target, grad_chunks, mesh)
        else:
            loss, grads = jax.value_and_grad(image_mse)(
                trainable, scene, basis, params, frame_index, target,
                mesh=mesh)
        if edge_samples:
            from .edges import boundary_gradients
            from ..renderer import render_frame
            full = merge_scene(scene, trainable)
            img = render_frame(full, basis, params, frame_index)
            cot = 2.0 * (img - target) / img.size        # d(mse)/d(img)
            key = jax.random.fold_in(jax.random.PRNGKey(1234), frame_index)
            bg = boundary_gradients(full, basis, params, cot, key,
                                    n_tri_samples=edge_samples,
                                    n_sph_samples=edge_samples,
                                    topology=topology)
            grads = {k: v + bg[k] if k in bg else v
                     for k, v in grads.items()}
        updates, opt_state = optimizer.update(grads, opt_state, trainable)
        trainable = optax.apply_updates(trainable, updates)
        return trainable, opt_state, loss

    return init_fn, step_fn
