"""Checkpoint / resume for progressive renders and inverse rendering.

The reference has no render-state persistence (SURVEY §5: only imgui.ini
window layout). For a headless renderer accumulating thousands of
frames — or a multi-step inverse-rendering optimization — resumability is a
first-class subsystem: the accumulation image + frame counter (and
optionally optimizer/trainable state) round-trip through a single .npz.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Optional, Tuple

import numpy as np

from ..camera import Camera
from ..renderer import Renderer
from .config import RenderParams

_FORMAT_VERSION = 1


def save_renderer(path: str, renderer: Renderer) -> None:
    """Persist accumulation state + camera + params (not the scene — scenes
    are rebuilt from their builders/loaders, which is cheaper and keeps the
    checkpoint small)."""
    img = (np.asarray(renderer._image, np.float32)
           if renderer._image is not None else np.zeros((0,)))
    meta = {
        "version": _FORMAT_VERSION,
        "frames": renderer.frames,
        "params": dataclasses.asdict(renderer.params),
        "camera": dataclasses.asdict(renderer.camera),
    }
    np.savez_compressed(path, image=img, meta=json.dumps(meta))


def load_renderer(path: str, scene) -> Renderer:
    """Rebuild a Renderer from a checkpoint + a (re-built) scene; rendering
    continues from the saved frame counter with identical accumulation
    weights (w = 1/(frames+1), wgsl:59-63)."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["meta"]))
        if meta["version"] != _FORMAT_VERSION:
            raise ValueError(f"unsupported checkpoint version {meta['version']}")
        img = z["image"]
    params = RenderParams(**meta["params"])
    cam_kw = meta["camera"]
    for k in ("origin", "look_at", "vup"):
        cam_kw[k] = tuple(cam_kw[k])
    camera = Camera(**cam_kw)
    r = Renderer(scene, camera, params)
    r.frames = meta["frames"]
    if img.size:
        import jax.numpy as jnp
        r._image = jnp.asarray(img)
    return r


def save_training(path: str, trainable: Dict[str, Any], opt_state,
                  step: int, extra: Optional[dict] = None) -> None:
    """Persist inverse-rendering state: trainable scene leaves + flattened
    optax optimizer state + step counter."""
    import jax
    opt_leaves, opt_tree = jax.tree_util.tree_flatten(opt_state)
    arrays = {f"trainable__{k}": np.asarray(v) for k, v in trainable.items()}
    arrays.update({f"opt__{i}": np.asarray(l) for i, l in enumerate(opt_leaves)})
    meta = {
        "version": _FORMAT_VERSION, "step": step,
        "trainable_keys": sorted(trainable.keys()),
        "n_opt_leaves": len(opt_leaves),
        "extra": extra or {},
    }
    np.savez_compressed(path, meta=json.dumps(meta), **arrays)


def load_training(path: str, opt_state_template) -> Tuple[dict, Any, int, dict]:
    """Restore (trainable, opt_state, step, extra). ``opt_state_template``
    is a freshly-initialized optimizer state providing the pytree structure."""
    import jax
    import jax.numpy as jnp
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["meta"]))
        trainable = {k: jnp.asarray(z[f"trainable__{k}"])
                     for k in meta["trainable_keys"]}
        leaves = [jnp.asarray(z[f"opt__{i}"])
                  for i in range(meta["n_opt_leaves"])]
    _, tree = jax.tree_util.tree_flatten(opt_state_template)
    opt_state = jax.tree_util.tree_unflatten(tree, leaves)
    return trainable, opt_state, meta["step"], meta["extra"]
