"""Model zoo: built-in scenes + reference assets as ready-to-render setups.

The reference ships 4 hardcoded scene constructors (src/core/scene.rs:
balls :379, random_balls :121, room :198, metal :311) and a directory of
OBJ/glTF/GLB assets that its loaders never actually feed into a scene
(call site commented out — src/core/scene.rs:466, SURVEY Q7). Here both
are first-class: `scene(name)` returns any built-in, and `asset(path)`
builds a renderable scene + framing camera from any model file the
loaders understand.

>>> from ray_tracer import models
>>> scene, cam = models.scene("room")
>>> scene, cam = models.asset("/root/reference/assets/the_utah_teapot.glb")
"""

from __future__ import annotations

import numpy as np

from ..scene import SceneBuilder, builtin_scene, BUILTIN_SCENES, SCENE_IDS
from ..camera import Camera
from ..io import load_model

__all__ = ["scene", "asset", "BUILTIN_SCENES", "SCENE_IDS"]


def scene(name_or_id, aspect: float = 1.0, **kw):
    """Built-in scene by name ('balls', 'random_balls', 'room', 'metal')
    or reference scene id 0-3 (src/core/context.rs:261-279)."""
    return builtin_scene(name_or_id, aspect=aspect, **kw)


def asset(path: str, aspect: float = 1.0, albedo=(0.2, 0.2, 1.0),
          smoothness: float = 0.5, skirt=0.7):
    """Load a model file into a scene with a camera framing its bounds.

    Default material mirrors the reference loaders' hardcoded one
    (color [0.2, 0.2, 1.0], specular 0.5 — src/core/resource.rs:78-84).
    """
    b = SceneBuilder()
    load_model(path, b, placement="origin", albedo=tuple(albedo),
               smoothness=smoothness)
    lo, hi = b.bounds()
    s = b.build()
    center = (lo + hi) / 2
    extent = float(np.linalg.norm(hi - lo))
    cam = Camera(origin=tuple(center + extent * np.array([skirt, 0.4, skirt])),
                 look_at=tuple(center), aspect=aspect, focus_dist=1.0)
    return s, cam
