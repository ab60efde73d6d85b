"""ray_tracer — a differentiable path tracer in JAX for the GPU.

Brand-new JAX/XLA/Pallas framework with the capabilities of the reference
GPU path tracer (addiswebb/ray_tracer, Rust + wgpu + WGSL): thin-lens
progressive path tracing of sphere/triangle scenes with diffuse, glossy,
dielectric and emissive materials, a procedural sky, OBJ/glTF/GLB loading,
and four built-in scenes — designed anew (wavefront scheduling, a culling
intersection kernel, shard_map scaling, differentiable rendering) rather
than ported.

Quick start:
    >>> import ray_tracer as rt
    >>> scene, cam = rt.builtin_scene("metal", aspect=1.0)
    >>> img = rt.render(scene, cam, rt.RenderParams(width=256, height=256,
    ...                                             skybox=True), frames=8)
"""

from .camera import Camera, CameraBasis, CameraController, camera_basis, camera_basis_jnp, camera_rays, update_camera
from .denoise import denoise
from .renderer import (Renderer, accumulate, render, render_adaptive,
                       render_aov, render_frame, render_pixels,
                       render_progressive, trace)
from .scene import (
    BUILTIN_SCENES,
    SCENE_IDS,
    Scene,
    SceneBuilder,
    builtin_scene,
    scene_balls,
    scene_metal,
    scene_random_balls,
    scene_room,
)
from .utils.config import RenderParams

__version__ = "0.1.0"

__all__ = [
    "Camera", "CameraBasis", "CameraController", "camera_basis", "camera_basis_jnp", "camera_rays",
    "update_camera", "Renderer", "accumulate", "render", "render_adaptive",
    "render_aov", "render_frame", "render_pixels", "render_progressive",
    "trace", "denoise", "Scene", "SceneBuilder", "builtin_scene",
    "scene_balls", "scene_metal", "scene_random_balls", "scene_room",
    "BUILTIN_SCENES", "SCENE_IDS", "RenderParams",
]
