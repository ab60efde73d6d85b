"""Thin-lens camera: model, ray generation, and fly-controller.

A re-design of the reference camera (src/core/camera.rs). The
reference splits the camera into a host struct + a GPU ``CameraUniform``
(src/core/camera.rs:9-29); here the analog is a host-side ``Camera`` spec and
a ``CameraBasis`` pytree of jnp arrays that jitted ray generation consumes.

Viewport math matches ``Camera::to_uniform`` (src/core/camera.rs:79-121):
    height     = 2 * tan(fov/2)
    width      = aspect * height
    w, u, v    = view basis from (origin - look_at), vup
    horizontal = focus_dist * width  * u
    vertical   = focus_dist * height * v
    lower_left = origin - horizontal/2 - vertical/2 - focus_dist * w
    lens_radius = aperture / 2

Ray generation matches the per-sample path at shaders/ray_tracer.wgsl:313-321:
AA jitter in [0,1)^2, thin-lens origin offset on the (u, v) lens plane, and
dir = lower_left + px*horizontal + py*vertical - ray_origin (unnormalized,
exactly like the reference).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from . import sampling


@dataclasses.dataclass
class Camera:
    """Host-side camera spec (reference: src/core/camera.rs:31-46)."""

    origin: Tuple[float, float, float]
    look_at: Tuple[float, float, float]
    vup: Tuple[float, float, float] = (0.0, 1.0, 0.0)
    fov: float = 45.0  # vertical field of view, degrees
    aspect: float = 1.0
    near: float = 0.1
    far: float = 100.0
    aperture: float = 0.0
    focus_dist: float = 1.0

    def replace(self, **kw) -> "Camera":
        return dataclasses.replace(self, **kw)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class CameraBasis:
    """Device-side ray-generation basis (analog of CameraUniform,
    src/core/camera.rs:9-29, minus dead padding)."""

    origin: jax.Array       # (3,)
    lower_left: jax.Array   # (3,)
    horizontal: jax.Array   # (3,)
    vertical: jax.Array     # (3,)
    u: jax.Array            # (3,)
    v: jax.Array            # (3,)
    w: jax.Array            # (3,)
    lens_radius: jax.Array  # ()


def _normalize(v):
    return v / np.maximum(np.linalg.norm(v), 1e-12)


def camera_basis(cam: Camera) -> CameraBasis:
    """Compute the ray-gen basis (src/core/camera.rs:92-103).

    Pure NUMPY on purpose: the basis is closed over by jitted render
    functions, and a closed-over DEVICE array must be pulled back to the
    host at lowering time to be embedded as an MLIR constant. Host numpy
    values embed directly."""
    origin = np.asarray(cam.origin, np.float32)
    look_at = np.asarray(cam.look_at, np.float32)
    vup = np.asarray(cam.vup, np.float32)

    theta = math.radians(cam.fov)
    height = 2.0 * math.tan(theta / 2.0)
    width = cam.aspect * height

    w = _normalize(origin - look_at)
    u = _normalize(np.cross(vup, w))
    v = np.cross(w, u)

    horizontal = (cam.focus_dist * width * u).astype(np.float32)
    vertical = (cam.focus_dist * height * v).astype(np.float32)
    lower_left = (origin - horizontal / 2.0 - vertical / 2.0
                  - cam.focus_dist * w).astype(np.float32)

    return CameraBasis(
        origin=origin,
        lower_left=lower_left,
        horizontal=horizontal,
        vertical=vertical,
        u=u.astype(np.float32),
        v=v.astype(np.float32),
        w=w.astype(np.float32),
        lens_radius=np.float32(cam.aperture / 2.0),
    )


def camera_basis_jnp(origin, look_at, vup=(0.0, 1.0, 0.0), fov: float = 45.0,
                     aspect: float = 1.0, focus_dist: float = 1.0,
                     aperture: float = 0.0) -> CameraBasis:
    """Differentiable twin of ``camera_basis`` on traced jnp values — the
    camera-calibration entry point: ``jax.grad`` flows from pixel loss
    through the ray-gen basis to the pose (origin/look_at) and focus
    distance, so camera recovery by gradient descent works like scene
    recovery (tests/test_camera.py pins pose recovery).

    Use INSIDE jit with traced inputs only. For a static camera keep
    using ``camera_basis`` (host numpy) — a closed-over device-resident
    basis is pulled back to the host at lowering time (see that
    docstring). ``fov``/``aspect``/``aperture`` stay
    static Python floats (resolution-like quantities); ``origin``,
    ``look_at`` and ``focus_dist`` may be traced arrays."""
    import math as _math

    origin = jnp.asarray(origin, jnp.float32)
    look_at = jnp.asarray(look_at, jnp.float32)
    vup = jnp.asarray(vup, jnp.float32)

    theta = _math.radians(fov)
    height = 2.0 * _math.tan(theta / 2.0)
    width = aspect * height

    def _norm(v):
        return v / jnp.maximum(jnp.linalg.norm(v), 1e-12)

    w = _norm(origin - look_at)
    u = _norm(jnp.cross(vup, w))
    v = jnp.cross(w, u)
    focus_dist = jnp.asarray(focus_dist, jnp.float32)

    horizontal = focus_dist * width * u
    vertical = focus_dist * height * v
    lower_left = origin - horizontal / 2.0 - vertical / 2.0 - focus_dist * w

    return CameraBasis(
        origin=origin, lower_left=lower_left, horizontal=horizontal,
        vertical=vertical, u=u, v=v, w=w,
        lens_radius=jnp.float32(aperture / 2.0),
    )


def camera_rays(basis: CameraBasis, pix_x, pix_y, size_wh, state,
                jitter=None):
    """Generate one primary ray per lane (shaders/ray_tracer.wgsl:313-321).

    Args:
      basis: CameraBasis.
      pix_x, pix_y: integer pixel coordinates, any shape (...,). y=0 is the
        *bottom* row (RTiOW convention; the PNG writer flips).
      size_wh: (width, height) python ints or scalars.
      state: uint32 RNG state, same shape as pix_x.
      jitter: optional (ax, ay) anti-aliasing offsets in [0,1) supplied by
        the caller (the QMC path, renderer.render_pixels); when None the
        reference's PCG draws are used (and the state advances exactly as
        the reference's does).

    Returns:
      (state, origins (..., 3), dirs (..., 3)); dirs are unnormalized like
      the reference.
    """
    w, h = size_wh
    if jitter is None:
        state, ax = sampling.uniform(state)
        state, ay = sampling.uniform(state)
    else:
        ax, ay = jitter
    px = (pix_x.astype(jnp.float32) + ax) / jnp.float32(w)
    py = (pix_y.astype(jnp.float32) + ay) / jnp.float32(h)

    state, disk = sampling.unit_disk(state)
    rd = basis.lens_radius * disk  # (..., 2)
    offset = rd[..., 0:1] * basis.u + rd[..., 1:2] * basis.v

    origins = basis.origin + offset
    dirs = (
        basis.lower_left
        + px[..., None] * basis.horizontal
        + py[..., None] * basis.vertical
        - origins
    )
    return state, origins, dirs


# ---------------------------------------------------------------------------
# Fly controller (src/core/camera.rs:122-165, 167-247). Host-side, pure.
# ---------------------------------------------------------------------------

_SAFE_PITCH = math.pi / 2.0 - 1e-4


@dataclasses.dataclass
class CameraController:
    """Input accumulator (reference CameraController, src/core/camera.rs:167).

    The reference's pressed-key amount is 5.0 (src/core/camera.rs:203) with
    speed 3.0 and sensitivity 0.35 (src/core/camera.rs:57).
    """

    amount_left: float = 0.0
    amount_right: float = 0.0
    amount_forward: float = 0.0
    amount_backward: float = 0.0
    amount_up: float = 0.0
    amount_down: float = 0.0
    rotate_horizontal: float = 0.0
    rotate_vertical: float = 0.0
    scroll: float = 0.0
    speed: float = 3.0
    sensitivity: float = 0.35

    def press(self, key: str, pressed: bool = True) -> bool:
        """Keyboard mapping (src/core/camera.rs:199-229). Returns handled."""
        amount = 5.0 if pressed else 0.0
        mapping = {
            "w": "amount_forward", "up": "amount_forward",
            "s": "amount_backward", "down": "amount_backward",
            "a": "amount_left", "left": "amount_left",
            "d": "amount_right", "right": "amount_right",
            "space": "amount_up", "shift": "amount_down",
        }
        attr = mapping.get(key.lower())
        if attr is None:
            return False
        setattr(self, attr, amount)
        return True

    def mouse(self, dx: float, dy: float) -> None:
        # src/core/camera.rs:230-233 (the 3.0 factor is the reference's).
        self.rotate_horizontal = dx * 3.0
        self.rotate_vertical = dy * 3.0

    def scroll_line_delta(self, lines: float) -> None:
        """winit ``LineDelta`` path: ``scroll = -(lines * 10000)``
        (src/core/camera.rs:237) — the reference's scale, kept verbatim."""
        self.scroll = -(lines * 10000.0)

    def scroll_pixel_delta(self, pixels_y: float) -> None:
        """winit ``PixelDelta`` path: ``scroll = -pixels``
        (src/core/camera.rs:238-241)."""
        self.scroll = -float(pixels_y)

    def scroll_by(self, delta: float) -> None:
        """Back-compat alias for the pixel path."""
        self.scroll_pixel_delta(delta)


def update_camera(cam: Camera, ctl: CameraController, dt: float) -> Camera:
    """One controller step; returns the moved camera (pure version of
    src/core/camera.rs:122-165).

    The reference clamps pitch in radians against a degrees constant, which
    makes the clamp inert (SURVEY quirk Q4); we clamp to +/-(pi/2 - 1e-4),
    the intended behavior (deviation D6).
    """
    o = np.asarray(cam.origin, np.float64)
    look = np.asarray(cam.look_at, np.float64)
    direction = look - o
    direction /= max(np.linalg.norm(direction), 1e-12)
    pitch = math.asin(float(np.clip(direction[1], -1.0, 1.0)))
    yaw = math.atan2(float(direction[0]), float(direction[2]))

    ys, yc = math.sin(yaw), math.cos(yaw)
    forward = np.array([ys, 0.0, yc])
    right = np.array([yc, 0.0, -ys])
    o = o + forward * (ctl.amount_forward - ctl.amount_backward) * ctl.speed * dt
    o = o + right * (ctl.amount_right - ctl.amount_left) * ctl.speed * dt

    ps, pc = math.sin(pitch), math.cos(pitch)
    scrollward = np.array([pc * yc, ps, pc * ys])
    n = np.linalg.norm(scrollward)
    if n > 1e-12:
        scrollward /= n
    o = o - scrollward * ctl.scroll * ctl.speed * ctl.sensitivity * dt
    ctl.scroll = 0.0

    o[1] += (ctl.amount_up - ctl.amount_down) * ctl.speed * dt

    yaw += ctl.rotate_horizontal * ctl.sensitivity * dt
    pitch += -ctl.rotate_vertical * ctl.sensitivity * dt
    ctl.rotate_horizontal = 0.0
    ctl.rotate_vertical = 0.0
    pitch = max(-_SAFE_PITCH, min(_SAFE_PITCH, pitch))

    look_at = o + np.array(
        [math.cos(pitch) * math.sin(yaw), math.sin(pitch), math.cos(pitch) * math.cos(yaw)]
    )
    return cam.replace(origin=tuple(map(float, o)), look_at=tuple(map(float, look_at)))
