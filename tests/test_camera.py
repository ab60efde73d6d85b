"""Camera basis + ray generation tests against hand-computed RTiOW math
(reference: src/core/camera.rs:79-121; shaders/ray_tracer.wgsl:313-321)."""

import math

import numpy as np
import jax.numpy as jnp

import ray_tracer as rt
from ray_tracer import Camera, CameraController, camera_basis, camera_rays, update_camera
from ray_tracer import sampling


def _np_basis(origin, look_at, vup, fov, aspect, focus_dist, aperture):
    origin, look_at, vup = map(np.asarray, (origin, look_at, vup))
    theta = math.radians(fov)
    height = 2.0 * math.tan(theta / 2.0)
    width = aspect * height
    w = origin - look_at
    w = w / np.linalg.norm(w)
    u = np.cross(vup, w)
    u = u / np.linalg.norm(u)
    v = np.cross(w, u)
    horizontal = focus_dist * width * u
    vertical = focus_dist * height * v
    lower_left = origin - horizontal / 2 - vertical / 2 - focus_dist * w
    return origin, lower_left, horizontal, vertical, u, v, w, aperture / 2


def test_basis_matches_rtiow_formula():
    cam = Camera(origin=(0.0, 0.0, 3.0), look_at=(0.0, 0.0, -1.0),
                 fov=45.0, aspect=1.5, aperture=0.2, focus_dist=4.0)
    b = camera_basis(cam)
    o, ll, h, v, u, vv, w, lr = _np_basis(cam.origin, cam.look_at, cam.vup,
                                          cam.fov, cam.aspect,
                                          cam.focus_dist, cam.aperture)
    np.testing.assert_allclose(np.asarray(b.origin), o, atol=1e-6)
    np.testing.assert_allclose(np.asarray(b.lower_left), ll, atol=1e-6)
    np.testing.assert_allclose(np.asarray(b.horizontal), h, atol=1e-6)
    np.testing.assert_allclose(np.asarray(b.vertical), v, atol=1e-6)
    np.testing.assert_allclose(np.asarray(b.u), u, atol=1e-6)
    np.testing.assert_allclose(np.asarray(b.v), vv, atol=1e-6)
    np.testing.assert_allclose(np.asarray(b.w), w, atol=1e-6)
    assert abs(float(b.lens_radius) - lr) < 1e-7


def test_ray_through_center_pixel_points_at_look_at():
    cam = Camera(origin=(0.0, 0.0, 3.0), look_at=(0.0, 0.0, -1.0),
                 fov=45.0, aspect=1.0, aperture=0.0, focus_dist=1.0)
    b = camera_basis(cam)
    W = H = 101
    px = jnp.asarray([W // 2], jnp.uint32)
    py = jnp.asarray([H // 2], jnp.uint32)
    state = jnp.zeros((1,), jnp.uint32)
    _, o, d = camera_rays(b, px, py, (W, H), state)
    d = np.asarray(d)[0]
    d = d / np.linalg.norm(d)
    expected = np.array([0.0, 0.0, -1.0])
    # AA jitter keeps it within ~1 pixel of exact center
    assert np.dot(d, expected) > 0.999


def test_zero_aperture_rays_share_origin():
    cam = Camera(origin=(1.0, 2.0, 3.0), look_at=(0.0, 0.0, 0.0), aperture=0.0)
    b = camera_basis(cam)
    px = jnp.arange(64, dtype=jnp.uint32)
    py = jnp.zeros(64, jnp.uint32)
    state = jnp.arange(64, dtype=jnp.uint32)
    _, o, _ = camera_rays(b, px, py, (64, 64), state)
    np.testing.assert_allclose(
        np.asarray(o), np.tile(np.array([[1.0, 2.0, 3.0]]), (64, 1)), atol=1e-6)


def test_aperture_spreads_origins_in_lens_plane():
    cam = Camera(origin=(0.0, 0.0, 0.0), look_at=(0.0, 0.0, -1.0), aperture=1.0)
    b = camera_basis(cam)
    px = jnp.zeros(512, jnp.uint32)
    py = jnp.zeros(512, jnp.uint32)
    state = jnp.arange(512, dtype=jnp.uint32)
    _, o, _ = camera_rays(b, px, py, (64, 64), state)
    o = np.asarray(o)
    r = np.linalg.norm(o[:, :2], axis=-1)
    assert r.max() <= 0.5 + 1e-5          # lens_radius = aperture/2
    assert r.std() > 0.01                 # actually spread
    np.testing.assert_allclose(o[:, 2], 0.0, atol=1e-6)  # in u,v plane


def test_update_camera_moves_forward():
    cam = Camera(origin=(0.0, 0.0, 0.0), look_at=(0.0, 0.0, 1.0))
    ctl = CameraController()
    ctl.press("w")
    moved = update_camera(cam, ctl, dt=0.1)
    # forward along +z at speed 3 with amount 5 → dz = 5*3*0.1 = 1.5
    assert abs(moved.origin[2] - 1.5) < 1e-6
    assert abs(moved.origin[0]) < 1e-6


def test_update_camera_pitch_clamped():
    cam = Camera(origin=(0.0, 0.0, 0.0), look_at=(0.0, 0.0, 1.0))
    ctl = CameraController()
    ctl.mouse(0.0, -1e6)  # huge upward rotation
    moved = update_camera(cam, ctl, dt=1.0)
    d = np.asarray(moved.look_at) - np.asarray(moved.origin)
    d = d / np.linalg.norm(d)
    assert d[1] <= 1.0 and d[1] > 0.99  # pitched up but not past vertical


def test_camera_basis_jnp_matches_numpy():
    """The differentiable basis must reproduce the host-numpy basis
    exactly (same math, f32)."""
    from ray_tracer.camera import camera_basis, camera_basis_jnp

    cam = Camera(origin=(1.0, 2.0, 3.0), look_at=(0.0, 0.5, -1.0),
                 fov=35.0, aspect=1.5, focus_dist=2.5, aperture=0.2)
    a = camera_basis(cam)
    b = camera_basis_jnp(cam.origin, cam.look_at, cam.vup, cam.fov,
                         cam.aspect, cam.focus_dist, cam.aperture)
    for f in ("origin", "lower_left", "horizontal", "vertical", "u", "v",
              "w", "lens_radius"):
        np.testing.assert_allclose(np.asarray(getattr(a, f)),
                                   np.asarray(getattr(b, f)), rtol=1e-6,
                                   atol=1e-7, err_msg=f)


def test_camera_pose_recovery():
    """Camera calibration by gradient descent — the camera closes the
    differentiable story (scene geometry/materials/textures/emission all
    had gradients; the pose now does too via camera_basis_jnp). Recover a
    translated camera origin from a CRN target on the metal scene."""
    import jax
    import optax
    from ray_tracer.camera import camera_basis_jnp
    from ray_tracer.renderer import render_frame

    scene, cam = rt.builtin_scene("metal", aspect=1.0)
    params = rt.RenderParams(width=32, height=32, bounces=1, skybox=True,
                             backend="jnp")
    true_origin = jnp.asarray(cam.origin, jnp.float32)

    def render_at(origin, frame):
        basis = camera_basis_jnp(origin, cam.look_at, cam.vup, cam.fov,
                                 cam.aspect, cam.focus_dist)
        return render_frame(scene, basis, params, frame)

    @jax.jit
    def step(origin, opt_state, frame):
        # common random numbers: target re-rendered with the same frame
        # index so the loss has an exact zero at the true pose
        target = jax.lax.stop_gradient(render_at(true_origin, frame))
        loss, g = jax.value_and_grad(
            lambda o: jnp.mean((render_at(o, frame) - target) ** 2))(origin)
        upd, opt_state = opt.update(g, opt_state)
        return optax.apply_updates(origin, upd), opt_state, loss

    opt = optax.adam(optax.cosine_decay_schedule(0.08, 60, alpha=0.02))
    origin = true_origin + jnp.asarray([0.25, -0.15, 0.2], jnp.float32)
    start_err = float(jnp.linalg.norm(origin - true_origin))
    opt_state = opt.init(origin)
    for i in range(60):
        origin, opt_state, loss = step(origin, opt_state, jnp.int32(i))
    err = float(jnp.linalg.norm(origin - true_origin))
    assert err < 0.25 * start_err, (err, start_err, float(loss))
