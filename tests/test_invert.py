"""CPU-scale pin of the inverse-rendering north-star recovery config:
the EXACT recovery loop tools/invert_teapot.py runs — CRN
finite-difference offset + hit-overlap-masked albedo autodiff + phased
two-timescale schedule — run on a small scene with a fixed seed,
asserting the error bounds. If any ingredient of the config rots
(estimator, masking, schedule, fd anneal), this fails long before the
next full-scale run."""

import sys

import numpy as np
import jax.numpy as jnp
import pytest

import ray_tracer as rt

sys.path.insert(0, "/root/repo")


def _cube_scene(albedo):
    """A 12-tri unit cube at the origin, flat normals, on no floor —
    silhouette against the sky carries the offset signal exactly like the
    teapot workload."""
    b = rt.SceneBuilder()
    v = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1)
                  for z in (-1, 1)], np.float32)
    faces = [  # quads as (corner ids), outward normals
        ([0, 1, 3, 2], (-1, 0, 0)), ([4, 6, 7, 5], (1, 0, 0)),
        ([0, 4, 5, 1], (0, -1, 0)), ([2, 3, 7, 6], (0, 1, 0)),
        ([0, 2, 6, 4], (0, 0, -1)), ([1, 5, 7, 3], (0, 0, 1)),
    ]
    for q, n in faces:
        for tri in ((q[0], q[1], q[2]), (q[0], q[2], q[3])):
            verts = v[list(tri)]
            normals = np.tile(np.asarray(n, np.float32), (3, 1))
            b.add_mesh(verts, normals, [0, 1, 2], albedo=albedo,
                       smoothness=0.0)
    return b


def test_recovery_loop_converges_cpu():
    from tools.invert_teapot import run_recovery

    true_albedo = np.array([0.7, 0.45, 0.25], np.float32)
    b = _cube_scene(tuple(true_albedo))
    lo, hi = b.bounds()
    scene = b.build(pad=128)
    center, ext = (lo + hi) / 2, float(np.linalg.norm(hi - lo))
    cam = rt.Camera(origin=tuple(center + ext * np.array([0.7, 0.4, 0.7])),
                    look_at=tuple(center), aspect=1.0, focus_dist=1.0)
    basis = rt.camera_basis(cam)
    params = rt.RenderParams(width=64, height=64, bounces=1, skybox=True,
                             rays_per_pixel=2, backend="jnp")

    start_offset = jnp.asarray(
        0.12 * ext * np.array([1.0, -0.6, 0.4]), jnp.float32)
    start_albedo = np.array([0.35, 0.6, 0.55], np.float32)

    offset, albedo, losses = run_recovery(
        scene, ext, params, 100, start_offset, start_albedo, basis,
        log=False)

    off_err = float(np.linalg.norm(offset)) / ext
    alb_err = float(np.abs(albedo - true_albedo).max())
    assert off_err < 0.02, (off_err, losses[-3:])
    assert alb_err < 0.05, (alb_err, albedo)
    # and the CRN loss actually descended to near its exact zero
    assert losses[-1] < losses[0] * 0.05, losses[::10]
