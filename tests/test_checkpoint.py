"""Checkpoint/resume round-trip tests."""

import numpy as np
import jax.numpy as jnp
import optax

import ray_tracer as rt
from ray_tracer.grad import make_train_step
from ray_tracer.utils.checkpoint import (
    load_renderer, load_training, save_renderer, save_training)


def _mk():
    scene, cam = rt.builtin_scene("metal", aspect=1.0, pad=8)
    params = rt.RenderParams(width=8, height=8, bounces=1, skybox=True,
                             backend="jnp")
    return scene, cam, params


def test_renderer_roundtrip_continues_accumulation(tmp_path):
    scene, cam, params = _mk()
    r = rt.Renderer(scene, cam, params)
    for _ in range(3):
        r.step()
    path = str(tmp_path / "ckpt.npz")
    save_renderer(path, r)

    r2 = load_renderer(path, scene)
    assert r2.frames == r.frames
    assert r2.params == r.params
    np.testing.assert_array_equal(np.asarray(r2.image), np.asarray(r.image))

    # continuing must match an uninterrupted run frame-for-frame
    r.step()
    r2.step()
    np.testing.assert_allclose(np.asarray(r.image), np.asarray(r2.image),
                               atol=1e-7)


def test_renderer_roundtrip_before_first_frame(tmp_path):
    scene, cam, params = _mk()
    r = rt.Renderer(scene, cam, params)
    path = str(tmp_path / "fresh.npz")
    save_renderer(path, r)
    r2 = load_renderer(path, scene)
    assert r2.frames == -1
    np.testing.assert_array_equal(np.asarray(r2.step()), np.asarray(r.step()))


def test_training_roundtrip(tmp_path):
    scene, cam, params = _mk()
    basis = rt.camera_basis(cam)
    target = jnp.zeros((8, 8, 3))
    opt = optax.adam(1e-2)
    init_fn, step_fn = make_train_step(params, opt)
    trainable, opt_state = init_fn(scene, fields=("sphere_albedo",))
    for i in range(2):
        trainable, opt_state, _ = step_fn(trainable, opt_state, scene, basis,
                                          target, jnp.int32(0))
    path = str(tmp_path / "train.npz")
    save_training(path, trainable, opt_state, step=2, extra={"note": "x"})

    t2, o2, step, extra = load_training(path, init_fn(scene, ("sphere_albedo",))[1])
    assert step == 2 and extra == {"note": "x"}
    np.testing.assert_array_equal(np.asarray(t2["sphere_albedo"]),
                                  np.asarray(trainable["sphere_albedo"]))

    # resumed step must equal uninterrupted step
    a1 = step_fn(trainable, opt_state, scene, basis, target, jnp.int32(0))
    a2 = step_fn(t2, o2, scene, basis, target, jnp.int32(0))
    np.testing.assert_allclose(np.asarray(a1[0]["sphere_albedo"]),
                               np.asarray(a2[0]["sphere_albedo"]), atol=1e-7)


def test_viewer_importable_headless():
    """Viewer must import cleanly and refuse politely without a GUI."""
    import matplotlib
    matplotlib.use("Agg", force=True)
    import pytest
    from ray_tracer.viewer import view
    scene, cam, params = _mk()
    with pytest.raises(RuntimeError, match="headless"):
        view(scene, cam, params)
