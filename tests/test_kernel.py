"""The Pallas kernel against the jnp oracle, and the one backend rule.

Each oracle case runs twice: in the Pallas interpreter (anywhere), and
compiled for the GPU (marked ``gpu``: skipped off the card;
``python chip_smoke.py`` runs those).
"""

import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import ray_tracer as rt
from ray_tracer.ops import backend as backend_mod
from ray_tracer.ops.backend import kernel_interpret, resolve_backend
from ray_tracer.ops.intersect import intersect, nearest_hit_jnp, occluded
from ray_tracer.ops.pallas_intersect import (CLUSTER, SUPER, anyhit_pallas,
                                             nearest_hit_pallas)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402

MODES = [pytest.param(True, id="interpret"),
         pytest.param(False, id="compiled", marks=pytest.mark.gpu)]
SCENES = ("spheres", "triangles", "room", "random_balls", "mesh2k")


@functools.lru_cache(maxsize=None)
def _scene(name):
    if name == "spheres":
        return rt.builtin_scene("metal")[0]
    if name == "triangles":
        rng = np.random.default_rng(7)
        b = rt.SceneBuilder()
        for t in rng.normal(size=(60, 3, 3)) * 4:
            b.add_mesh(t, np.ones((3, 3)), [0, 1, 2])
        return b.build()
    if name == "room":
        return rt.builtin_scene("room")[0]
    if name == "random_balls":
        return rt.builtin_scene("random_balls", seed=5)[0]
    return chip_smoke.mesh_scene(32, 32, seed=1)[0]


def _rays(name, n, seed):
    """Rays that hit each scene often: from inside the room, from above
    the ball field, from around the mesh; Gaussian elsewhere."""
    rng = np.random.default_rng(seed)
    if name == "room":
        o = rng.uniform([0.5, -2.5, -2.5], [5.5, 2.5, 2.5], (n, 3))
        d = rng.normal(size=(n, 3))
    elif name == "random_balls":
        o = rng.uniform([-11, 0.1, -11], [11, 3, 11], (n, 3))
        d = rng.normal(size=(n, 3)) - [0, 0.5, 0]
    elif name == "mesh2k":
        o = rng.normal(size=(n, 3))
        o = 3.0 * o / np.linalg.norm(o, axis=1, keepdims=True)
        d = rng.normal(size=(n, 3)) * 0.6 - o
    else:
        o = rng.normal(size=(n, 3)) * 6
        d = rng.normal(size=(n, 3))
    return jnp.asarray(o, jnp.float32), jnp.asarray(d, jnp.float32)


def _coordinate_scale(scene):
    """Largest coordinate magnitude of the scene's valid primitives: f32
    positions (and so hit distances) carry about 1.2e-7 of it in error."""
    sv = np.asarray(scene.sphere_valid) > 0.5
    sph = (np.abs(np.asarray(scene.sphere_center)[sv]).max(initial=0.0)
           + np.asarray(scene.sphere_radius)[sv].max(initial=0.0))
    tv = np.asarray(scene.tri_valid) > 0.5
    tri = max(np.abs(np.asarray(v)[tv]).max(initial=0.0)
              for v in (scene.tri_v0, scene.tri_v1, scene.tri_v2))
    return max(sph, tri)


def _assert_matches_oracle(scene, o, d, t, pid, alive=None):
    t_ref, id_ref = map(np.asarray, nearest_hit_jnp(scene, o, d, 1e-4))
    t, pid = np.asarray(t), np.asarray(pid)
    if alive is not None:
        alive = np.asarray(alive)
        assert np.isinf(t[~alive]).all() and (pid[~alive] == 0).all()
        t_ref, id_ref = t_ref[alive], id_ref[alive]
        t, pid = t[alive], pid[alive]
    hit = np.isfinite(t_ref)
    np.testing.assert_array_equal(np.isfinite(t), hit)
    # the tolerance covers fma/association differences between the kernel
    # and XLA; the absolute part is the f32 resolution of the scene's
    # coordinates (random_balls' ground sphere has radius 1000, and its
    # |oc|² - r² cancels to that resolution)
    atol = max(1e-5, 1e-6 * _coordinate_scale(scene))
    np.testing.assert_allclose(t[hit], t_ref[hit], rtol=3e-4, atol=atol)
    # ids may differ only on exact t ties (equally near primitives)
    tie = hit & (pid != id_ref)
    np.testing.assert_allclose(t[tie], t_ref[tie], rtol=3e-4)
    assert (pid[~hit] == 0).all()
    return hit


@pytest.mark.parametrize("interpret", MODES)
@pytest.mark.parametrize("n_rays", [256, 333], ids=["blocks", "ragged"])
@pytest.mark.parametrize("query", ["closest", "anyhit"])
@pytest.mark.parametrize("name", SCENES)
def test_kernel_matches_oracle(name, query, n_rays, interpret):
    """Closest-hit (t, id) and any-hit (blocked) against the oracle, with
    a liveness mask, on whole and ragged ray blocks."""
    scene = _scene(name)
    o, d = _rays(name, n_rays, seed=n_rays)
    alive = jnp.asarray(np.arange(n_rays) % 5 != 0)
    if query == "closest":
        t, pid = nearest_hit_pallas(scene, o, d, 1e-4, alive=alive,
                                    interpret=interpret)
        hit = _assert_matches_oracle(scene, o, d, t, pid, alive)
        assert hit.any()
    else:
        seg = d * jnp.asarray(np.random.default_rng(1).uniform(
            0.2, 1.5, (n_rays, 1)), jnp.float32)
        got = np.asarray(anyhit_pallas(scene, o, seg, 1e-4, alive=alive,
                                       interpret=interpret))
        t_ref, _ = nearest_hit_jnp(scene, o, seg, 1e-4)
        want = (np.asarray(t_ref) < 1.0 - 1e-3) & np.asarray(alive)
        np.testing.assert_array_equal(got, want)
        assert want.any()


def test_mesh_spans_several_super_clusters():
    """The 2k-triangle case exercises the two-level walk for real."""
    scene = _scene("mesh2k")
    n_clusters = -(-scene.num_tris // CLUSTER)
    assert -(-n_clusters // SUPER) >= 4


def test_auto_resolves_to_oracle_off_gpu():
    assert jax.default_backend() != "gpu"
    assert resolve_backend("auto") == "jnp"
    assert rt.renderer.resolved_backend(rt.RenderParams()) == "jnp"
    for name in ("jnp", "pallas"):
        assert resolve_backend(name) == name


def test_auto_resolves_to_kernel_on_gpu(monkeypatch):
    monkeypatch.setattr(backend_mod, "on_gpu", lambda: True)
    assert resolve_backend("auto") == "pallas"
    assert rt.renderer.resolved_backend(rt.RenderParams()) == "pallas"
    assert resolve_backend("jnp") == "jnp"
    assert kernel_interpret(False) is False
    assert kernel_interpret(True) is True


def test_unknown_backend_rejected():
    with pytest.raises(ValueError, match="unknown backend"):
        resolve_backend("mosaic")
    with pytest.raises(ValueError, match="unknown backend"):
        rt.RenderParams(backend="mosaic")


def test_kernel_raises_off_gpu_unless_interpret_asked():
    """Interpret mode is never chosen silently: off the GPU the kernel
    backend raises unless the caller asked for the interpreter."""
    scene = _scene("room")
    o, d = _rays("room", 8, seed=0)
    with pytest.raises(RuntimeError, match="only for a GPU"):
        nearest_hit_pallas(scene, o, d)
    with pytest.raises(RuntimeError, match="only for a GPU"):
        anyhit_pallas(scene, o, d)
    with pytest.raises(RuntimeError, match="only for a GPU"):
        intersect(scene, o, d, backend="pallas")
    with pytest.raises(RuntimeError, match="only for a GPU"):
        occluded(scene, o, d, backend="pallas")
    _, cam = rt.builtin_scene("room")
    with pytest.raises(RuntimeError, match="only for a GPU"):
        rt.render_frame(scene, rt.camera_basis(cam),
                        rt.RenderParams(width=8, height=8, backend="pallas"),
                        jnp.int32(0))
    assert kernel_interpret(True) is True


def test_render_gradients_kernel_matches_oracle():
    """Image-MSE gradients through the kernel path equal the oracle
    path's (same winners, same differentiable recompute)."""
    from ray_tracer.grad.inverse import image_mse, split_scene
    scene, cam = chip_smoke.mesh_scene(16, 8, seed=2)
    params = rt.RenderParams(width=16, height=16, bounces=2, skybox=True)
    basis = rt.camera_basis(cam)
    target = rt.render_frame(scene, basis, params.replace(backend="jnp"),
                             jnp.int32(3))
    tr, _ = split_scene(scene)
    grads = [jax.grad(image_mse)(tr, scene, basis, params.replace(**kw),
                                 jnp.int32(0), target)
             for kw in (dict(backend="pallas", interpret=True),
                        dict(backend="jnp"))]
    nonzero = 0
    for k in grads[1]:
        a, b = np.asarray(grads[0][k]), np.asarray(grads[1][k])
        np.testing.assert_allclose(a, b, rtol=1e-3,
                                   atol=1e-3 * float(np.abs(b).max()) + 1e-9,
                                   err_msg=k)
        nonzero += bool(np.abs(b).max() > 0)
    assert nonzero >= 3
