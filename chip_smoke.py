"""Smoke test of the path tracer on one GPU, or on four with --four-gpus.

Drives the main path once through the entry points a user calls, at the
size the repository calls its flagship, on scenes made from a seed:

  kernel_tests  the compiled-kernel test cases (pytest -m gpu), in-process
  mesh_1080p    render_frame at 1920x1080, 3 bounces, 1 rpp, skybox on, a
                seeded 16k-triangle mesh; primary-ray parity of the kernel
                with the jnp oracle over the whole frame
  progressive   render_progressive of the same frame, 4 frames
  cli_render    `python -m ray_tracer render` of the mesh written as an OBJ
  nee_1080p     `room` with NEE and MIS at 1080p (drives the any-hit kernel)
  parity_256    3-bounce frames at 256x256 per scene, kernel vs oracle
  grad_128      image-MSE gradients at 128x128, kernel vs oracle
  train_1080p   make_train_step steps at 1080p with edge-sampled gradients

--four-gpus runs only the multi-device path and its comparison:
render_frame_distributed on a 4-GPU mesh against the 1-GPU image, and
make_train_step(mesh=..., grad_chunks=2) against the 1-GPU gradient.

Prints the card's name and power limit, per-phase compile and steady
times (block_until_ready as the sync) and every parity number beside its
tolerance; the last line is {"ok": true, "device": {...}}. Exits nonzero,
printing no result, when JAX finds no GPU or any phase fails.

    python chip_smoke.py [--four-gpus]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out", "smoke")
W1080, H1080 = 1920, 1080


# ---------------------------------------------------------------------------
# Seeded workload
# ---------------------------------------------------------------------------

def seeded_mesh(n_u: int = 128, n_v: int = 64, seed: int = 0):
    """A closed bumpy torus of 2·n_u·n_v triangles → (vertices (N, 3),
    vertex normals (N, 3), faces (F, 3)). The seed picks the bumps: four
    sinusoidal modes of the tube radius. Faces wind outward (the
    intersection test culls back faces)."""
    rng = np.random.default_rng(seed)
    u = np.arange(n_u) * (2 * np.pi / n_u)
    v = np.arange(n_v) * (2 * np.pi / n_v)
    uu, vv = np.meshgrid(u, v, indexing="ij")                  # (n_u, n_v)
    m = rng.integers(1, 7, size=4)
    k = rng.integers(1, 5, size=4)
    amp = rng.uniform(0.5, 1.0, size=4)
    phase = rng.uniform(0, 2 * np.pi, size=4)
    bump = sum(a * np.sin(mi * uu + ki * vv + p)
               for a, mi, ki, p in zip(amp, m, k, phase)) / amp.sum()
    r = 0.4 * (1.0 + 0.25 * bump)
    ring = 1.0 + r * np.cos(vv)
    verts = np.stack([ring * np.cos(uu), r * np.sin(vv), ring * np.sin(uu)],
                     -1).reshape(-1, 3)
    i, j = np.meshgrid(np.arange(n_u), np.arange(n_v), indexing="ij")
    a = i * n_v + j
    b = ((i + 1) % n_u) * n_v + j
    c = ((i + 1) % n_u) * n_v + (j + 1) % n_v
    d = i * n_v + (j + 1) % n_v
    faces = np.concatenate([np.stack([a, b, c], -1).reshape(-1, 3),
                            np.stack([a, c, d], -1).reshape(-1, 3)])
    fn = np.cross(verts[faces[:, 1]] - verts[faces[:, 0]],
                  verts[faces[:, 2]] - verts[faces[:, 0]])
    cen = verts[faces].mean(1)
    ring_center = cen * [1.0, 0.0, 1.0] / np.linalg.norm(
        cen[:, [0, 2]], axis=1, keepdims=True)       # major radius 1
    if np.sum(fn * (cen - ring_center)) < 0:         # wind outward
        faces = faces[:, [0, 2, 1]]
        fn = -fn
    normals = np.zeros_like(verts)
    for corner in range(3):
        np.add.at(normals, faces[:, corner], fn)
    normals /= np.maximum(np.linalg.norm(normals, axis=1, keepdims=True),
                          1e-12)
    return (verts.astype(np.float32), normals.astype(np.float32),
            faces.astype(np.int64))


def mesh_scene(n_u: int = 128, n_v: int = 64, seed: int = 0,
               aspect: float = 1.0):
    """The seeded mesh on a ground sphere, framed by a camera."""
    import ray_tracer as rt
    verts, normals, faces = seeded_mesh(n_u, n_v, seed)
    b = rt.SceneBuilder()
    b.add_mesh(verts, normals, faces.reshape(-1), albedo=(0.7, 0.5, 0.3),
               smoothness=0.3)
    b.add_sphere((0.0, -1000.6, 0.0), 1000.0, (0.5, 0.5, 0.5))
    cam = rt.Camera(origin=(0.0, 1.6, 3.2), look_at=(0.0, 0.0, 0.0),
                    fov=45.0, aspect=aspect, focus_dist=1.0)
    return b.build(), cam


def write_obj(path: str, verts, normals, faces) -> None:
    with open(path, "w") as f:
        f.writelines(f"v {x:.7g} {y:.7g} {z:.7g}\n" for x, y, z in verts)
        f.writelines(f"vn {x:.7g} {y:.7g} {z:.7g}\n" for x, y, z in normals)
        f.writelines(f"f {a}//{a} {b}//{b} {c}//{c}\n"
                     for a, b, c in faces + 1)


# ---------------------------------------------------------------------------
# Reporting
# ---------------------------------------------------------------------------

def say(phase: str, **kv) -> None:
    body = ", ".join(f"{k}={v}" for k, v in kv.items())
    print(f"[{phase}] {body}", flush=True)


def check(phase: str, name: str, value: float, limit: float) -> None:
    """Print a parity number beside its tolerance; fail past it."""
    ok = value <= limit
    say(phase, **{name: f"{value:.3e}", "limit": f"{limit:.1e}",
                  "within": ok})
    if not ok:
        raise AssertionError(f"{phase}: {name}={value:.3e} > {limit:.1e}")


def timed(phase: str, fn, *args, runs: int = 3):
    """First call (compile + run) and the median of ``runs`` steady calls,
    each synced with block_until_ready."""
    import jax
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    steady = []
    for _ in range(runs):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        steady.append(time.perf_counter() - t0)
    say(phase, first_call_s=f"{first:.2f}",
        steady_s=f"{float(np.median(steady)):.4f}",
        steady_runs_s="[" + ", ".join(f"{s:.4f}" for s in steady) + "]")
    return out


def peak_memory(phase: str) -> None:
    import jax
    stats = jax.devices()[0].memory_stats() or {}
    if "peak_bytes_in_use" in stats:
        say(phase, peak_gib=f"{stats['peak_bytes_in_use'] / 2**30:.2f}")


def frac_off(a, b, tol: float = 2e-2) -> float:
    """Share of pixels whose max-channel difference exceeds ``tol``."""
    return float((np.abs(np.asarray(a) - np.asarray(b)).max(-1) > tol)
                 .mean())


def rel_err(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def phase_kernel_tests() -> None:
    import pytest
    t0 = time.perf_counter()
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(ROOT, "tests", "test_kernel.py")])
    say("kernel_tests", pytest_rc=int(rc),
        seconds=f"{time.perf_counter() - t0:.1f}")
    if rc != 0:
        raise AssertionError(f"compiled kernel tests failed (rc={rc})")


def pinhole_rays(basis, W: int, H: int):
    """Pixel-center primary rays in the renderer's blocked pixel order."""
    import jax.numpy as jnp
    from ray_tracer.renderer import _blocked_order
    pid = jnp.asarray(_blocked_order(W, H)[0])
    px = ((pid % W).astype(jnp.float32) + 0.5) / W
    py = ((pid // W).astype(jnp.float32) + 0.5) / H
    d = (basis.lower_left + px[:, None] * basis.horizontal
         + py[:, None] * basis.vertical - basis.origin)
    return jnp.broadcast_to(basis.origin, d.shape), d


def oracle_nearest(scene, o, d, chunk: int = 16200):
    """nearest_hit_jnp over ray chunks (bounds its rays × primitives
    intermediates), at full matmul precision."""
    import jax
    import jax.numpy as jnp
    from ray_tracer.ops.intersect import nearest_hit_jnp
    n = o.shape[0]
    pad = -n % chunk
    o_p = jnp.pad(o, ((0, pad), (0, 0))).reshape(-1, chunk, 3)
    d_p = jnp.pad(d, ((0, pad), (0, 0)), constant_values=1.0)
    d_p = d_p.reshape(-1, chunk, 3)
    with jax.default_matmul_precision("highest"):
        t, i = jax.jit(lambda sc, oo, dd: jax.lax.map(
            lambda od: nearest_hit_jnp(sc, od[0], od[1], 1e-4),
            (oo, dd)))(scene, o_p, d_p)
    return t.reshape(-1)[:n], i.reshape(-1)[:n]


def phase_mesh_1080p(scene, cam) -> None:
    import jax
    import jax.numpy as jnp
    import ray_tracer as rt
    from ray_tracer.ops.intersect import hit_attributes
    from ray_tracer.ops.pallas_intersect import nearest_hit_pallas
    from ray_tracer.renderer import render_frame

    params = rt.RenderParams(width=W1080, height=H1080, bounces=3,
                             rays_per_pixel=1, skybox=True)
    basis = rt.camera_basis(cam.replace(aspect=params.aspect))
    say("mesh_1080p", tris=scene.num_tris, spheres=scene.num_spheres,
        backend=rt.renderer.resolved_backend(params))
    img = timed("mesh_1080p", lambda: render_frame(scene, basis, params,
                                                   jnp.int32(0)))
    img = np.asarray(img)
    if img.shape != (H1080, W1080, 3) or not np.isfinite(img).all():
        raise AssertionError(f"bad frame: shape {img.shape}, "
                             f"finite {np.isfinite(img).all()}")
    say("mesh_1080p", mean_radiance=f"{img.mean():.4f}")

    o, d = pinhole_rays(basis, W1080, H1080)
    t_k, id_k = timed("mesh_1080p_primary_kernel",
                      jax.jit(nearest_hit_pallas), scene, o, d)
    t_o, id_o = oracle_nearest(scene, o, d)
    t_k, id_k, t_o, id_o = map(np.asarray, (t_k, id_k, t_o, id_o))
    hit_k, hit_o = np.isfinite(t_k), np.isfinite(t_o)
    differ = (hit_k != hit_o) | (hit_o & (id_k != id_o))
    say("mesh_1080p", primary_rays=t_k.size, hit_rays=int(hit_o.sum()),
        id_mismatches=int(differ.sum()))
    check("mesh_1080p", "id_mismatch_share", float(differ.mean()), 1e-5)
    same = hit_o & ~differ
    # the search's own t (used for miss tests and culling) is reported,
    # not gated: at grazing incidence det = -d·n cancels, so the last
    # bits differ with how XLA and Triton fuse the products (0 to 2e-5
    # relative across runs); the renderer consumes the recomputed Hit.t
    search_err = np.abs(t_k[same] - t_o[same]) / t_o[same]
    say("mesh_1080p", search_t_max_rel_err=f"{float(search_err.max()):.3e}")
    # the attributes both backends hand the renderer, from each one's
    # winners, through one compiled recompute (two separately compiled
    # programs may round grazing rays' last bits differently)
    with jax.default_matmul_precision("highest"):
        attrs = jax.jit(lambda sc, oo, dd, i, t: hit_attributes(
            sc, oo, dd, i, jnp.isinf(t), 1e-4))
        h_k = attrs(scene, o, d, jnp.asarray(id_k), jnp.asarray(t_k))
        h_o = attrs(scene, o, d, jnp.asarray(id_o), jnp.asarray(t_o))
    for field in ("t", "normal", "albedo", "emission"):
        a = np.asarray(getattr(h_k, field))[same]
        b = np.asarray(getattr(h_o, field))[same]
        check("mesh_1080p", f"hit_{field}_max_rel_err",
              float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1.0))),
              1e-5)
    peak_memory("mesh_1080p")


def phase_progressive(scene, cam) -> None:
    import ray_tracer as rt
    from ray_tracer.renderer import render_progressive
    params = rt.RenderParams(width=W1080, height=H1080, bounces=3,
                             skybox=True)
    basis = rt.camera_basis(cam.replace(aspect=params.aspect))
    img = timed("progressive_4f", lambda: render_progressive(
        scene, basis, params, 4, chunk=4), runs=1)
    if not np.isfinite(np.asarray(img)).all():
        raise AssertionError("progressive render is not finite")


def phase_cli_render() -> None:
    from ray_tracer import cli
    os.makedirs(OUT_DIR, exist_ok=True)
    obj = os.path.join(OUT_DIR, "mesh.obj")
    png = os.path.join(OUT_DIR, "mesh_1080p.png")
    write_obj(obj, *seeded_mesh())
    t0 = time.perf_counter()
    cli.main(["render", "--model", obj, "--width", str(W1080), "--height",
              str(H1080), "--frames", "2", "--skybox", "-o", png])
    say("cli_render", seconds=f"{time.perf_counter() - t0:.2f}",
        png_bytes=os.path.getsize(png))


def phase_nee_1080p() -> None:
    import jax.numpy as jnp
    import ray_tracer as rt
    from ray_tracer.renderer import render_frame
    params = rt.RenderParams(width=W1080, height=H1080, bounces=3,
                             skybox=False, nee=True, mis=True)
    scene, cam = rt.builtin_scene("room", aspect=params.aspect)
    basis = rt.camera_basis(cam)
    img = np.asarray(timed("nee_1080p", lambda: render_frame(
        scene, basis, params, jnp.int32(0))))
    if not np.isfinite(img).all() or img.mean() <= 0.0:
        raise AssertionError("NEE frame is not finite and positive")
    say("nee_1080p", mean_radiance=f"{img.mean():.4f}")
    peak_memory("nee_1080p")


def parity_scenes(mesh):
    import ray_tracer as rt
    scenes = {"mesh16k": (mesh, False)}
    for name in ("room", "balls", "random_balls", "metal"):
        scenes[name] = (rt.builtin_scene(name, aspect=1.0), name == "room")
    return scenes


def phase_parity_256(mesh) -> None:
    import jax
    import jax.numpy as jnp
    import ray_tracer as rt
    from ray_tracer.renderer import render_frame
    for name, ((scene, cam), nee) in parity_scenes(mesh).items():
        params = rt.RenderParams(width=256, height=256, bounces=3,
                                 skybox=not nee, nee=nee)
        basis = rt.camera_basis(cam.replace(aspect=1.0))
        img_k = render_frame(scene, basis, params.replace(backend="pallas"),
                             jnp.int32(0))
        with jax.default_matmul_precision("highest"):
            img_o = render_frame(scene, basis, params.replace(
                backend="jnp", chunk_pixels=16384), jnp.int32(0))
        img_k, img_o = np.asarray(img_k), np.asarray(img_o)
        # the reference's sky evaluates its sun lobe on the unnormalized
        # ray direction, which overflows for long camera rays (random_balls
        # focuses at 10): both paths must agree on those pixels too
        fin_k, fin_o = (np.isfinite(img_k).all(-1),
                        np.isfinite(img_o).all(-1))
        if (fin_k != fin_o).any():
            raise AssertionError(f"parity_256 {name}: non-finite pixels "
                                 f"differ from the oracle's")
        if not fin_o.all():
            say("parity_256", **{f"{name}_nonfinite_pixels_both":
                                 int((~fin_o).sum())})
        check("parity_256", f"{name}_frac_pixels_off",
              frac_off(img_k[fin_o], img_o[fin_o]), 2e-3)


def mse_grads(scene, basis, params, target):
    import jax
    import jax.numpy as jnp
    from ray_tracer.grad.inverse import image_mse, split_scene
    trainable, _ = split_scene(scene)
    return jax.jit(jax.grad(image_mse), static_argnums=(3,))(
        trainable, scene, basis, params, jnp.int32(0), target)


def phase_grad_128(mesh) -> None:
    import jax
    import jax.numpy as jnp
    import ray_tracer as rt
    from ray_tracer.renderer import render_frame
    scene, cam = mesh
    params = rt.RenderParams(width=128, height=128, bounces=3, skybox=True)
    basis = rt.camera_basis(cam.replace(aspect=1.0))
    target = render_frame(scene, basis, params.replace(backend="pallas"),
                          jnp.int32(7))
    g_k = mse_grads(scene, basis, params.replace(backend="pallas"), target)
    with jax.default_matmul_precision("highest"):
        g_o = mse_grads(scene, basis, params.replace(
            backend="jnp", chunk_pixels=4096), target)
    for k in sorted(g_k):
        if not np.isfinite(np.asarray(g_k[k])).all():
            raise AssertionError(f"grad_128: non-finite gradient {k}")
        if float(np.abs(np.asarray(g_o[k])).max()) == 0.0:
            continue
        check("grad_128", f"{k}_rel_err", rel_err(g_k[k], g_o[k]), 1e-3)


def phase_train_1080p(mesh) -> None:
    import jax
    import jax.numpy as jnp
    import optax
    import ray_tracer as rt
    from ray_tracer.grad.inverse import make_train_step
    from ray_tracer.grad.topology import build_topology
    from ray_tracer.renderer import render_frame
    scene, cam = mesh
    params = rt.RenderParams(width=W1080, height=H1080, bounces=3,
                             skybox=True)
    basis = rt.camera_basis(cam.replace(aspect=params.aspect))
    target = render_frame(scene, basis, params, jnp.int32(1))
    init_fn, step_fn = make_train_step(
        params, optax.adam(1e-3), edge_samples=4096,
        topology=build_topology(scene))
    trainable, opt_state = init_fn(scene)
    state = [trainable, opt_state]

    def step():
        tr, st, loss = step_fn(state[0], state[1], scene, basis, target,
                               jnp.int32(0))
        state[:] = [tr, st]
        return loss

    loss = timed("train_1080p", step, runs=2)
    leaves = jax.tree_util.tree_leaves(state[0])
    if not (np.isfinite(float(loss))
            and all(np.isfinite(np.asarray(x)).all() for x in leaves)):
        raise AssertionError(f"train_1080p: non-finite loss or params "
                             f"(loss {float(loss)})")
    say("train_1080p", loss=f"{float(loss):.6f}", edge_samples=4096)
    peak_memory("train_1080p")


def phase_four_gpus(mesh) -> None:
    import jax
    import jax.numpy as jnp
    import optax
    import ray_tracer as rt
    from ray_tracer.grad.inverse import make_train_step
    from ray_tracer.parallel import make_mesh, render_frame_distributed
    from ray_tracer.renderer import render_frame
    scene, cam = mesh
    dev_mesh = make_mesh(4)
    params = rt.RenderParams(width=W1080, height=H1080, bounces=3,
                             skybox=True)
    basis = rt.camera_basis(cam.replace(aspect=params.aspect))
    img1 = timed("four_gpus_render_1gpu", lambda: render_frame(
        scene, basis, params, jnp.int32(0)))
    img4 = timed("four_gpus_render_4gpu", lambda: render_frame_distributed(
        scene, basis, params, 0, dev_mesh))
    check("four_gpus", "render_max_abs_diff",
          float(np.abs(np.asarray(img1) - np.asarray(img4)).max()), 1e-5)

    target = render_frame(scene, basis, params, jnp.int32(1))
    grads = {}
    for label, m in (("1gpu", None), ("4gpu", dev_mesh)):
        init_fn, step_fn = make_train_step(params, optax.sgd(1.0), mesh=m,
                                           grad_chunks=2)
        trainable, opt_state = init_fn(scene)
        tr, _, _ = timed(f"four_gpus_train_{label}", step_fn, trainable,
                         opt_state, scene, basis, target, jnp.int32(0),
                         runs=2)
        # one SGD step at learning rate 1: the update is -gradient
        grads[label] = {k: trainable[k] - tr[k] for k in trainable}
    for k in sorted(grads["1gpu"]):
        if float(jnp.abs(grads["1gpu"][k]).max()) == 0.0:
            continue
        check("four_gpus", f"grad_{k}_rel_err",
              rel_err(grads["4gpu"][k], grads["1gpu"][k]), 1e-3)


# ---------------------------------------------------------------------------
# Main
# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-gpus", action="store_true",
                    help="run only the 4-GPU path and its comparison")
    args = ap.parse_args(argv)

    import jax
    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: JAX found no GPU (platform "
              f"{devices[0].platform!r}); refusing to run", file=sys.stderr)
        return 2
    want = 4 if args.four_gpus else 1
    if len(devices) < want:
        print(f"chip_smoke: needs {want} GPUs, JAX found {len(devices)}",
              file=sys.stderr)
        return 2

    sys.path.insert(0, ROOT)
    from ray_tracer.utils.compile_cache import enable_compile_cache
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(smi, flush=True)        # one line per card: name, power limit
    say("setup", jax=jax.__version__, device_kind=devices[0].device_kind,
        devices=len(devices), compile_cache=enable_compile_cache())

    t0 = time.perf_counter()
    mesh = mesh_scene()
    say("setup", mesh_tris=mesh[0].num_tris,
        build_s=f"{time.perf_counter() - t0:.2f}")
    if args.four_gpus:
        phase_four_gpus(mesh)
    else:
        phase_kernel_tests()
        phase_mesh_1080p(*mesh)
        phase_progressive(*mesh)
        phase_cli_render()
        phase_nee_1080p()
        phase_parity_256(mesh)
        phase_grad_128(mesh)
        phase_train_1080p(mesh)
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
