"""Benchmark entry: prints ONE JSON line, measured on the GPU.

Headline metric (BASELINE.md): rays/s, forward, 1080p. "rays" counts
traced ray segments: width*height*rpp*(bounces+1) per frame — the
bounce-synchronous wavefront computes every segment, so this is the work
actually done. Every section runs in this one process and syncs with
block_until_ready; compiled programs persist in the compile cache
(ray_tracer/utils/compile_cache.py). Exits nonzero when JAX finds no GPU.

    python bench.py
"""

import json
import os
import sys
import time

import numpy as np

# ---------------------------------------------------------------------------
# Workloads
# ---------------------------------------------------------------------------

def build_workload(use_textures=False):
    import numpy as np
    import ray_tracer as rt
    from ray_tracer.io import load_model

    width, height = 1920, 1080
    params = rt.RenderParams(
        width=width, height=height, bounces=3, rays_per_pixel=1,
        skybox=True, backend="auto",
        chunk_pixels=0,
        # coherent path tracing: unbiased, same per-pixel variance (see
        # materials.scatter); keeps secondary-bounce kernel tiles
        # direction-coherent so cluster culling engages on all bounces.
        # coherent_tile=0: share per kernel ray block (the convergence
        # tradeoff documented in RenderParams doesn't bind a throughput
        # benchmark)
        coherent_scatter=True, coherent_tile=0)

    teapot = "/root/reference/assets/the_utah_teapot.glb"
    b = rt.SceneBuilder()
    if os.path.exists(teapot):
        # use_textures=False is the reference-parity workload: the
        # reference's shader has no texture sampler (textures are dead
        # code, /root/reference/src/core/scene.rs:466) and the headline
        # measures intersection throughput. use_textures=True is the
        # BASELINE extension workload (fused in-kernel UV extraction +
        # quad-gather sampling), reported as its own section.
        load_model(teapot, b, placement="origin", albedo=(0.7, 0.5, 0.3),
                   smoothness=0.3, use_textures=use_textures)
        lo, hi = b.bounds()  # host-side: avoids a device→host pull
        scene = b.build()
        center = (lo + hi) / 2
        extent = float(np.linalg.norm(hi - lo))
        cam = rt.Camera(
            origin=tuple(center + extent * np.array([0.7, 0.4, 0.7])),
            look_at=tuple(center), aspect=params.aspect, focus_dist=1.0)
    else:  # fallback: room scene
        scene, cam = rt.builtin_scene("room", aspect=params.aspect)
    return scene, cam, params


def _timed(fn, trials=3):
    """(first call s, steady runs s): block_until_ready as the sync."""
    import jax
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    first = time.perf_counter() - t0
    runs = []
    for _ in range(trials):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        runs.append(time.perf_counter() - t0)
    return out, first, runs


def _fwd_throughput(scene, basis, params, frames):
    """Timed progressive forward render; returns (rays_per_s, median s,
    first-call s, runs)."""
    from ray_tracer.renderer import render_progressive

    img, compile_s, runs = _timed(
        lambda: render_progressive(scene, basis, params, frames))
    assert np.isfinite(np.asarray(img)).all()
    dt = float(np.median(runs))
    segs = (params.width * params.height * params.rays_per_pixel
            * (params.bounces + 1) * frames)
    return segs / dt, dt, compile_s, runs


# ---------------------------------------------------------------------------
# Sections (worker side). Each takes/updates a shared ctx dict and returns
# a JSON-serializable result dict.
# ---------------------------------------------------------------------------

def _ctx_workload(ctx):
    if "workload" not in ctx:
        from ray_tracer.renderer import camera_basis
        scene, cam, params = build_workload()
        basis = camera_basis(cam.replace(aspect=params.aspect))
        ctx["workload"] = (scene, basis, params)
    return ctx["workload"]


def section_fwd(ctx):
    import jax
    scene, basis, params = _ctx_workload(ctx)
    frames = 32
    rays_per_s, dt, compile_s, runs = _fwd_throughput(scene, basis, params,
                                                      frames)
    spread = (max(runs) - min(runs)) / min(runs) if runs else 0.0
    print(f"# fwd {dt:.3f}s/{frames}f = {rays_per_s/1e6:.1f} M segs/s "
          f"(first call {compile_s:.1f}s, spread {spread*100:.1f}% over "
          f"{len(runs)} runs)", file=sys.stderr)
    return {
        "rays_per_s": round(rays_per_s, 1),
        "runs_s": [round(r, 3) for r in runs],
        "spread": round(spread, 4),
        "seconds": round(dt, 3), "frames": frames,
        "fps": round(frames / dt, 3), "compile_s": round(compile_s, 1),
        "resolution": f"{params.width}x{params.height}",
        "tris": scene.num_tris, "spheres": scene.num_spheres,
        "bounces": params.bounces, "rpp": params.rays_per_pixel,
        "backend": params.backend, "device": str(jax.devices()[0]),
    }


def section_fwd_bwd(ctx):
    """Forward+backward rays/s (BASELINE.md:36): time one gradient step —
    d/d(scene) of the image MSE against a fixed target — on the same
    1080p workload. Differentiates w.r.t. EVERY float scene leaf
    (vertices, normals, materials, textures), i.e. a full
    inverse-rendering step."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import jax.tree_util as jtu
    from ray_tracer.renderer import render_frame, render_pixels
    from ray_tracer.grad.inverse import chunked_mse_value_and_grad

    scene, basis, params = _ctx_workload(ctx)
    target = jax.lax.stop_gradient(
        render_frame(scene, basis, params, jnp.int32(1)))

    # differentiate w.r.t. the float leaves only (texture ids and the like
    # are int32 — jax.grad rejects integer inputs)
    leaves, treedef = jtu.tree_flatten(scene)
    is_f = [hasattr(l, "dtype") and jnp.issubdtype(l.dtype, jnp.floating)
            for l in leaves]
    float_leaves = [l for l, m in zip(leaves, is_f) if m]

    chunks = 1  # whole-frame backward; >1 bounds memory for bigger frames

    def merge(fl):
        it = iter(fl)
        return jtu.tree_unflatten(
            treedef, [next(it) if m else l for l, m in zip(leaves, is_f)])

    @jax.jit
    def grad_step(fl, frame):
        if chunks > 1:
            def rp(fl, ids):
                return render_pixels(merge(fl), basis, params, frame, ids)
            _, g = chunked_mse_value_and_grad(fl, rp, params, target, chunks)
            return g

        def loss_fn(fl):
            img = render_frame(merge(fl), basis, params, frame)
            return jnp.mean((img - target) ** 2)
        return jax.grad(loss_fn)(fl)

    _, compile_s, runs = _timed(lambda: grad_step(float_leaves,
                                                  jnp.int32(0)))
    dt = float(np.median(runs))
    segs = (params.width * params.height * params.rays_per_pixel
            * (params.bounces + 1))
    print(f"# fwd+bwd {dt:.3f}s/step (first call {compile_s:.1f}s) = "
          f"{segs/dt/1e6:.1f} M segs/s", file=sys.stderr)
    return {"rays_per_s": round(segs / dt, 1), "s_per_step": round(dt, 3),
            "compile_s": round(compile_s, 1)}


def section_parity(ctx):
    """On-device correctness evidence: the compiled kernel vs the jnp
    oracle on the card this benchmark runs on — a room frame (spheres +
    tris + dielectric + emissive) and a textured teapot slice. Reports the
    fraction of pixels beyond tolerance; the assert makes a divergence
    fail the run. A >0 but tiny fraction is expected: an ulp-level fma
    difference at a silhouette pixel flips a winner tie or a scatter
    direction and the bounce chain diverges chaotically."""
    import numpy as np
    import jax.numpy as jnp
    import ray_tracer as rt
    from ray_tracer.io import load_model
    from ray_tracer.renderer import camera_basis, render_frame

    out = {}
    scene, cam = rt.builtin_scene("room", aspect=1.0)
    basis = camera_basis(cam)

    def frac_off(a, b, tol=2e-2):
        return float((np.abs(a - b).max(-1) > tol).mean())

    p = rt.RenderParams(width=128, height=128, bounces=3, skybox=True)
    a = np.asarray(render_frame(scene, basis, p.replace(backend="jnp"),
                                jnp.int32(0)))
    b = np.asarray(render_frame(scene, basis, p.replace(backend="pallas"),
                                jnp.int32(0)))
    out["room_128_frac_off"] = frac_off(a, b)

    teapot = "/root/reference/assets/the_utah_teapot.glb"
    if os.path.exists(teapot):
        bld = rt.SceneBuilder()
        load_model(teapot, bld, placement="origin", smoothness=0.3)
        lo, hi = bld.bounds()
        s2 = bld.build()
        center = (lo + hi) / 2
        ext = float(np.linalg.norm(hi - lo))
        cam2 = rt.Camera(origin=tuple(center + ext * np.array([0.7, 0.4, 0.7])),
                         look_at=tuple(center), aspect=1.0, focus_dist=1.0)
        b2 = camera_basis(cam2)
        p2 = rt.RenderParams(width=96, height=96, bounces=1, skybox=True)
        a = np.asarray(render_frame(s2, b2, p2.replace(backend="jnp"),
                                    jnp.int32(0)))
        bb = np.asarray(render_frame(s2, b2, p2.replace(backend="pallas"),
                                     jnp.int32(0)))
        out["teapot_tex_96_frac_off"] = frac_off(a, bb)

        # deterministic primary-ray check (no chaotic bounce chain):
        # compiled winner ids + fused attrs vs the jnp oracle
        from ray_tracer.renderer import _blocked_order
        from ray_tracer import sampling
        from ray_tracer.camera import camera_rays
        from ray_tracer.ops.intersect import (hit_attributes, intersect,
                                              nearest_hit_jnp)
        order, _ = _blocked_order(96, 96)
        pids = jnp.asarray(order)
        st = sampling.seed_state(pids, 0)
        _, o, d = camera_rays(b2, pids % 96, pids // 96, (96, 96), st)
        t_ref, id_ref = nearest_hit_jnp(s2, o, d, 1e-4)
        fused = intersect(s2, o, d, backend="pallas")
        ref = hit_attributes(s2, o, d, id_ref, jnp.isinf(t_ref), 1e-4)
        mism = int(((np.asarray(fused.prim_id) != np.asarray(id_ref))
                    & np.asarray(fused.hit)).sum())
        out["teapot_primary_id_mismatches"] = mism
        same = np.asarray(fused.hit) & (np.asarray(fused.prim_id)
                                        == np.asarray(id_ref))
        out["teapot_primary_attr_max_abs_diff"] = float(max(
            np.abs(np.asarray(fused.albedo)
                   - np.asarray(ref.albedo))[same].max(),
            np.abs(np.asarray(fused.normal)
                   - np.asarray(ref.normal))[same].max()))

    for k, v in out.items():
        if k.endswith("frac_off"):
            assert v < 2e-3, f"kernel/jnp divergence on device: {k}={v}"
    assert out.get("teapot_primary_id_mismatches", 0) <= 2
    assert out.get("teapot_primary_attr_max_abs_diff", 0.0) < 1e-3
    print(f"# parity {out}", file=sys.stderr)
    return out


def section_textured(ctx):
    """Textured-path throughput: same 1080p frame with UV/texture sampling
    live — the BASELINE extension workload the untextured headline
    hides."""
    from ray_tracer.renderer import camera_basis
    scene, cam, params = build_workload(use_textures=True)
    basis = camera_basis(cam.replace(aspect=params.aspect))
    frames = 16
    rays_per_s, dt, compile_s, _ = _fwd_throughput(scene, basis, params,
                                                   frames)
    print(f"# textured fwd {dt:.3f}s/{frames}f = {rays_per_s/1e6:.1f} "
          f"M segs/s (first call {compile_s:.1f}s)", file=sys.stderr)
    return {"rays_per_s": round(rays_per_s, 1), "seconds": round(dt, 3),
            "frames": frames, "compile_s": round(compile_s, 1)}


SECTIONS = [
    ("fwd", section_fwd),
    ("fwd_bwd", section_fwd_bwd),
    ("parity", section_parity),
    ("textured", section_textured),
]


def compose(results, device):
    """The one JSON line: headline forward rays/s plus the other
    sections' numbers, with the device they ran on."""
    fwd = results.get("fwd", {})
    fb = results.get("fwd_bwd", {})
    tex = results.get("textured", {})
    detail = {k: v for k, v in fwd.items() if k != "rays_per_s"}
    if fb:
        detail["fwd_bwd_rays_per_s"] = fb["rays_per_s"]
        detail["fwd_bwd_s_per_step"] = fb["s_per_step"]
        detail["fwd_bwd_compile_s"] = fb["compile_s"]
    if "parity" in results:
        detail["on_device_parity"] = results["parity"]
    if tex:
        detail["textured_rays_per_s"] = tex["rays_per_s"]
        detail["textured_frames"] = tex["frames"]
        detail["textured_compile_s"] = tex["compile_s"]
    return {
        "metric": "rays/s fwd 1080p",
        "value": fwd.get("rays_per_s", 0.0),
        "unit": "ray segments/s",
        "device": device,
        "detail": detail,
    }


def main():
    import jax
    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"bench.py: JAX found no GPU (platform "
              f"{devices[0].platform!r}); refusing to measure",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from ray_tracer.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    ctx = {}
    results = {name: fn(ctx) for name, fn in SECTIONS}
    device = {"platform": devices[0].platform,
              "kind": devices[0].device_kind, "count": len(devices)}
    print(json.dumps(compose(results, device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
