"""Command-line interface: render / benchmark / info.

The reference binary takes no arguments (src/main.rs:3-6) and exposes its
knobs through an imgui overlay (src/core/context.rs:230-258); headless
first, the same knob set becomes flags. Scenes are the reference's four
built-ins by name or id (src/core/context.rs:261-279) or a model file loaded
into a studio scene.

    python -m ray_tracer render --scene metal --frames 64 -o out.png
    python -m ray_tracer render --model /path/teapot.glb -o teapot.png
    python -m ray_tracer benchmark --scene room --width 800 --height 800
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
import time

import numpy as np

from . import Camera, RenderParams, Renderer, SceneBuilder, builtin_scene
from .io import load_model, write_npy, write_png


def _positive_int(s):
    v = int(s)
    if v < 1:
        raise argparse.ArgumentTypeError("must be >= 1")
    return v


def _add_common(p):
    p.add_argument("--scene", default="balls",
                   help="builtin scene name or id (balls|random_balls|room|metal|0-3)")
    p.add_argument("--model", default=None, action="append",
                   help="OBJ/glTF/GLB file rendered in a studio scene "
                        "instead; repeat to compose several models "
                        "(placed side by side, the reference loader's "
                        "multi-model convention — resource.rs:78-84)")
    p.add_argument("--width", type=int, default=800)
    p.add_argument("--height", type=int, default=800)
    p.add_argument("--bounces", type=int, default=3)
    p.add_argument("--rays-per-pixel", type=int, default=1)
    p.add_argument("--skybox", action="store_true")
    p.add_argument("--no-accumulate", action="store_true")
    p.add_argument("--backend", default="auto", choices=["auto", "jnp", "pallas"])
    p.add_argument("--nee", action="store_true",
                   help="next-event estimation (explicit light sampling)")
    p.add_argument("--no-mis", action="store_true",
                   help="disable balance-heuristic MIS for the NEE<->BSDF "
                        "estimator pair (falls back to pure emission "
                        "suppression; variance cliff on near-mirror "
                        "surfaces)")
    p.add_argument("--cosine-sampling", action="store_true",
                   help="cosine-weighted Lambertian sampling (extension)")
    p.add_argument("--compaction", action="store_true",
                   help="wavefront ray sorting between bounces")
    p.add_argument("--coherent", action="store_true",
                   help="coherent path tracing: one shared diffuse-lobe "
                        "draw per 128-ray tile per bounce (unbiased, same "
                        "per-pixel variance; keeps the kernel's culling "
                        "working after the first bounce)")
    p.add_argument("--qmc", action="store_true",
                   help="low-discrepancy (R2) anti-aliasing jitter — "
                        "faster edge/detail convergence over frames")
    p.add_argument("--clamp", type=float, default=0.0,
                   help="clamp per-sample radiance (firefly suppression; "
                        "0 = off)")
    p.add_argument("--rr", type=int, default=0, metavar="N",
                   help="Russian roulette from bounce N (unbiased "
                        "early path termination; 0 = off)")
    p.add_argument("--chunk-pixels", type=int, default=0)
    p.add_argument("--seed", type=int, default=0, help="random_balls scene seed")
    p.add_argument("--aperture", type=float, default=None,
                   help="thin-lens aperture (depth of field; the imgui "
                        "knob at src/core/context.rs:255)")
    p.add_argument("--focus-dist", type=float, default=None,
                   help="focal-plane distance (context.rs:254)")


def _build(args):
    params = RenderParams(
        width=args.width, height=args.height, bounces=args.bounces,
        rays_per_pixel=args.rays_per_pixel, skybox=args.skybox,
        accumulate=not args.no_accumulate, backend=args.backend,
        chunk_pixels=args.chunk_pixels, nee=args.nee,
        mis=not args.no_mis,
        cosine_sampling=args.cosine_sampling, compaction=args.compaction,
        coherent_scatter=args.coherent, clamp=args.clamp, qmc=args.qmc,
        rr_start=args.rr)
    if args.model:
        import numpy as _np
        b = SceneBuilder()
        # one model centers at the origin; several compose side by side
        # (the reference loader's x = 3·index placement, resource.rs:78-84)
        placement = "origin" if len(args.model) == 1 else "reference"
        for path in args.model:
            load_model(path, b, placement=placement)
        lo, hi = b.bounds()  # host-side: avoids a device→host pull
        scene = b.build()
        center, extent = (lo + hi) / 2, float(_np.linalg.norm(hi - lo))
        cam = Camera(origin=tuple(center + extent * _np.array([0.8, 0.5, 0.8])),
                     look_at=tuple(center), aspect=params.aspect,
                     focus_dist=1.0)
    else:
        name = int(args.scene) if args.scene.isdigit() else args.scene
        kw = {"seed": args.seed} if name in ("random_balls", 1) else {}
        try:
            scene, cam = builtin_scene(name, aspect=params.aspect, **kw)
        except KeyError:
            raise ValueError(
                f"unknown scene {args.scene!r} (choose "
                "balls|random_balls|room|metal or id 0-3)") from None
    if args.aperture is not None:
        cam = cam.replace(aperture=args.aperture)
    if args.focus_dist is not None:
        cam = cam.replace(focus_dist=args.focus_dist)
    return scene, cam, params


def cmd_render(args):
    import numpy as np

    from .utils.metrics import StageTimer

    st = StageTimer()
    if getattr(args, "aov", None):
        from .renderer import camera_basis, render_aov
        scene, cam, params = _build(args)
        img = np.asarray(render_aov(scene, camera_basis(cam), params,
                                    args.aov))
        if args.output.endswith(".npy"):
            write_npy(args.output, img)
        else:
            # viewable normalization: depth by its max; normals remapped
            if args.aov == "depth":
                img = img / max(float(img.max()), 1e-12)
            elif args.aov == "normal":
                img = img * 0.5 + 0.5
            from .io.image import write_png_rgb8
            rgb = np.broadcast_to(img, img.shape[:2] + (3,))[::-1]
            write_png_rgb8(args.output,
                           (np.clip(rgb, 0.0, 1.0) * 255 + 0.5)
                           .astype(np.uint8))
        print(f"wrote {args.aov} AOV to {args.output}")
        return
    with st.stage("build"):
        scene, cam, params = _build(args)
        if args.resume:
            from .utils.checkpoint import load_renderer
            r = load_renderer(args.resume, scene)
        else:
            r = Renderer(scene, cam, params)
    t0 = time.time()
    with st.stage("render"):
        if getattr(args, "adaptive", None) and r.frames == -1 \
                and params.accumulate:
            from .renderer import camera_basis, render_adaptive
            basis = camera_basis(r.camera)
            img, used = render_adaptive(scene, basis, params, args.frames,
                                        target_rel_std=args.adaptive)
            r._image = img
            r.frames = used - 1
            print(f"adaptive: converged after {used}/{args.frames} frames",
                  file=sys.stderr)
        elif args.frames > 1 and r.frames == -1 and params.accumulate:
            # batch path: all frames accumulate on-device in one dispatch
            # (per-dispatch latency dominates interactive stepping)
            from .renderer import camera_basis, render_progressive
            basis = camera_basis(r.camera)
            img = render_progressive(scene, basis, params, args.frames)
            r._image = img
            r.frames = args.frames - 1
        else:
            for i in range(args.frames):
                img = r.step()
        if getattr(args, "denoise", 0):
            from .denoise import denoise_render
            from .renderer import camera_basis as _cb
            img = denoise_render(scene, _cb(r.camera), params, img,
                                 iterations=args.denoise)
        img = np.asarray(img)  # sync: the render ends in this pull
    dt = time.time() - t0
    if args.checkpoint:
        from .utils.checkpoint import save_renderer
        with st.stage("checkpoint"):
            save_renderer(args.checkpoint, r)
        print(f"checkpoint -> {args.checkpoint}", file=sys.stderr)
    n_frames = r.frames + 1 if params.accumulate else args.frames
    print(f"rendered {n_frames} frame(s) at {params.width}x{params.height} "
          f"in {dt:.2f}s ({n_frames / dt:.2f} fps)", file=sys.stderr)
    with st.stage("io"):
        if args.output.endswith(".npy"):
            write_npy(args.output, img)
        else:
            write_png(args.output, img)
    st.log()
    print(f"wrote {args.output}", file=sys.stderr)


def cmd_benchmark(args):
    import numpy as np

    from .renderer import camera_basis, render_progressive

    scene, cam, params = _build(args)
    basis = camera_basis(cam.replace(aspect=params.aspect))
    render_progressive(scene, basis, params, args.frames).block_until_ready()
    runs = []
    for _ in range(3):
        t0 = time.perf_counter()
        render_progressive(scene, basis, params,
                           args.frames).block_until_ready()
        runs.append(time.perf_counter() - t0)
    dt = float(np.median(runs))
    segments = (params.width * params.height * params.rays_per_pixel
                * (params.bounces + 1) * args.frames)
    print(json.dumps({
        "metric": "rays/s", "value": segments / dt, "unit": "ray segments/s",
        "frames": args.frames, "seconds": dt, "fps": args.frames / dt,
        "resolution": f"{params.width}x{params.height}",
        "spheres": scene.num_spheres, "tris": scene.num_tris,
    }))


def cmd_view(args):
    scene, cam, params = _build(args)
    from .viewer import view
    sid = None if args.model else args.scene
    view(scene, cam, params, scene_id=sid, max_frames=args.max_frames)


def cmd_invert(args):
    """Inverse rendering demo (BASELINE config 5 scaled to the built-ins):
    perturb the scene's sphere albedos, then recover them from a rendered
    target by gradient descent with the differentiable renderer."""
    import jax.numpy as jnp
    import numpy as np
    import optax

    from . import camera_basis
    from .grad import make_train_step
    from .renderer import render_frame

    scene, cam, params = _build(args)
    basis = camera_basis(cam.replace(aspect=params.aspect))
    target = render_frame(scene, basis, params, jnp.int32(0))

    rng = np.random.default_rng(0)
    # dielectric albedo is forced white in shading (wgsl:241) — it cannot
    # affect the image, so it is excluded from recovery
    valid = ((np.asarray(scene.sphere_valid) > 0.5)
             & (np.asarray(scene.sphere_smoothness) >= 0.0))
    wrong_np = np.asarray(scene.sphere_albedo).copy()
    wrong_np[valid] = np.clip(
        wrong_np[valid] + rng.normal(0, 0.25, (valid.sum(), 3)), 0.05, 0.95)
    import dataclasses
    start = dataclasses.replace(scene,
                                sphere_albedo=jnp.asarray(wrong_np, jnp.float32))

    init_fn, step_fn = make_train_step(params, optax.adam(args.lr),
                                       edge_samples=args.edge_samples)
    trainable, opt_state = init_fn(start, fields=("sphere_albedo",))
    t0 = time.time()
    for i in range(args.steps):
        trainable, opt_state, loss = step_fn(
            trainable, opt_state, start, basis, target, jnp.int32(0))
        if i % max(1, args.steps // 10) == 0:
            print(f"step {i:4d}  loss {float(loss):.6f}", file=sys.stderr)
    err = float(np.abs(np.asarray(trainable["sphere_albedo"])[valid]
                       - np.asarray(scene.sphere_albedo)[valid]).max())
    print(json.dumps({
        "steps": args.steps, "seconds": round(time.time() - t0, 2),
        "final_loss": float(loss), "max_albedo_error": err,
        "recovered": err < 0.1,
    }))


def cmd_info(args):
    import jax
    print(json.dumps({
        "jax": jax.__version__,
        "devices": [str(d) for d in jax.devices()],
        "device_kind": jax.devices()[0].device_kind,
        "default_backend": jax.default_backend(),
    }, indent=2))


def main(argv=None):
    from .utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    ap = argparse.ArgumentParser(prog="ray_tracer")
    ap.add_argument("-v", "--verbose", action="store_true",
                    help="INFO logging: loader warnings, per-stage timings")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("render", help="render a scene to PNG/NPY")
    _add_common(p)
    p.add_argument("--frames", type=_positive_int, default=1,
                   help="progressive frames to accumulate (>= 1)")
    p.add_argument("-o", "--output", default="out.png")
    p.add_argument("--checkpoint", default=None,
                   help="save accumulation state to this .npz when done")
    p.add_argument("--resume", default=None,
                   help="resume accumulation from a checkpoint .npz")
    p.add_argument("--adaptive", type=float, default=None, metavar="REL",
                   help="adaptive sampling: stop when 99%% of pixels reach "
                        "this relative standard error of the mean "
                        "(--frames becomes the cap); e.g. 0.02")
    p.add_argument("--aov", default=None,
                   choices=["depth", "normal", "albedo", "hit"],
                   help="render a primary-ray AOV channel instead of the "
                        "beauty pass (.npy = raw values; .png = normalized "
                        "for viewing)")
    p.add_argument("--denoise", type=int, default=0, metavar="N",
                   help="apply N edge-avoiding a-trous filter iterations "
                        "guided by the normal/depth AOVs (0 = off)")
    p.set_defaults(fn=cmd_render)

    p = sub.add_parser("view", help="interactive progressive viewer (GUI)")
    _add_common(p)
    p.add_argument("--max-frames", type=int, default=None)
    p.set_defaults(fn=cmd_view)

    p = sub.add_parser("invert", help="inverse-rendering demo: recover sphere"
                       " albedos of a built-in scene from a target render")
    _add_common(p)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--lr", type=float, default=5e-2)
    p.add_argument("--edge-samples", type=int, default=0,
                   help="edge-sampled visibility (silhouette) gradients per "
                        "family per step (0 = interior gradients only); "
                        "supports thin-lens cameras (aperture > 0)")
    p.set_defaults(fn=cmd_invert)

    p = sub.add_parser("benchmark", help="measure rays/s")
    _add_common(p)
    p.add_argument("--frames", type=_positive_int, default=8)
    p.set_defaults(fn=cmd_benchmark)

    p = sub.add_parser("info", help="print device info")
    p.set_defaults(fn=cmd_info)

    args = ap.parse_args(argv)
    if args.verbose:
        logging.basicConfig(
            level=logging.INFO,
            format="%(levelname)s %(name)s: %(message)s")
        logging.getLogger("jax").setLevel(logging.WARNING)
    try:
        args.fn(args)
    except (ValueError, FileNotFoundError, KeyError) as exc:
        # user-input errors (bad scene name, missing model file, invalid
        # RenderParams) get a concise message, not a traceback; real bugs
        # and device errors still propagate loudly. -v for the traceback.
        if args.verbose:
            raise
        print(f"error: {exc}", file=sys.stderr)
        raise SystemExit(2)


if __name__ == "__main__":
    main()
