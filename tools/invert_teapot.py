"""Inverse rendering demo — BASELINE config 5.

Recovers a rigid vertex offset AND the albedo of the Utah teapot
(15,704 triangles) from target renders: albedo by autodiff through the
differentiable winner recompute (hit-overlap-masked cotangent), the
3-DoF offset by central finite differences of the common-random-numbers
loss (which, unlike the interior autodiff gradient, sees visibility — the
in-step comments record the observed failure modes that forced each
choice).

Usage: python tools/invert_teapot.py [steps] [size] [outfile]
Prints one JSON line with the recovery errors and writes it to ``outfile``
(default artifacts/invert_teapot.json).
"""

import json
import os
import sys
import time

import numpy as np
import jax
import jax.numpy as jnp
import optax

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import ray_tracer as rt
from ray_tracer.io import load_model
from ray_tracer.renderer import render_aov, render_frame

def _cli_args():
    # parsed lazily: this module is also imported by tests (run_recovery),
    # where sys.argv belongs to pytest
    steps = int(sys.argv[1]) if len(sys.argv) > 1 else 200
    size = int(sys.argv[2]) if len(sys.argv) > 2 else 192
    out = sys.argv[3] if len(sys.argv) > 3 else "artifacts/invert_teapot.json"
    return steps, size, out

TRUE_ALBEDO = np.array([0.7, 0.45, 0.25], np.float32)
TRUE_OFFSET = np.zeros(3, np.float32)
START_ALBEDO = np.array(
    [float(x) for x in os.environ.get("RTT_INVERT_START_ALB",
                                      "0.35,0.6,0.55").split(",")],
    np.float32)  # env knob: debugging the coupled dynamics
START_DIR = np.array(
    [float(x) for x in os.environ.get("RTT_INVERT_START_DIR",
                                      "1.0,-0.6,0.4").split(",")],
    np.float32)  # env knob: multi-seed robustness runs (VERDICT r3 #9)


def run_recovery(scene, ext, params, steps, start_offset, start_albedo,
                 basis, log=True):
    """The north-star recovery loop, scene-agnostic (tests run it on a
    CPU-scale scene so the config can't silently rot — VERDICT r3 #9).

    ``scene`` is the TRUE scene (true albedo baked in, textures stripped);
    recovers a rigid vertex offset (central finite differences of the
    common-random-numbers loss) and a uniform albedo (autodiff with the
    hit-overlap-masked cotangent) with the phased two-timescale schedule.
    Returns (offset np.ndarray, albedo np.ndarray, losses list).
    """
    return _run_recovery_impl(scene, ext, params, steps, start_offset,
                              start_albedo, basis, log)


def main():
    STEPS, SIZE, OUTFILE = _cli_args()
    b = rt.SceneBuilder()
    load_model("/root/reference/assets/the_utah_teapot.glb", b,
               placement="origin", albedo=tuple(TRUE_ALBEDO), smoothness=0.0)
    lo, hi = b.bounds()
    scene = b.build()
    # The GLB's second mesh carries a texture: the loader gives it base
    # albedo [1,1,1] + tri_tex=0, so the as-loaded teapot is PART-TEXTURED
    # and a uniform recovered albedo can only reach the two-mesh mixture
    # (measured r3: every run converged to the same bright [0.83,0.71,0.62]
    # "attractor" — that WAS the representable optimum, not an optimizer
    # failure). The recovery model is a uniform albedo, so the true scene
    # must be representable by it: strip textures and broadcast.
    import dataclasses as _dc
    scene = _dc.replace(
        scene,
        tri_tex=jnp.full_like(scene.tri_tex, -1),
        tri_albedo=(jnp.broadcast_to(jnp.asarray(TRUE_ALBEDO),
                                     scene.tri_albedo.shape)
                    * scene.tri_valid[:, None]))
    center, ext = (lo + hi) / 2, float(np.linalg.norm(hi - lo))
    cam = rt.Camera(origin=tuple(center + ext * np.array([0.7, 0.4, 0.7])),
                    look_at=tuple(center), aspect=1.0, focus_dist=1.0)
    basis = rt.camera_basis(cam)
    # rpp=2: with a rigid translation the interior radiance changes only
    # through WHICH surface point each pixel sees, so the offset signal is
    # weak relative to 1-rpp Monte-Carlo noise — measured r3: 80 steps at
    # 128^2/rpp1 stall at off_err ~0.06-0.07 and 240 steps at 64^2/rpp1
    # DIVERGE (0.148 -> 0.19). Averaging 2 rays/pixel + 192^2 (plus the
    # noise-free finite-difference offset estimator below) lifts the
    # gradient SNR enough to converge.
    params = rt.RenderParams(width=SIZE, height=SIZE, bounces=1, skybox=True,
                             rays_per_pixel=2)

    start_offset = jnp.asarray(0.12 * ext * START_DIR, jnp.float32)

    t0 = time.time()
    offset, albedo, _ = run_recovery(scene, ext, params, STEPS,
                                     start_offset, START_ALBEDO, basis)

    import jax as _jax
    off_err = float(np.linalg.norm(np.asarray(offset) - TRUE_OFFSET)) / ext
    alb_err = float(np.abs(np.asarray(albedo) - TRUE_ALBEDO).max())
    result = {
        "steps": STEPS, "resolution": SIZE,
        "seconds": round(time.time() - t0, 1),
        "tris": 15704,
        "device": str(_jax.devices()[0]),
        "start_offset_rel": 0.12 * float(np.linalg.norm(START_DIR)),
        "start_dir": [float(x) for x in START_DIR],
        "start_albedo": [float(x) for x in START_ALBEDO],
        "offset_error_rel_extent": round(off_err, 4),
        "albedo_error": round(alb_err, 4),
        "recovered": off_err < 0.02 and alb_err < 0.05,
    }
    line = json.dumps(result)
    print(line)
    if OUTFILE:
        os.makedirs(os.path.dirname(OUTFILE) or ".", exist_ok=True)
        with open(OUTFILE, "w") as f:
            f.write(line + "\n")


def _run_recovery_impl(scene, ext, params, STEPS, start_offset,
                       start_albedo, basis, log):
    base = dict(v0=scene.tri_v0, v1=scene.tri_v1, v2=scene.tri_v2)
    valid = scene.tri_valid[:, None]

    def apply(scene0, offset, albedo):
        import dataclasses
        alb = jnp.broadcast_to(albedo, scene0.tri_albedo.shape)
        return dataclasses.replace(
            scene0,
            tri_v0=base["v0"] + offset * valid,
            tri_v1=base["v1"] + offset * valid,
            tri_v2=base["v2"] + offset * valid,
            tri_albedo=alb * valid)

    # target-side coverage mask, constant across the run (true scene)
    hit_target = jax.block_until_ready(
        jax.jit(lambda: render_aov(scene, basis, params, "hit"))())

    @jax.jit
    def step(opt_state, offset, albedo, frame, fd_h):
        # Common random numbers: the target is re-rendered with the SAME
        # frame index (= same per-pixel RNG streams) as the optimization
        # render. With independent noise, MSE against a fixed target
        # rewards LOW-VARIANCE images — gradient descent happily pushes
        # the object out of frame to flatten the Monte-Carlo noise
        # (observed). With CRN the noise cancels at the optimum and the
        # loss has an exact zero at the true parameters.
        target = jax.lax.stop_gradient(
            render_frame(scene, basis, params, frame))

        def render_only(offset, albedo):
            s = apply(scene, offset, albedo)
            return render_frame(s, basis, params, frame)

        # ONE forward, TWO cotangent pulls on the same linearization:
        # - offset descends the plain MSE (it NEEDS the edge residuals —
        #   they carry the silhouette signal);
        # - albedo descends the MSE restricted to pixels where BOTH the
        #   current render and the target see geometry (primary-ray hit
        #   AOV overlap, stop-gradiented). While the offset is off by even
        #   1-2 px, silhouette pixels compare teapot against sky and their
        #   huge residuals BIAS the albedo toward the sky mixture
        #   (observed: offset converged to 0.008·extent while
        #   albedo stalled at error 0.38, sky-bright; a 90%-residual trim
        #   was worse — the teapot covers <10% of the frame, so the trim
        #   dropped the teapot itself and albedo chased the sky to 1.0).
        img, vjp_fn = jax.vjp(render_only, offset, albedo)
        res = img - target
        loss = jnp.mean(res ** 2)
        hit_r = render_aov(apply(scene, jax.lax.stop_gradient(offset),
                                 jax.lax.stop_gradient(albedo)),
                           basis, params, "hit")
        w = hit_r * hit_target
        _, g_alb = vjp_fn(2.0 * res * w / (3.0 * jnp.maximum(jnp.sum(w),
                                                             1.0)))

        # Offset gradient: central finite differences of the CRN loss.
        # The interior (autodiff) gradient is blind to visibility — the
        # hit/miss winner is detached — and near the optimum it is
        # ADVERSARIAL (the silhouette-band residuals shrink fastest by
        # shrinking overlap: observed, interior-only descent walks
        # 0.148 -> 0.24 AWAY from truth at true albedo). The edge-sampled
        # boundary estimator (grad/edges.py) is unbiased but at this
        # workload variance-dominated (8192 samples over ~23k candidate
        # silhouette edges measured wrong-signed at the start point and
        # 10-50x overscaled near truth). Under common random numbers the
        # LOSS itself is deterministic and captures visibility exactly, so
        # for a 3-DoF rigid offset central differences (6 extra renders)
        # are both unbiased at h->0 and noise-free — the right estimator.
        # ``fd_h`` anneals coarse->fine (world units; ~1 unit/pixel here).
        def loss_at(off):
            return jnp.mean((render_only(off, albedo) - target) ** 2)

        eye = jnp.eye(3, dtype=jnp.float32)
        g_off = jnp.stack([
            (loss_at(offset + fd_h * eye[i]) - loss_at(offset - fd_h * eye[i]))
            / (2.0 * fd_h) for i in range(3)])

        updates, opt_state = opt.update({"o": g_off, "a": g_alb}, opt_state)
        return opt_state, updates["o"], updates["a"], loss

    # Adam's per-coordinate normalization makes lr ≈ step size: the offset
    # lives in world units (teapot extent ~198) and the albedo in [0, 1],
    # so each gets its own scale via multi_transform. The lr MUST decay:
    # with common random numbers the optimum is an exact fixed point, but
    # Adam's g/sqrt(v) ratio stays O(1) as gradients shrink, so constant
    # lr random-walks at step-size amplitude forever (measured: converged
    # by ~step 120, then wandered off).
    # clip_by_global_norm tames occasional outlier steps (e.g. a coarse
    # fd_h probe straddling a silhouette makes the FD offset gradient
    # jump); with the finite-difference offset estimator it is mostly a
    # safety rail rather than a necessity.
    #
    # Two-timescale coupling (three observed failure modes):
    # (1) joint descent with a whole-run albedo cosine — offset converges
    #     by ~step 120 but the albedo lr has decayed while it was chasing
    #     the misalignment mixture: frozen at error 0.38;
    # (2) joint descent with the albedo live from step 0 — the albedo
    #     overshoots early (misaligned teapot-on-teapot pixels demand
    #     brightness compensation), and the too-bright teapot then PUSHES
    #     THE OFFSET AWAY (less overlap = less mismatch): offset 0.05 at
    #     step 6, back up to 0.15 by step 54;
    # (3) the fix: PHASE the parameters. Offset descends alone for the
    #     first 35% (it reaches ~0.01 unaided — measured), then the
    #     albedo unfreezes with the hit-overlap-masked gradient and
    #     converges against the aligned geometry, then both decay.
    a_phase = int(0.35 * STEPS)
    opt = optax.multi_transform(
        {"o": optax.chain(
            optax.clip_by_global_norm(10.0),
            optax.adam(optax.cosine_decay_schedule(0.015 * ext, STEPS,
                                                   alpha=0.005))),
         "a": optax.chain(
            optax.clip_by_global_norm(10.0),
            optax.adam(optax.join_schedules(
                [optax.constant_schedule(0.0),
                 optax.constant_schedule(0.03),
                 optax.cosine_decay_schedule(0.03, STEPS - int(0.8 * STEPS),
                                             alpha=0.01)],
                [a_phase, int(0.8 * STEPS)])))},
        {"o": "o", "a": "a"})
    offset = start_offset
    albedo = jnp.asarray(start_albedo)
    opt_state = opt.init({"o": offset, "a": albedo})

    losses = []
    for i in range(STEPS):
        # FD step anneals coarse->fine: 1.5% of scene extent (~3 world
        # units on the teapot — a few pixels, wide capture basin) down a
        # decade (sub-pixel refinement). Extent-relative so the loop is
        # scene-agnostic (identical to the tuned teapot constant there).
        h = 0.015 * ext * (0.1 ** (i / max(1, STEPS - 1)))

        opt_state, do, da, loss = jax.device_get(step(
            opt_state, offset, albedo, jnp.int32(i), jnp.float32(h)))
        offset = offset + do
        albedo = np.clip(albedo + da, 0.0, 1.0)  # physical range projection
        losses.append(float(loss))
        if log and i % max(1, STEPS // 10) == 0:
            print(f"step {i:4d} loss {float(loss):.6f} "
                  f"off_err {float(np.linalg.norm(offset))/ext:.4f} "
                  f"alb {np.asarray(albedo).round(3)}", file=sys.stderr)
    return np.asarray(offset), np.asarray(albedo), losses


if __name__ == "__main__":
    main()
