"""Render configuration.

Analog of the reference's ``Params`` uniform + imgui knob set
(reference: src/core/context.rs:13-21 and the widget tree at
src/core/context.rs:230-258). All knobs are static Python values so that a
jitted render step specializes on them (XLA requires static shapes/loop
bounds); changing a knob triggers a (cached) recompile, which replaces the
reference's "upload new uniform" path.

Defaults mirror src/core/context.rs:86-94: bounces=3, rays_per_pixel=1,
skybox off, accumulate on, 800x800 window (src/lib.rs:17).
"""

from __future__ import annotations

import dataclasses

from ..ops.backend import BACKENDS


@dataclasses.dataclass(frozen=True)
class RenderParams:
    """Static render parameters. Hashable → usable as a jit static arg."""

    width: int = 800
    height: int = 800
    # Number of bounce iterations is ``bounces + 1`` ray segments, matching the
    # reference's inclusive loop `for i = 0; i <= number_of_bounces`
    # (shaders/ray_tracer.wgsl:233). We keep the reference's visual behavior.
    bounces: int = 3
    # Samples per pixel per frame. The reference's inclusive sample loop runs
    # rays_per_pixel+1 samples but divides by rays_per_pixel
    # (shaders/ray_tracer.wgsl:312,326). We implement the *intent*: exactly
    # `rays_per_pixel` samples averaged by `rays_per_pixel`. Deviation D1 in
    # docs/DEVIATIONS.md.
    rays_per_pixel: int = 1
    # Procedural sky light on miss (shaders/ray_tracer.wgsl:274-279; the WGSL
    # reads this as `params.toggle`).
    skybox: bool = False
    # Progressive accumulation (host-side frame counter semantics,
    # src/core/context.rs:180-184).
    accumulate: bool = True
    # Self-intersection epsilon. The reference has none (relies on f32 noise,
    # shaders/ray_tracer.wgsl:113 `dst >= 0.0`); we use the RTiOW-style t_min.
    # Deviation D2.
    t_min: float = 1e-4
    # Intersection backend (ops/backend.py): "auto" (the Pallas kernel on
    # a GPU, the jnp oracle elsewhere), "jnp", "pallas".
    backend: str = "auto"
    # Run the Pallas kernel in the Pallas interpreter. Off a GPU the
    # "pallas" backend needs this (tests, CPU dry runs); nobody renders
    # with it.
    interpret: bool = False
    # Render the frame in chunks of this many pixels (0 = whole frame at
    # once). Bounds the (rays × primitives) working set: the jnp backend
    # materializes O(chunk × primitives) in device memory; the kernel
    # backend streams the scene and can take the whole frame.
    chunk_pixels: int = 0
    # Wavefront compaction: reorder rays between bounces so the kernel's
    # 128-ray blocks stay coherent (cluster culling engages on secondary
    # bounces) and dead rays collapse into whole blocks that are skipped.
    # Ignored by the jnp backend. Modes:
    #   False     — no reordering; tiles keep pixel-block order.
    #   "octant"  — O(R) stable counting sort by (alive, direction
    #               octant): directions per tile confined to a 90° cone,
    #               origins still pixel-block coherent. Cheap (cumsum +
    #               scatter, no argsort).
    #   "morton" / True — full argsort by (alive, origin Morton cell,
    #               octant). Tightest blocks, at the price of a 2M-key
    #               argsort per bounce at 1080p.
    compaction: object = False
    # Next-event estimation: explicitly sample emissive primitives with a
    # shadow ray at each diffuse/glossy hit (lights.py). Extension beyond
    # the reference (BASELINE config 4); costs one extra intersection per
    # bounce. UNBIASED at every smoothness s < 1 (same converged image as
    # BSDF-only): the direct term weights by the exact solid-angle pdf of
    # the reference's glossy lerp lobe (lights.glossy_mix_pdf; pinned by
    # tests/test_nee.py converged A/Bs). nee_smoothness_cutoff is a pure
    # VARIANCE knob: lanes with s >= cutoff keep BSDF-only sampling —
    # area-sampling a near-mirror lobe is exact but noisy, so lowering the
    # cutoff (e.g. 0.9) trades NEE's variance reduction on near-specular
    # surfaces for none of NEE's cost there. s = 1 (perfect mirror, a
    # delta lobe NEE cannot sample) is always excluded.
    nee: bool = False
    nee_smoothness_cutoff: float = 1.0
    # Multiple importance sampling for the NEE <-> BSDF estimator pair
    # (balance heuristic; only meaningful with nee=True). Instead of NEE
    # lanes fully suppressing the next segment's BSDF-found emission (a
    # hard either/or that leaves area-sampled NEE alone on near-mirror
    # lobes — a variance cliff at nee_smoothness_cutoff), BOTH strategies
    # contribute, each weighted by p_own/(p_nee + p_bsdf) at its sample:
    # the light-sample pdf is the area->solid-angle measure sample_lights
    # already computes, the BSDF pdf is the closed-form lerp-lobe density
    # (lights.glossy_mix_pdf). Weights sum to 1 for every direction both
    # strategies can reach, so the converged image is unchanged
    # (test-pinned); variance becomes monotone in smoothness with no
    # cliff. mis=False restores the pure-suppression estimator.
    mis: bool = True
    # Low-discrepancy anti-aliasing (extension): the per-frame AA jitter
    # walks the R2 sequence (exact 0.32 fixed-point arithmetic) with a
    # per-pixel Cranley–Patterson rotation instead of fresh PCG draws —
    # pixel error from edge/texture detail converges ~O(1/N) instead of
    # O(1/sqrt(N)) over accumulated frames (test-pinned). Lens and BSDF
    # sampling keep the reference's PCG streams. Off by default: qmc=False
    # is bit-identical to the reference sampler.
    qmc: bool = False
    # Russian roulette path termination (extension; standard production
    # knob): from ray segment index >= rr_start, each path survives with
    # probability p = clip(max-channel throughput, 0.05, 1) and survivors
    # divide their throughput by p — unbiased (converged image unchanged,
    # test-pinned), dim deep paths die early, and whole dead 128-ray
    # blocks cost the kernel almost nothing. 0 = off (the reference
    # transport, bitwise — no RNG draw happens, so streams are untouched).
    rr_start: int = 0
    # Rematerialize the bounce-scan body in the backward pass
    # (jax.checkpoint): saves only the per-bounce carry instead of every
    # intermediate (winner rows, shading temporaries — hundreds of MB at
    # 1080p), recomputing the forward bounce during the backward sweep.
    # Whether trading residual memory traffic for a second kernel pass
    # wins is a measurement on the card; gradients are
    # equal up to fp reassociation under jax.checkpoint (~3e-5 relative,
    # test-pinned at rtol 1e-3 — XLA fuses the recomputed forward
    # differently in the cotangent program).
    remat: bool = False
    # Firefly suppression: clamp each traced sample's radiance to this
    # value before accumulation (0 = off, the reference behavior). A
    # standard production knob — biased (energy loss on rare bright
    # paths) but kills the high-variance outlier pixels that dominate
    # visual noise at low sample counts.
    clamp: float = 0.0
    # Coherent path tracing: all 128 rays of a kernel block share one
    # unit-sphere draw for the diffuse lobe each bounce (per-lane
    # hemisphere flip / normal offset keeps every ray's direction
    # marginally exact — unbiased, same per-pixel variance; single-frame
    # noise becomes tile-blocky and averages out under accumulation).
    # Secondary-bounce blocks then carry a coherent direction cone, so the
    # kernel's cluster culling keeps working after the first bounce. See
    # materials.scatter.
    coherent_scatter: bool = False
    # Width of the shared-draw tile when coherent_scatter is on. 0 =
    # match the kernel's ray block (ops/pallas_intersect.RB). Wider tiles
    # make single-frame blockiness span more pixels, and ENCLOSED scenes
    # visually converge noticeably slower (room@128 frames still streaky
    # at a 512 tile vs clean at 128).
    coherent_tile: int = 128
    # Cosine-weighted hemisphere sampling (true Lambertian BRDF) instead of
    # the reference's uniform-hemisphere scatter (wgsl:211-214). Changes
    # the converged look (documented extension; default = reference).
    cosine_sampling: bool = False

    def __post_init__(self):
        if self.width <= 0 or self.height <= 0:
            raise ValueError("width/height must be positive")
        if self.bounces < 0:
            raise ValueError("bounces must be >= 0")
        if self.rays_per_pixel < 1:
            raise ValueError("rays_per_pixel must be >= 1")
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}")
        if self.compaction not in (False, True, "octant", "morton"):
            raise ValueError(f"unknown compaction {self.compaction!r}")
        if self.coherent_tile < 0:
            raise ValueError("coherent_tile must be >= 0 (0 = kernel tile)")
        if self.clamp < 0:
            raise ValueError("clamp must be >= 0 (0 = off)")

    @property
    def aspect(self) -> float:
        return self.width / self.height

    def replace(self, **kw) -> "RenderParams":
        return dataclasses.replace(self, **kw)
