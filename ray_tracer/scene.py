"""Scene representation: padded structure-of-arrays pytree + builders.

A re-design of the reference scene layer (src/core/scene.rs). The
reference stores AoS GPU structs (Sphere/Vertex/Mesh with explicit padding,
src/core/scene.rs:11-92) and indexes triangles indirectly through
``indices[first + 3i + k]`` then ``vertices[offset + index]`` with a per-mesh
translation applied at intersection time (shaders/ray_tracer.wgsl:159-181).

Here the scene is a flat SoA pytree of padded jnp arrays:
  * triangles are **pre-gathered**: v0/v1/v2 and n0/n1/n2 are (T, 3) arrays
    with the mesh translation baked in at build time — the inner intersection
    loop does zero indirection (the bake happens once on host).
  * materials are stored **per primitive** (albedo/emission/smoothness per
    sphere and per triangle) — no material table gather on the hot path.
  * arrays are padded to a multiple of ``pad`` rows with validity masks so
    shapes are static.

Material encoding follows the reference: ``smoothness == -1.0`` marks a
dielectric (shaders/ray_tracer.wgsl:240); ``smoothness in [0, 1]`` blends
diffuse→specular (shaders/ray_tracer.wgsl:265-269). Colors are RGB (the
reference carries a vec4 whose alpha never affects the image; deviation D7).

The four built-in scenes reproduce src/core/scene.rs constructors:
``balls`` (scene.rs:379), ``random_balls`` (scene.rs:121), ``room``
(scene.rs:198), ``metal`` (scene.rs:311), including their cameras.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .camera import Camera

PAD = 128  # lane-aligned padding unit


def _field(**kw):
    return dataclasses.field(**kw)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Scene:
    """Device-side scene pytree. All arrays f32, padded; counts are static."""

    # Spheres (reference Sphere struct, src/core/scene.rs:13-21)
    sphere_center: jax.Array            # (S, 3)
    sphere_radius: jax.Array            # (S,)
    sphere_albedo: jax.Array            # (S, 3)
    sphere_emission: jax.Array          # (S, 3)
    sphere_emission_strength: jax.Array # (S,)
    sphere_smoothness: jax.Array        # (S,)
    sphere_valid: jax.Array             # (S,) f32 mask {0, 1}

    # Triangles, pre-gathered + translated (reference Mesh/Vertex indirection,
    # shaders/ray_tracer.wgsl:159-181, baked at build time)
    tri_v0: jax.Array                   # (T, 3)
    tri_v1: jax.Array                   # (T, 3)
    tri_v2: jax.Array                   # (T, 3)
    tri_n0: jax.Array                   # (T, 3)  raw vertex normals (the
    tri_n1: jax.Array                   # (T, 3)  barycentric blend is
    tri_n2: jax.Array                   # (T, 3)  normalized at hit time)
    tri_albedo: jax.Array               # (T, 3)
    tri_emission: jax.Array             # (T, 3)
    tri_emission_strength: jax.Array    # (T,)
    tri_smoothness: jax.Array           # (T,)
    tri_valid: jax.Array                # (T,) f32 mask {0, 1}

    # UV/texture shading (extension beyond the reference — SURVEY Q10,
    # BASELINE config 3). tri_tex/tri_ntex index the texture stack; -1 =
    # untextured. Tangent frames are precomputed per triangle for normal
    # mapping.
    tri_uv0: jax.Array                  # (T, 2)
    tri_uv1: jax.Array                  # (T, 2)
    tri_uv2: jax.Array                  # (T, 2)
    tri_tan: jax.Array                  # (T, 3)
    tri_bitan: jax.Array                # (T, 3)
    tri_tex: jax.Array                  # (T,) int32
    tri_ntex: jax.Array                 # (T,) int32
    textures: jax.Array                 # (K, R, R, 3) linear f32

    num_spheres: int = _field(metadata=dict(static=True), default=0)
    num_tris: int = _field(metadata=dict(static=True), default=0)
    num_textures: int = _field(metadata=dict(static=True), default=0)
    # static: lets the shading path skip the normal-map sample+decode
    # entirely when no triangle references one (the common case)
    num_normal_maps: int = _field(metadata=dict(static=True), default=0)

    @property
    def padded_spheres(self) -> int:
        return self.sphere_center.shape[0]

    @property
    def padded_tris(self) -> int:
        return self.tri_v0.shape[0]


@dataclasses.dataclass
class SceneBuilder:
    """Host-side scene assembly (analog of the Vec-based Scene struct,
    src/core/scene.rs:94-100, plus the loader append path in
    src/core/resource.rs:72-105)."""

    spheres: List[Tuple] = dataclasses.field(default_factory=list)
    tris: List[Tuple] = dataclasses.field(default_factory=list)
    textures: List[np.ndarray] = dataclasses.field(default_factory=list)
    texture_resolution: int = 512

    def add_texture(self, image, srgb: bool = True) -> int:
        """Register a texture image; returns its id for add_mesh(tex=...).
        Diffuse maps should pass srgb=True (decoded to linear), normal maps
        srgb=False."""
        from .texture import prepare_texture
        self.textures.append(
            prepare_texture(image, self.texture_resolution, srgb))
        return len(self.textures) - 1

    def add_sphere(self, center, radius, albedo, emission=(0.0, 0.0, 0.0),
                   emission_strength=0.0, smoothness=0.0) -> "SceneBuilder":
        # Clamp mirrors Sphere::new (src/core/scene.rs:47-58): specular >= 1
        # becomes 1; negative (dielectric sentinel) passes through.
        smoothness = smoothness if smoothness < 1.0 else 1.0
        self.spheres.append((tuple(center), float(radius), tuple(albedo),
                             tuple(emission), float(emission_strength),
                             float(smoothness)))
        return self

    def add_mesh(self, vertices, normals, indices, pos=(0.0, 0.0, 0.0),
                 albedo=(0.2, 0.2, 1.0), emission=(0.0, 0.0, 0.0),
                 emission_strength=0.0, smoothness=0.5, uvs=None,
                 tex: int = -1, normal_tex: int = -1) -> "SceneBuilder":
        """Append a triangle mesh; bakes ``pos`` translation into vertices
        (the reference translates per-intersection, wgsl:172-174).

        ``uvs`` ((N, 2), v-down convention) with ``tex``/``normal_tex`` ids
        from add_texture enable textured shading; albedo acts as a tint.
        Vectorized: per-mesh numpy gathers, no per-triangle Python loop.
        """
        vertices = np.asarray(vertices, np.float32).reshape(-1, 3)
        normals = np.asarray(normals, np.float32).reshape(-1, 3)
        indices = np.asarray(indices, np.uint32).reshape(-1)
        if indices.size % 3 != 0:
            raise ValueError("indices length must be a multiple of 3")
        if uvs is None:
            uvs = np.zeros((vertices.shape[0], 2), np.float32)
            tex = normal_tex = -1
        else:
            uvs = np.asarray(uvs, np.float32).reshape(-1, 2)
        pos = np.asarray(pos, np.float32)
        smoothness = smoothness if smoothness < 1.0 else 1.0

        tri = indices.reshape(-1, 3).astype(np.int64)
        rec = {
            "v0": vertices[tri[:, 0]] + pos,
            "v1": vertices[tri[:, 1]] + pos,
            "v2": vertices[tri[:, 2]] + pos,
            "n0": normals[tri[:, 0]],
            "n1": normals[tri[:, 1]],
            "n2": normals[tri[:, 2]],
            "uv0": uvs[tri[:, 0]],
            "uv1": uvs[tri[:, 1]],
            "uv2": uvs[tri[:, 2]],
            "albedo": np.asarray(albedo, np.float32),
            "emission": np.asarray(emission, np.float32),
            "emission_strength": float(emission_strength),
            "smoothness": float(smoothness),
            "tex": int(tex),
            "ntex": int(normal_tex),
        }
        self.tris.append(rec)
        return self

    @property
    def num_tris(self) -> int:
        return sum(r["v0"].shape[0] for r in self.tris)

    def bounds(self) -> Tuple[np.ndarray, np.ndarray]:
        """Host-side AABB over all primitives (min, max) — use this for
        camera framing instead of pulling device arrays back."""
        pts = []
        for c, r, *_ in self.spheres:
            c = np.asarray(c, np.float32)
            pts.append(c - r)
            pts.append(c + r)
        for rec in self.tris:
            for k in ("v0", "v1", "v2"):
                if rec[k].size:
                    pts.append(rec[k].min(0))
                    pts.append(rec[k].max(0))
        if not pts:
            return np.zeros(3, np.float32), np.zeros(3, np.float32)
        pts = np.stack(pts)
        return pts.min(0), pts.max(0)

    def build(self, pad: int = PAD, sort_tris: bool = True) -> Scene:
        """Build the device Scene.

        ``sort_tris`` reorders triangles by recursive median splits of
        their centroids so that consecutive triangles are spatially
        coherent — the kernel culls whole 64-triangle clusters against
        their AABBs (ops/pallas_intersect.py), which only pays off when
        clusters are spatially tight. Pure renaming of primitive ids;
        images unchanged.
        """
        S = len(self.spheres)
        SP = max(pad, -(-max(S, 1) // pad) * pad)

        def arr(shape, fill=0.0):
            return np.full(shape, fill, np.float32)

        sc, sr = arr((SP, 3)), arr((SP,))
        sa, se = arr((SP, 3)), arr((SP, 3))
        ses, ss, sv = arr((SP,)), arr((SP,)), arr((SP,))
        for i, (c, r, a, e, es, sm) in enumerate(self.spheres):
            sc[i], sr[i], sa[i], se[i], ses[i], ss[i], sv[i] = c, r, a, e, es, sm, 1.0

        # concatenate per-mesh records (vectorized; no per-tri Python loop)
        def cat(key, width):
            if not self.tris:
                return np.zeros((0, width), np.float32) if width else np.zeros((0,), np.float32)
            return np.concatenate([np.asarray(r[key], np.float32).reshape(-1, width) if width
                                   else np.asarray(r[key], np.float32).reshape(-1)
                                   for r in self.tris])

        v0, v1, v2 = cat("v0", 3), cat("v1", 3), cat("v2", 3)
        n0, n1, n2 = cat("n0", 3), cat("n1", 3), cat("n2", 3)
        uv0, uv1, uv2 = cat("uv0", 2), cat("uv1", 2), cat("uv2", 2)
        T = v0.shape[0]
        albedo = (np.concatenate([np.tile(r["albedo"], (r["v0"].shape[0], 1))
                                  for r in self.tris])
                  if self.tris else np.zeros((0, 3), np.float32))
        emission = (np.concatenate([np.tile(r["emission"], (r["v0"].shape[0], 1))
                                    for r in self.tris])
                    if self.tris else np.zeros((0, 3), np.float32))
        def scalar_cat(key, dtype=np.float32):
            if not self.tris:
                return np.zeros((0,), dtype)
            return np.concatenate([
                np.full((r["v0"].shape[0],), r[key], dtype) for r in self.tris])
        estr = scalar_cat("emission_strength")
        smooth = scalar_cat("smoothness")
        texid = scalar_cat("tex", np.int32)
        ntexid = scalar_cat("ntex", np.int32)

        if sort_tris and T > 1:
            # recursive median-split ordering: chunk AABBs are BVH-leaf
            # quality (see _median_split_order)
            order = _median_split_order((v0 + v1 + v2) / 3.0)
            v0, v1, v2 = v0[order], v1[order], v2[order]
            n0, n1, n2 = n0[order], n1[order], n2[order]
            uv0, uv1, uv2 = uv0[order], uv1[order], uv2[order]
            albedo, emission = albedo[order], emission[order]
            estr, smooth = estr[order], smooth[order]
            texid, ntexid = texid[order], ntexid[order]

        TP = max(pad, -(-max(T, 1) // pad) * pad)

        def padded(a, width=None):
            shape = (TP,) if width is None else (TP, width)
            out = np.zeros(shape, a.dtype)
            out[:T] = a
            return out

        tvld = np.zeros((TP,), np.float32)
        tvld[:T] = 1.0
        v0p, v1p, v2p = padded(v0, 3), padded(v1, 3), padded(v2, 3)
        uv0p, uv1p, uv2p = padded(uv0, 2), padded(uv1, 2), padded(uv2, 2)

        # per-triangle tangent frame from UVs (for normal mapping):
        #   [T B] = [e1 e2] · inv([[du1, du2], [dv1, dv2]])
        e1 = v1p - v0p
        e2 = v2p - v0p
        duv1 = uv1p - uv0p
        duv2 = uv2p - uv0p
        det = duv1[:, 0] * duv2[:, 1] - duv1[:, 1] * duv2[:, 0]
        r = np.where(np.abs(det) > 1e-12, 1.0 / np.where(det == 0, 1, det), 0.0)
        tan = (e1 * duv2[:, 1:2] - e2 * duv1[:, 1:2]) * r[:, None]
        bitan = (e2 * duv1[:, 0:1] - e1 * duv2[:, 0:1]) * r[:, None]

        texid_p = np.full((TP,), -1, np.int32)
        texid_p[:T] = texid
        ntexid_p = np.full((TP,), -1, np.int32)
        ntexid_p[:T] = ntexid

        if self.textures:
            tex_stack = np.stack(self.textures).astype(np.float32)
        else:
            tex_stack = np.zeros((1, 1, 1, 3), np.float32)

        j = jnp.asarray
        return Scene(
            sphere_center=j(sc), sphere_radius=j(sr), sphere_albedo=j(sa),
            sphere_emission=j(se), sphere_emission_strength=j(ses),
            sphere_smoothness=j(ss), sphere_valid=j(sv),
            tri_v0=j(v0p), tri_v1=j(v1p), tri_v2=j(v2p),
            tri_n0=j(padded(n0, 3)), tri_n1=j(padded(n1, 3)),
            tri_n2=j(padded(n2, 3)),
            tri_albedo=j(padded(albedo, 3)), tri_emission=j(padded(emission, 3)),
            tri_emission_strength=j(padded(estr)),
            tri_smoothness=j(padded(smooth)), tri_valid=j(tvld),
            tri_uv0=j(uv0p), tri_uv1=j(uv1p), tri_uv2=j(uv2p),
            tri_tan=j(tan.astype(np.float32)),
            tri_bitan=j(bitan.astype(np.float32)),
            tri_tex=j(texid_p), tri_ntex=j(ntexid_p), textures=j(tex_stack),
            num_spheres=S, num_tris=T, num_textures=len(self.textures),
            num_normal_maps=int((ntexid_p >= 0).sum()),
        )


def _median_split_order(centroids: np.ndarray, leaf: int = 64) -> np.ndarray:
    """Recursive widest-axis median-split ordering of triangle centroids.

    Consecutive ``leaf``-sized chunks of the result are spatially TIGHT,
    BVH-leaf-quality clusters — unlike fixed-size chunks of a Morton
    curve, whose AABBs straddle curve jumps — and consecutive groups of
    chunks approximate subtrees, so the kernel's two-level (supers ->
    clusters) prepass inherits BVH-interior-quality boxes too. Splits land
    on multiples of ``leaf`` nearest the median so every chunk except the
    last is exactly ``leaf`` triangles (the kernel's cluster size).
    Host-side, order-only: images are unchanged (primitive renaming)."""
    c = np.asarray(centroids, np.float64)
    n = c.shape[0]
    out = np.empty(n, np.int64)
    pos = 0
    # explicit stack, left-first DFS = final in-order layout
    stack = [np.arange(n)]
    while stack:
        idx = stack.pop()
        if idx.shape[0] <= leaf:
            out[pos:pos + idx.shape[0]] = idx
            pos += idx.shape[0]
            continue
        ext = c[idx].max(0) - c[idx].min(0)
        ax = int(np.argmax(ext))
        m = int(round((idx.shape[0] / 2) / leaf)) * leaf
        m = min(max(m, leaf), idx.shape[0] - 1)
        part = np.argpartition(c[idx, ax], m)
        # push right first so the left half pops (and lands) first
        stack.append(idx[part[m:]])
        stack.append(idx[part[:m]])
    return out


# ---------------------------------------------------------------------------
# Built-in scenes (src/core/scene.rs constructors). Each returns
# (Scene, Camera); camera aspect is supplied by the caller (the reference
# derives it from the surface config).
# ---------------------------------------------------------------------------

WHITE = (1.0, 1.0, 1.0)
BLACK = (0.0, 0.0, 0.0)


def scene_balls(aspect: float = 1.0, pad: int = PAD) -> Tuple[Scene, Camera]:
    """Default scene, id 0 (src/core/scene.rs:379-476)."""
    cam = Camera(origin=(3.089, 1.53, -3.0), look_at=(-2.0, -1.0, 2.0),
                 fov=45.0, aspect=aspect, near=0.1, far=100.0,
                 aperture=0.0, focus_dist=0.1)
    b = SceneBuilder()
    b.add_sphere((-3.64, -0.42, 0.8028), 0.75, WHITE, BLACK, 0.0, 0.7)
    b.add_sphere((-2.54, -0.72, 0.5), 0.6, (1.0, 0.0, 0.0), BLACK, 0.0, 0.5)
    b.add_sphere((-1.27, -0.72, 1.0), 0.5, (0.0, 1.0, 0.0), WHITE, 0.0, 0.2)
    b.add_sphere((-0.5, -0.9, 1.55), 0.35, (0.0, 0.0, 1.0), WHITE, 0.0, 0.0)
    # floor
    b.add_sphere((-3.46, -15.88, 2.76), 15.0, (0.5, 0.0, 0.8), WHITE, 0.0, 0.0)
    # light object
    b.add_sphere((-7.44, -0.72, 20.0), 15.0, (0.1, 0.1, 0.1), WHITE, 2.0, 0.0)
    return b.build(pad), cam


def scene_random_balls(aspect: float = 1.0, seed: int = 0,
                       pad: int = PAD) -> Tuple[Scene, Camera]:
    """RTiOW final scene, id 1 (src/core/scene.rs:121-197). The reference
    uses thread_rng (non-reproducible); we take a seed (deviation D8)."""
    cam = Camera(origin=(10.5, 2.0, 3.0), look_at=(0.0, 0.0, 0.0),
                 fov=45.0, aspect=aspect, near=0.1, far=100.0,
                 aperture=0.1, focus_dist=10.0)
    rng = np.random.default_rng(seed)
    b = SceneBuilder()
    b.add_sphere((0.0, -1000.0, 0.0), 1000.0, (0.5, 0.5, 0.5), BLACK, 0.0, 0.0)
    for a in range(-11, 11):
        for c in range(-11, 11):
            mat = rng.random()
            center = (a + 0.9 * rng.random(), 0.2, c + 0.9 * rng.random())
            if np.linalg.norm(np.array(center) - np.array([4.0, 0.2, 0.0])) <= 0.9:
                continue
            if mat < 0.8:
                albedo = tuple(rng.random(3))
                b.add_sphere(center, 0.2, albedo, BLACK, 0.0, 0.0)
            elif mat < 0.95:
                albedo = tuple(rng.uniform(0.5, 1.0, 3))
                fuzz = rng.uniform(0.0, 0.5)
                b.add_sphere(center, 0.2, albedo, BLACK, 0.0, fuzz)
            else:
                b.add_sphere(center, 0.2, WHITE, BLACK, 0.0, -1.0)
    b.add_sphere((0.0, 1.0, 0.0), 1.0, WHITE, BLACK, 0.0, -1.0)
    b.add_sphere((-4.0, 1.0, 0.0), 1.0, (0.4, 0.2, 0.1), BLACK, 0.0, 0.0)
    b.add_sphere((4.0, 1.0, 0.0), 1.0, (0.7, 0.6, 0.5), BLACK, 0.0, 0.9)
    return b.build(pad), cam


# Room geometry (src/core/scene.rs:219-258): 8 cube corners (+/-3) and a
# 2x2 light quad at y=1; the odd non-unit normals are the reference's.
_ROOM_VERTS = np.array([
    [3, -3, -3], [3, -3, 3], [-3, -3, 3], [-3, -3, -3],
    [3, 3, -3], [3, 3, 3], [-3, 3, 3], [-3, 3, -3],
    [1, 1, -1], [1, 1, 1], [-1, 1, 1], [-1, 1, -1],
], np.float32)
_ROOM_NORMALS = np.array([
    [2, -3, -3], [4, -3, 0], [3, -4, 2], [3, -4, 2],
    [3, -4, 2], [3, -4, 2], [3, -4, 2], [3, -4, 2],
    [3, -4, 2], [3, -4, 2], [3, -4, 2], [3, -4, 2],
], np.float32)
_ROOM_INDICES = np.array([
    3, 2, 1, 3, 1, 0,
    7, 0, 4, 7, 3, 0,
    7, 6, 2, 7, 2, 3,
    2, 6, 5, 2, 5, 1,
    1, 5, 4, 1, 4, 0,
    5, 6, 7, 5, 7, 4,
    9, 10, 11, 9, 11, 8,
], np.uint32)
_ROOM_WALL_COLORS = [
    (1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.0, 0.0, 1.0),
    (0.5, 0.5, 0.0), (0.0, 0.5, 0.5), (1.0, 1.0, 1.0),
]


def scene_room(aspect: float = 1.0, pad: int = PAD) -> Tuple[Scene, Camera]:
    """Cube room with emissive ceiling quad, id 2 (src/core/scene.rs:198-310)."""
    cam = Camera(origin=(-7.0, 0.0, 0.0), look_at=(1.0, 0.0, 0.0),
                 fov=45.0, aspect=aspect, near=0.1, far=100.0,
                 aperture=0.0, focus_dist=0.1)
    b = SceneBuilder()
    b.add_sphere((4.0, 0.0, 1.7), 1.2, WHITE, BLACK, 0.0, 1.0)
    b.add_sphere((4.0, 0.0, -1.7), 1.2, WHITE, BLACK, 0.0, 0.5)
    for wall in range(6):
        b.add_mesh(_ROOM_VERTS, _ROOM_NORMALS, _ROOM_INDICES[wall * 6:(wall + 1) * 6],
                   pos=(3.0, 0.0, 0.0), albedo=_ROOM_WALL_COLORS[wall],
                   emission=WHITE, emission_strength=0.0, smoothness=0.5)
    b.add_mesh(_ROOM_VERTS, _ROOM_NORMALS, _ROOM_INDICES[36:42],
               pos=(3.0, 1.9, 0.0), albedo=WHITE,
               emission=WHITE, emission_strength=10.5, smoothness=0.0)
    return b.build(pad), cam


def scene_metal(aspect: float = 1.0, pad: int = PAD) -> Tuple[Scene, Camera]:
    """RTiOW ch.10 3-sphere scene, id 3 (src/core/scene.rs:311-378)."""
    cam = Camera(origin=(0.0, 0.0, 3.0), look_at=(0.0, 0.0, -1.0),
                 fov=45.0, aspect=aspect, near=0.1, far=100.0,
                 aperture=0.0, focus_dist=0.1)
    b = SceneBuilder()
    b.add_sphere((0.0, -100.5, -1.0), 100.0, (0.8, 0.8, 0.0), BLACK, 0.0, 0.0)
    b.add_sphere((0.0, 0.0, -1.0), 0.5, (0.7, 0.3, 0.3), BLACK, 0.0, 0.0)
    b.add_sphere((-1.0, 0.0, -1.0), 0.5, (0.8, 0.8, 0.8), BLACK, 0.0, -1.0)
    b.add_sphere((1.0, 0.0, -1.0), 0.5, (0.8, 0.6, 0.2), BLACK, 0.0, 0.15)
    return b.build(pad), cam


BUILTIN_SCENES = {
    "balls": scene_balls,
    "random_balls": scene_random_balls,
    "room": scene_room,
    "metal": scene_metal,
}
# Runtime scene switch ids match src/core/context.rs:261-279.
SCENE_IDS = {0: "balls", 1: "random_balls", 2: "room", 3: "metal"}


def builtin_scene(name_or_id, aspect: float = 1.0, pad: int = PAD,
                  **kw) -> Tuple[Scene, Camera]:
    if isinstance(name_or_id, int):
        name_or_id = SCENE_IDS[name_or_id]
    return BUILTIN_SCENES[name_or_id](aspect=aspect, pad=pad, **kw)
