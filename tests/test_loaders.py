"""Loader tests against the reference's bundled assets (counts measured in
SURVEY.md §2: triangle.obj=1, simple_cube.obj=2, cube2.obj=12,
poly_sphere.obj=80, cube.obj=428, the_utah_teapot.glb=15704/2 meshes,
simple_japanese_tree.glb=4844/11 meshes)."""

import json
import os

import numpy as np
import pytest

import ray_tracer as rt
from ray_tracer.io import load_meshes, load_model

ASSETS = "/root/reference/assets"

needs_assets = pytest.mark.skipif(
    not os.path.isdir(ASSETS), reason="reference assets not available")


@needs_assets
@pytest.mark.parametrize("fname,tris", [
    ("triangle.obj", 1),
    ("simple_cube.obj", 2),
    ("cube2.obj", 12),
    # poly_sphere.obj line 250 is malformed ("5/1/16/1/1" — missing space),
    # leaving a 2-corner face that triangulates to nothing: 79 real tris of
    # the 80 f-lines.
    ("poly_sphere.obj", 79),
    ("cube.obj", 428),
])
def test_obj_triangle_counts(fname, tris):
    meshes = load_meshes(os.path.join(ASSETS, fname))
    assert sum(m.num_triangles for m in meshes) == tris


@needs_assets
def test_glb_teapot():
    meshes = load_meshes(os.path.join(ASSETS, "the_utah_teapot.glb"))
    assert len(meshes) == 2
    assert sum(m.num_triangles for m in meshes) == 15704
    for m in meshes:
        assert np.isfinite(m.positions).all()
        assert np.isfinite(m.normals).all()
        assert m.indices.max() < m.positions.shape[0]


@needs_assets
def test_glb_tree():
    meshes = load_meshes(os.path.join(ASSETS, "simple_japanese_tree.glb"))
    assert len(meshes) == 11
    assert sum(m.num_triangles for m in meshes) == 4844


@needs_assets
def test_obj_normals_normalized_when_present():
    meshes = load_meshes(os.path.join(ASSETS, "poly_sphere.obj"))
    m = meshes[0]
    lens = np.linalg.norm(m.normals, axis=-1)
    assert lens.min() > 0.5  # present and sensible (OBJ normals may be unit)


@needs_assets
def test_load_model_reference_placement():
    b = rt.SceneBuilder()
    load_model(os.path.join(ASSETS, "triangle.obj"), b)
    load_model(os.path.join(ASSETS, "simple_cube.obj"), b)
    scene = b.build()
    assert scene.num_tris == 3
    # second model placed at x = 3 * 1 (resource.rs:78-84 semantics)
    v = np.asarray(scene.tri_v0[1:3])
    assert v[:, 0].min() >= 2.0  # translated by +3 in x


@needs_assets
def test_loaded_scene_renders():
    b = rt.SceneBuilder()
    load_model(os.path.join(ASSETS, "cube2.obj"), b, placement="origin",
               pos=(0, 0, 0))
    scene = b.build()
    cam = rt.Camera(origin=(3, 3, 3), look_at=(0, 0, 0), aspect=1.0)
    img = np.asarray(rt.render(
        scene, cam, rt.RenderParams(width=8, height=8, bounces=1, skybox=True,
                                    backend="jnp")))
    assert np.isfinite(img).all()


def test_minimal_obj_from_string(tmp_path):
    p = tmp_path / "tri.obj"
    p.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nvn 0 0 1\nf 1//1 2//1 3//1\n")
    meshes = load_meshes(str(p))
    assert len(meshes) == 1 and meshes[0].num_triangles == 1
    np.testing.assert_allclose(meshes[0].normals, [[0, 0, 1]] * 3)


def test_obj_without_normals_gets_smooth_normals(tmp_path):
    p = tmp_path / "tri.obj"
    p.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n")
    meshes = load_meshes(str(p))
    np.testing.assert_allclose(meshes[0].normals, [[0, 0, 1]] * 3, atol=1e-6)


def test_obj_quad_triangulation(tmp_path):
    p = tmp_path / "quad.obj"
    p.write_text("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nf 1 2 3 4\n")
    meshes = load_meshes(str(p))
    assert meshes[0].num_triangles == 2


def test_obj_malformed_face_skipped_python(tmp_path, monkeypatch):
    """Out-of-range position indices skip the face (no crash) — pure-Python
    parser (ADVICE r1: native parser OOB read; both paths now skip)."""
    from ray_tracer.utils import native
    monkeypatch.setattr(native, "parse_obj", lambda p: None)
    p = tmp_path / "bad.obj"
    p.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\n"
                 "f 1 2 99\n"      # index 99: out of range
                 "f 1 2 3\n")      # valid
    meshes = load_meshes(str(p))
    assert len(meshes) == 1 and meshes[0].num_triangles == 1


def test_obj_malformed_face_skipped_native(tmp_path):
    from ray_tracer.utils import native
    if not native.available():
        import pytest
        pytest.skip("librtt_native.so not built")
    p = tmp_path / "bad.obj"
    p.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\n"
                 "f 1 2 99\n"
                 "f -100 2 3\n"    # relative index far out of range
                 "f 1 2 3\n")
    objs = native.parse_obj(str(p))
    assert objs is not None
    assert sum(o["indices"].size for o in objs) == 3  # only the valid face


def test_gltf_shared_texture_decoded_once(tmp_path, monkeypatch):
    """Two primitives sharing one glTF texture decode the image once and
    register ONE device texture (ADVICE r1: per-primitive duplicates)."""
    import base64
    import io as _io

    from PIL import Image

    from ray_tracer.io import loaders

    buf = _io.BytesIO()
    Image.new("RGB", (2, 2), (255, 0, 0)).save(buf, format="PNG")
    png_uri = "data:image/png;base64," + base64.b64encode(
        buf.getvalue()).decode()

    pos = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    uv = np.array([[0, 0], [1, 0], [0, 1]], np.float32)
    blob = pos.tobytes() + uv.tobytes()
    buf_uri = ("data:application/octet-stream;base64,"
               + base64.b64encode(blob).decode())
    prim = {"attributes": {"POSITION": 0, "TEXCOORD_0": 1}, "material": 0}
    gltf = {
        "asset": {"version": "2.0"},
        "scenes": [{"nodes": [0]}], "nodes": [{"mesh": 0}],
        "meshes": [{"primitives": [dict(prim), dict(prim)]}],
        "materials": [{"pbrMetallicRoughness":
                       {"baseColorTexture": {"index": 0}}}],
        "textures": [{"source": 0}],
        "images": [{"uri": png_uri}],
        "buffers": [{"uri": buf_uri, "byteLength": len(blob)}],
        "bufferViews": [
            {"buffer": 0, "byteOffset": 0, "byteLength": 36},
            {"buffer": 0, "byteOffset": 36, "byteLength": 24}],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": 3,
             "type": "VEC3"},
            {"bufferView": 1, "componentType": 5126, "count": 3,
             "type": "VEC2"}],
    }
    p = tmp_path / "shared.gltf"
    p.write_text(json.dumps(gltf))

    calls = []
    real = loaders._load_gltf_image

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(loaders, "_load_gltf_image", counting)
    b = rt.SceneBuilder()
    load_model(str(p), b, placement="origin")
    assert len(calls) == 1          # decoded once, not per primitive
    assert len(b.textures) == 1     # one device texture registered
    scene = b.build()
    assert scene.num_tris == 2
