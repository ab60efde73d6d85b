"""C++ native component tests: parity with the pure-Python implementations."""

import os

import numpy as np
import pytest

from ray_tracer.utils import native

ASSETS = "/root/reference/assets"
needs_native = pytest.mark.skipif(not native.available(),
                                  reason="librtt_native.so not built")
needs_assets = pytest.mark.skipif(not os.path.isdir(ASSETS),
                                  reason="no reference assets")


@needs_native
def test_morton_order_matches_numpy():
    rng = np.random.default_rng(0)
    c = rng.normal(size=(5000, 3)).astype(np.float32) * 7
    got = native.morton_order(c)

    lo, hi = c.min(0).astype(np.float64), c.max(0).astype(np.float64)
    ext = np.maximum(hi - lo, 1e-12)
    q = np.clip(((c - lo) / ext * 1023.0), 0, 1023).astype(np.uint64)

    def spread(x):
        x = (x | (x << 16)) & np.uint64(0x030000FF)
        x = (x | (x << 8)) & np.uint64(0x0300F00F)
        x = (x | (x << 4)) & np.uint64(0x030C30C3)
        x = (x | (x << 2)) & np.uint64(0x09249249)
        return x

    code = ((spread(q[:, 0]) << np.uint64(2))
            | (spread(q[:, 1]) << np.uint64(1)) | spread(q[:, 2]))
    expected = np.argsort(code, kind="stable")
    np.testing.assert_array_equal(got, expected)


@needs_native
@needs_assets
@pytest.mark.parametrize("fname", ["triangle.obj", "simple_cube.obj",
                                   "cube2.obj", "poly_sphere.obj", "cube.obj"])
def test_native_obj_matches_python(fname):
    """The C++ parser and the pure-Python fallback must agree exactly."""
    import ray_tracer.io.loaders as L
    from ray_tracer.utils import native as nat

    path = os.path.join(ASSETS, fname)
    fast = L.load_obj(path)

    # force the Python path
    orig = nat.parse_obj
    try:
        nat.parse_obj = lambda p: None
        slow = L.load_obj(path)
    finally:
        nat.parse_obj = orig

    assert len(fast) == len(slow)
    for a, b in zip(fast, slow):
        assert a.num_triangles == b.num_triangles
        np.testing.assert_allclose(a.positions, b.positions, atol=1e-6)
        np.testing.assert_allclose(a.normals, b.normals, atol=1e-6)
        np.testing.assert_array_equal(a.indices, b.indices)
        assert (a.uvs is None) == (b.uvs is None)
        if a.uvs is not None:
            np.testing.assert_allclose(a.uvs, b.uvs, atol=1e-6)
        assert (a.material is None) == (b.material is None)


@needs_native
def test_native_obj_from_string(tmp_path):
    p = tmp_path / "quad.obj"
    p.write_text("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nf 1 2 3 4\n")
    out = native.parse_obj(str(p))
    assert out is not None and len(out) == 1
    assert out[0]["indices"].size == 6  # fan-triangulated quad
    # smooth normals computed for normal-less file
    np.testing.assert_allclose(out[0]["normals"], [[0, 0, 1]] * 4, atol=1e-6)


def test_missing_library_returns_none(monkeypatch):
    from ray_tracer.utils import native as nat
    monkeypatch.setattr(nat, "_lib", None)
    monkeypatch.setattr(nat, "_load_failed", True)
    assert nat.morton_order(np.zeros((4, 3), np.float32)) is None
    assert nat.parse_obj("/nonexistent.obj") is None
    monkeypatch.setattr(nat, "_load_failed", False)
