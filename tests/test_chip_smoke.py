"""chip_smoke.py off the card: it refuses to run, and its seeded mesh is
deterministic and well formed."""

import os
import shutil
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402


def test_refuses_non_gpu_platform(capsys):
    assert chip_smoke.main([]) != 0
    assert chip_smoke.main(["--four-gpus"]) != 0
    captured = capsys.readouterr()
    assert '"ok"' not in captured.out
    assert "no GPU" in captured.err


def test_fails_alone_in_a_directory(tmp_path):
    """Without the rest of the repository it exits nonzero and prints no
    result line."""
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    for line in proc.stdout.splitlines():
        assert not line.startswith("{"), line


def test_seeded_mesh_deterministic():
    a = chip_smoke.seeded_mesh(32, 16, seed=3)
    b = chip_smoke.seeded_mesh(32, 16, seed=3)
    c = chip_smoke.seeded_mesh(32, 16, seed=4)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert not np.array_equal(a[0], c[0])
    np.testing.assert_array_equal(a[2], c[2])       # same connectivity
    verts, normals, faces = chip_smoke.seeded_mesh()
    assert faces.shape == (16384, 3)                # the flagship size
    assert verts.dtype == np.float32 and np.isfinite(verts).all()


def test_seeded_mesh_closed_and_outward():
    """Every edge is shared by exactly two faces, and the faces wind
    outward: their normals agree with the vertex normals."""
    verts, normals, faces = chip_smoke.seeded_mesh(24, 12, seed=0)
    edges = np.sort(np.concatenate(
        [faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]]), axis=1)
    _, counts = np.unique(edges, axis=0, return_counts=True)
    assert (counts == 2).all()
    fn = np.cross(verts[faces[:, 1]] - verts[faces[:, 0]],
                  verts[faces[:, 2]] - verts[faces[:, 0]])
    assert (np.sum(fn * normals[faces[:, 0]], axis=1) > 0).mean() > 0.99
    np.testing.assert_allclose(np.linalg.norm(normals, axis=1), 1.0,
                               atol=1e-5)


def test_obj_roundtrip_through_loader(tmp_path):
    """The OBJ the CLI phase renders loads back to the same triangles."""
    from ray_tracer.io.loaders import load_obj
    verts, normals, faces = chip_smoke.seeded_mesh(8, 6, seed=1)
    path = str(tmp_path / "mesh.obj")
    chip_smoke.write_obj(path, verts, normals, faces)
    (mesh,) = load_obj(path)
    assert mesh.num_triangles == len(faces)
    got = mesh.positions[mesh.indices.reshape(-1, 3)]
    np.testing.assert_allclose(got, verts[faces], rtol=1e-6, atol=1e-6)

