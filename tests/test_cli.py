"""CLI tests: argument validation + render smoke (Agg/headless)."""

import numpy as np
import pytest

from ray_tracer import cli


def test_frames_zero_rejected(capsys):
    with pytest.raises(SystemExit):
        cli.main(["render", "--frames", "0", "--width", "8", "--height", "8"])


def test_render_one_frame(tmp_path):
    out = tmp_path / "m.png"
    cli.main(["render", "--scene", "metal", "--width", "16", "--height", "16",
              "--frames", "1", "--backend", "jnp", "--skybox",
              "-o", str(out)])
    assert out.exists()
    from PIL import Image
    img = np.asarray(Image.open(out))
    assert img.shape == (16, 16, 3) and img.max() > 0


def test_render_npy_roundtrip(tmp_path):
    out = tmp_path / "m.npy"
    cli.main(["render", "--scene", "metal", "--width", "8", "--height", "8",
              "--frames", "2", "--backend", "jnp", "-o", str(out)])
    img = np.load(out)
    assert img.shape == (8, 8, 3) and np.isfinite(img).all()


def test_info_runs(capsys):
    cli.main(["info"])
    assert "devices" in capsys.readouterr().out


def test_write_png_decodes_without_imaging_library(tmp_path):
    """write_png needs only zlib and struct; decode it the same way."""
    import struct
    import zlib

    from ray_tracer.io.image import to_uint8, write_png

    img = np.random.default_rng(0).random((5, 7, 3)).astype(np.float32)
    path = tmp_path / "x.png"
    write_png(str(path), img)
    data = path.read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, {}
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        assert crc == zlib.crc32(tag + body) & 0xFFFFFFFF
        chunks[tag] = body
        pos += 12 + n
    w, h, depth, color = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
    assert (w, h, depth, color) == (7, 5, 8, 2)
    raw = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8)
    rows = raw.reshape(5, 1 + 7 * 3)
    assert (rows[:, 0] == 0).all()                  # filter type None
    np.testing.assert_array_equal(rows[:, 1:].reshape(5, 7, 3),
                                  to_uint8(img))
