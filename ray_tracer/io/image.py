"""Image output: linear→sRGB encode + PNG/EXR-ish NPY writers.

Replaces the reference's blit-to-sRGB-swapchain (shaders/render.wgsl:33-40
into the sRGB surface format picked at src/core/context.rs:74-83): the
hardware's linear→sRGB conversion on present becomes an explicit encode here.
The renderer's row 0 is the bottom of the frame (RTiOW convention), so
writers flip vertically for display.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def linear_to_srgb(x: np.ndarray) -> np.ndarray:
    """IEC 61966-2-1 transfer function (what the sRGB swapchain applies)."""
    x = np.clip(x, 0.0, 1.0)
    return np.where(x <= 0.0031308, 12.92 * x, 1.055 * np.power(x, 1 / 2.4) - 0.055)


def to_uint8(img, flip: bool = True) -> np.ndarray:
    """(H, W, 3) linear float → uint8 sRGB, top row first."""
    img = np.asarray(img, np.float32)
    if flip:
        img = img[::-1]
    return (linear_to_srgb(img) * 255.0 + 0.5).astype(np.uint8)


def write_png_rgb8(path: str, rgb) -> None:
    """Write an (H, W, 3) uint8 array as an 8-bit RGB PNG (zlib + struct,
    no imaging library)."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w, _ = rgb.shape
    # each scanline is prefixed with filter type 0 (None)
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          rgb.reshape(h, w * 3)], axis=1).tobytes()

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))


def write_png(path: str, img, flip: bool = True) -> None:
    """Write a linear-radiance image as an sRGB PNG."""
    write_png_rgb8(path, to_uint8(img, flip=flip))


def write_npy(path: str, img, flip: bool = True) -> None:
    """Raw linear f32 dump (the analog of the Rgba32Float accumulation
    texture, src/core/texture.rs:12-31) for golden-image comparisons."""
    img = np.asarray(img, np.float32)
    if flip:
        img = img[::-1]
    np.save(path, img)
