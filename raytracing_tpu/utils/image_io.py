"""Image output: PPM (the reference's only format, src/common/color.hpp:26-58
+ camera.hpp:36-37) and PNG (8-bit RGB, written with the standard library).

The gamma/quantize pass runs vectorized on device (core/color.py); the host
only serializes bytes. When the native C++ writer (native/rt_native.cpp) is
built, PPM serialization is delegated to it — the NumPy fallback is always
available.
"""
from __future__ import annotations

import os
import struct
import zlib

import numpy as np

import jax.numpy as jnp

from ..core.color import to_u8_image


def _ensure_dir(path: str) -> None:
    d = os.path.dirname(os.path.abspath(path))
    if d:
        os.makedirs(d, exist_ok=True)


def write_ppm(path: str, radiance: np.ndarray) -> None:
    """Write mean radiance (H, W, 3) as ASCII P3 PPM with the reference's
    exact header and quantization semantics (camera.hpp:36-37,
    color.hpp:26-58)."""
    img = np.asarray(to_u8_image(jnp.asarray(radiance, jnp.float32)))
    _ensure_dir(path)
    try:
        from ..native import rt_native

        if rt_native.available():
            rt_native.write_ppm(path, img)
            return
    except ImportError:
        pass
    h, w, _ = img.shape
    with open(path, "w") as f:
        f.write(f"P3\n{w} {h}\n255\n")
        flat = img.reshape(-1, 3)
        lines = [f"{r} {g} {b}\n" for r, g, b in flat]
        f.writelines(lines)


def png_bytes(img: np.ndarray) -> bytes:
    """(H, W, 3) u8 → an 8-bit RGB PNG: one IDAT, filter type 0 per row."""
    h, w, _ = img.shape

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data)))

    rows = np.concatenate(
        [np.zeros((h, 1), np.uint8), np.ascontiguousarray(img, np.uint8)
         .reshape(h, w * 3)], axis=1)
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + chunk(b"IEND", b""))


def write_png(path: str, radiance: np.ndarray) -> None:
    """PNG output (not in the reference; a quality-of-life addition)."""
    img = np.asarray(to_u8_image(jnp.asarray(radiance, jnp.float32)))
    _ensure_dir(path)
    with open(path, "wb") as f:
        f.write(png_bytes(img))


def write_image(path: str, radiance: np.ndarray) -> None:
    """Dispatch by extension; default PPM."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".png":
        write_png(path, radiance)
    else:
        write_ppm(path, radiance)
