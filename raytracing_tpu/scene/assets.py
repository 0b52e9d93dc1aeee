"""Host-side image asset loading — the replacement for the stb
wrapper (reference: src/core/rtw_stb_image.hpp:28-178).

Decoding happens once at scene-compile time on the host (a dependency-free
PPM reader; other formats through PIL when it is installed); texels then live on device in the
:class:`ImageAtlas`. Path probing mirrors the reference: ``$RTW_IMAGES``
first, then the filename as given, then ``images/`` walking up to 6 parent
levels (rtw_stb_image.hpp:40-61). A failed load produces the magenta
sentinel texel (rtw_stb_image.hpp:106-111) and a stderr warning.
"""
from __future__ import annotations

import os
import sys
from typing import Optional

import numpy as np

MAGENTA = np.array([[[1.0, 0.0, 1.0]]], dtype=np.float32)  # 1x1 sentinel


def _decode(path: str) -> Optional[np.ndarray]:
    """Decode an image file to float32 RGB in [0,1], or None."""
    if path.lower().endswith((".ppm", ".pnm")):
        try:
            return read_ppm(path).astype(np.float32) / 255.0
        except Exception:
            return None
    try:
        from PIL import Image  # optional: only for non-PPM assets

        with Image.open(path) as im:
            arr = np.asarray(im.convert("RGB"), dtype=np.float32) / 255.0
        return arr
    except Exception:
        return None


def find_image(filename: str) -> Optional[str]:
    """Path probing with the reference's search order
    (rtw_stb_image.hpp:40-61)."""
    candidates = []
    env_dir = os.environ.get("RTW_IMAGES")
    if env_dir:
        candidates.append(os.path.join(env_dir, filename))
    candidates.append(filename)
    prefix = "images/"
    candidates.append(prefix + filename)
    for _ in range(6):
        prefix = "../" + prefix
        candidates.append(prefix + filename)
    # Also probe relative to the repo root (package parent), so demos work
    # from any CWD.
    pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    candidates.append(os.path.join(pkg_root, "images", filename))
    for c in candidates:
        if os.path.isfile(c):
            return c
    return None


def load_image(filename: str) -> np.ndarray:
    """Load an RGB image as float32 [0,1], (H, W, 3).

    Texels are round-tripped through u8 to match the reference's
    float→byte→float conversion (rtw_stb_image.hpp:154-169 then
    texture.hpp:116-117)."""
    path = find_image(filename)
    if path is None:
        print(f"WARNING: could not load image file '{filename}'.", file=sys.stderr)
        return MAGENTA.copy()
    arr = _decode(path)
    if arr is None:
        print(f"WARNING: could not decode image file '{path}'.", file=sys.stderr)
        return MAGENTA.copy()
    q = np.clip(arr, 0.0, 1.0)
    q = np.floor(q * 255.0 + 0.5).astype(np.uint8)  # quantize like convert_to_bytes
    return q.astype(np.float32) / 255.0


def read_ppm(path: str) -> np.ndarray:
    """Minimal binary/ascii PPM (P6/P3) reader, (H, W, 3) uint8."""
    with open(path, "rb") as f:
        data = f.read()

    # Tokenize the header, skipping comments.
    tokens = []
    i = 0
    while len(tokens) < 4 and i < len(data):
        # skip whitespace
        while i < len(data) and data[i : i + 1].isspace():
            i += 1
        if data[i : i + 1] == b"#":
            while i < len(data) and data[i : i + 1] != b"\n":
                i += 1
            continue
        j = i
        while j < len(data) and not data[j : j + 1].isspace():
            j += 1
        tokens.append(data[i:j])
        i = j
    magic, w, h, maxval = tokens[0], int(tokens[1]), int(tokens[2]), int(tokens[3])
    if magic == b"P6":
        i += 1  # single whitespace after maxval
        raw = np.frombuffer(data, dtype=np.uint8, count=w * h * 3, offset=i)
        img = raw.reshape(h, w, 3)
    elif magic == b"P3":
        vals = np.array(data[i:].split(), dtype=np.int32)[: w * h * 3]
        img = vals.reshape(h, w, 3).astype(np.uint8)
    else:
        raise ValueError(f"unsupported PPM magic {magic!r}")
    if maxval != 255:
        img = (img.astype(np.float32) * (255.0 / maxval)).astype(np.uint8)
    return img


def generate_earthlike(height: int = 90, width: int = 180, seed: int = 7) -> np.ndarray:
    """Procedural earth-like equirectangular texture, float32 [0,1].

    Used as a stand-in for the reference's ``images/earthmap.jpg`` asset
    (which we do not copy); drop a real ``earthmap.jpg`` into ``images/`` or
    point ``$RTW_IMAGES`` at one to reproduce the reference scene exactly.
    """
    rng = np.random.default_rng(seed)
    # Low-frequency value-noise continents on the sphere via random spherical
    # harmonics-ish cosine bumps.
    v, u = np.meshgrid(
        np.linspace(0, np.pi, height), np.linspace(0, 2 * np.pi, width), indexing="ij"
    )
    xyz = np.stack(
        [np.sin(v) * np.cos(u), np.sin(v) * np.sin(u), np.cos(v)], axis=-1
    )
    field = np.zeros((height, width))
    for k in range(24):
        d = rng.normal(size=3)
        d /= np.linalg.norm(d)
        freq = rng.uniform(1.0, 6.0)
        phase = rng.uniform(0, 2 * np.pi)
        field += np.cos(freq * (xyz @ d) * np.pi + phase) / (k + 2.0)
    land = field > np.quantile(field, 0.62)
    ocean = np.array([0.05, 0.18, 0.45])
    shore = np.array([0.75, 0.70, 0.45])
    green = np.array([0.13, 0.42, 0.18])
    ice = np.array([0.92, 0.95, 0.97])
    img = np.where(land[..., None], green, ocean)
    # Shore band + polar ice caps
    depth = np.abs(field - np.quantile(field, 0.62))
    img = np.where((land & (depth < 0.02))[..., None], shore, img)
    polar = (v < 0.22) | (v > np.pi - 0.22)
    img = np.where(polar[..., None], ice, img)
    # u8 round-trip like every reference image (rtw_stb_image.hpp:154-169
    # converts to bytes unconditionally)
    u8 = np.clip(np.rint(img * 255.0), 0, 255).astype(np.uint8)
    return u8.astype(np.float32) / np.float32(255.0)
