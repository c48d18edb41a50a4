"""Saliency-map rendering: upsample -> minmax -> JET overlay -> PNG
(counterpart of istvt_tpu/interpret/heatmap.py, a numpy copy: the port
imports nothing of the JAX package).

Replicates the reference's overlay pipeline (visualize_rel.py:260-294,
show_cam_on_image :39-44): each 19x19 relevance map is bilinearly
upsampled x16 to 304x304, min-max normalized, colorized with the JET
colormap, added to the (0..1) RGB frame, and renormalized by the max.
PNGs are written with zlib and struct from the standard library, so no
imaging package is needed; frames are resized with PIL where it is
installed and by nearest neighbour otherwise, as the JAX module does.
"""
from __future__ import annotations

import os
import struct
import zlib
from typing import Optional

import numpy as np


def bilinear_upsample(m: np.ndarray, scale: int = 16) -> np.ndarray:
    """Bilinear x`scale` upsample of a 2D map (torch interpolate
    align_corners=False semantics, visualize_rel.py:263)."""
    h, w = m.shape
    oh, ow = h * scale, w * scale
    ys = (np.arange(oh) + 0.5) / scale - 0.5
    xs = (np.arange(ow) + 0.5) / scale - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, h - 1)
    y1 = np.clip(y0 + 1, 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, w - 1)
    x1 = np.clip(x0 + 1, 0, w - 1)
    wy = np.clip(ys - y0, 0.0, 1.0)[:, None]
    wx = np.clip(xs - x0, 0.0, 1.0)[None, :]
    top = m[y0][:, x0] * (1 - wx) + m[y0][:, x1] * wx
    bot = m[y1][:, x0] * (1 - wx) + m[y1][:, x1] * wx
    return top * (1 - wy) + bot * wy


def minmax(m: np.ndarray) -> np.ndarray:
    lo, hi = float(m.min()), float(m.max())
    return (m - lo) / (hi - lo + 1e-12)


def jet(m: np.ndarray) -> np.ndarray:
    """JET colormap (OpenCV COLORMAP_JET equivalent): 0 -> blue, 0.5 ->
    green, 1 -> red. Input in [0,1], output float RGB in [0,1]."""
    m = np.clip(m, 0.0, 1.0)
    v = 4.0 * m
    r = np.clip(np.minimum(v - 1.5, -v + 4.5), 0, 1)
    g = np.clip(np.minimum(v - 0.5, -v + 3.5), 0, 1)
    b = np.clip(np.minimum(v + 0.5, -v + 2.5), 0, 1)
    return np.stack([r, g, b], axis=-1)


def show_cam_on_image(img: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """img: float RGB [0,1] HWC; mask: [0,1] HW -> uint8 overlay
    (reference visualize_rel.py:39-44)."""
    heat = jet(mask)
    cam = heat + img.astype(np.float32)
    cam = cam / max(float(cam.max()), 1e-12)
    return np.uint8(255 * cam)


def render_saliency(cam: np.ndarray, frame: Optional[np.ndarray] = None,
                    grid: int = 19, scale: int = 16) -> np.ndarray:
    """cam: (hw,) relevance -> uint8 overlay at (grid*scale)^2 (304^2 for
    the paper geometry, visualize_rel.py:263-266)."""
    m = minmax(bilinear_upsample(cam.reshape(grid, grid).astype(np.float32),
                                 scale))
    size = grid * scale
    if frame is None:
        frame = np.zeros((size, size, 3), np.float32)
    else:
        frame = _resize_rgb(frame, size).astype(np.float32)
        if frame.max() > 1.5:
            frame = frame / 255.0
    return show_cam_on_image(frame, m)


def _resize_rgb(img: np.ndarray, size: int) -> np.ndarray:
    """PIL's bilinear resize of the uint8 image where PIL is installed,
    else nearest neighbour on the image as given (heatmap.py:76-86)."""
    try:
        from PIL import Image
        return np.asarray(Image.fromarray(
            np.uint8(np.clip(img, 0, 255))).resize((size, size),
                                                   Image.BILINEAR))
    except Exception:
        ys = (np.arange(size) * img.shape[0] / size).astype(int)
        xs = (np.arange(size) * img.shape[1] / size).astype(int)
        return img[ys][:, xs]


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def png_bytes(img: np.ndarray) -> bytes:
    """A uint8 (H, W) grayscale or (H, W, 3) RGB image as PNG bytes: 8 bits
    a sample, no filter, one zlib stream."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or not (
            img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 3)):
        raise ValueError(f"save_png takes uint8 (H, W) or (H, W, 3), got "
                         f"{img.dtype} {img.shape}")
    h, w = img.shape[:2]
    color = 0 if img.ndim == 2 else 2
    rows = img.reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    return (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0,
                                          0))
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _chunk(b"IEND", b""))


def save_png(path: str, img: np.ndarray):
    """Write a uint8 (H, W) or (H, W, 3) image as a PNG file."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(png_bytes(img))
