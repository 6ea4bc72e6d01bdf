"""Image-panel / mask-overlay helpers and a PNG writer (numpy and the
standard library only).

Torch-package copy of easyhec_tpu/utils/imaging.py, except that images are
written by ``write_png`` (zlib + struct, 8-bit gray or RGB) in place of PIL
or matplotlib, so captures and debug images are written the same way on
every machine.

Capability match for the reference's plt_utils (easyhec/utils/plt_utils.py:
image_grid :26-102, vis_mask alpha-blend+contour overlay :163-201,
hover_masks_on_imgs :144) — used for the TB/PNG diagnostics panels the
reference pushes every 100-200 optimizer steps. Implemented array-first so
the same code runs headless in tests.
"""
from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

__all__ = [
    "to_u8",
    "image_grid",
    "vis_mask",
    "hover_masks_on_imgs",
    "colormap",
    "save_image",
    "write_png",
]

_COLORS = np.array(
    [
        [31, 119, 180], [255, 127, 14], [44, 160, 44], [214, 39, 40],
        [148, 103, 189], [140, 86, 75], [227, 119, 194], [127, 127, 127],
        [188, 189, 34], [23, 190, 207],
    ],
    np.uint8,
)


def colormap(i: int) -> np.ndarray:
    """Stable categorical color for index i (uint8 RGB)."""
    return _COLORS[i % len(_COLORS)].copy()


def to_u8(img: np.ndarray) -> np.ndarray:
    """float [0,1] or uint8, gray or RGB -> uint8 RGB [H, W, 3]."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, -1)
    return img


def _mask_contour(mask: np.ndarray) -> np.ndarray:
    """Binary 1-px contour by 4-neighborhood erosion difference."""
    m = mask > 0.5
    er = m.copy()
    er[1:] &= m[:-1]
    er[:-1] &= m[1:]
    er[:, 1:] &= m[:, :-1]
    er[:, :-1] &= m[:, 1:]
    return m & ~er


def vis_mask(
    img: np.ndarray,
    mask: np.ndarray,
    color=(0, 255, 0),
    alpha: float = 0.4,
    contour: bool = True,
) -> np.ndarray:
    """Alpha-blend a mask over an image, optionally with a solid contour
    (the reference's vis_mask, plt_utils.py:163-201)."""
    out = to_u8(img).astype(np.float32)
    color = np.asarray(color, np.float32)
    m = (np.asarray(mask) > 0.5).astype(np.float32)[..., None]
    out = out * (1 - alpha * m) + color * alpha * m
    if contour:
        out[_mask_contour(np.asarray(mask))] = color
    return out.astype(np.uint8)


def hover_masks_on_imgs(imgs: np.ndarray, masks: np.ndarray) -> np.ndarray:
    """Overlay each mask on its image (reference plt_utils.py:144)."""
    return np.stack(
        [vis_mask(i, m, color=colormap(k)) for k, (i, m) in enumerate(zip(imgs, masks))]
    )


def image_grid(
    images,
    rows: int | None = None,
    cols: int | None = None,
    pad: int = 2,
    pad_value: int = 255,
) -> np.ndarray:
    """Tile N images (same HxW) into one uint8 RGB canvas
    (the reference's image_grid, plt_utils.py:26-102, without matplotlib)."""
    imgs = [to_u8(im) for im in images]
    n = len(imgs)
    if n == 0:
        return np.full((8, 8, 3), pad_value, np.uint8)
    h, w = imgs[0].shape[:2]
    if cols is None and rows is None:
        cols = int(np.ceil(np.sqrt(n)))
    if cols is None:
        cols = -(-n // rows)
    rows = -(-n // cols)
    canvas = np.full(
        (rows * h + (rows + 1) * pad, cols * w + (cols + 1) * pad, 3),
        pad_value,
        np.uint8,
    )
    for i, im in enumerate(imgs):
        r, c = divmod(i, cols)
        y = pad + r * (h + pad)
        x = pad + c * (w + pad)
        canvas[y : y + h, x : x + w] = im
    return canvas


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    body = kind + data
    return struct.pack(">I", len(data)) + body + struct.pack(">I", zlib.crc32(body))


def write_png(path, img: np.ndarray) -> None:
    """Write an 8-bit gray [H, W] or RGB [H, W, 3] uint8 image as PNG
    (no filtering, zlib level 6)."""
    img = np.ascontiguousarray(np.asarray(img))
    if img.dtype != np.uint8:
        raise TypeError(f"write_png needs uint8, got {img.dtype}")
    if img.ndim == 2:
        color = 0
    elif img.ndim == 3 and img.shape[2] == 3:
        color = 2
    else:
        raise ValueError(f"write_png needs [H, W] or [H, W, 3], got {img.shape}")
    h, w = img.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, -1)], axis=1)
    Path(path).write_bytes(
        b"\x89PNG\r\n\x1a\n"
        + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
        + _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
        + _png_chunk(b"IEND", b"")
    )


def save_image(path, img: np.ndarray) -> None:
    """Write an image (float [0, 1] or uint8, gray or RGB) as an RGB PNG."""
    write_png(path, to_u8(img))
