"""Image-panel / mask-overlay helpers and a PNG reader and writer (numpy
and the standard library only).

Torch-package copy of easyhec_tpu/utils/imaging.py, except that images are
written by ``write_png`` (zlib + struct, 8-bit gray or RGB) and read by
``read_png`` in place of PIL, OpenCV or matplotlib, so captures, masks and
debug images are read and written the same way on every machine.

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
    "read_png",
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


_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # color type -> samples per pixel


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
        _PNG_SIG
        + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
        + _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
        + _png_chunk(b"IEND", b"")
    )


def _unfilter(filt: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the PNG scanline filters: filt [h, 1 + w·bpp] uint8 (filter type
    byte first) -> [h, w, bpp] uint8. Sub, Average and Paeth read the byte
    one pixel to the left, so every row is reconstructed along
    anti-diagonals of (row, pixel): a diagonal needs only earlier ones."""
    h = filt.shape[0]
    ft = filt[:, 0]
    raw = filt[:, 1:].reshape(h, -1, bpp).astype(np.int32)
    w = raw.shape[1]
    if (ft == 0).all():
        return raw.astype(np.uint8)
    if (ft > 4).any():
        raise ValueError(f"unknown PNG filter type {int(ft.max())}")
    out = np.zeros((h + 1, w + 1, bpp), np.int32)  # a zero row and column in front
    for d in range(h + w - 1):
        y = np.arange(max(0, d - w + 1), min(h, d + 1))
        x = d - y
        a, b, c = out[y + 1, x], out[y, x + 1], out[y, x]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        f = ft[y][:, None]
        pred = np.select([f == 1, f == 2, f == 3, f == 4], [a, b, (a + b) >> 1, paeth], 0)
        out[y + 1, x + 1] = (raw[y, x] + pred) & 0xFF
    return out[1:, 1:].astype(np.uint8)


def read_png(path) -> np.ndarray:
    """Decode a non-interlaced PNG (zlib + struct; no imaging package):
    color types gray, RGB, palette, gray+alpha and RGBA at 8 or 16 bits
    (palette at 8), every scanline filter.

    Returns what ``cv2.imread(path, cv2.IMREAD_UNCHANGED)`` followed by a
    BGR→RGB swap of the first three channels returns: gray as [H, W], the
    rest as [H, W, 3] RGB with any alpha dropped (gray+alpha as its gray
    repeated three times), uint8 or uint16 as the file's depth."""
    data = Path(path).read_bytes()
    if data[:8] != _PNG_SIG:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, plte, hdr = 8, [], None, None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            plte = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if hdr is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, color, _, _, interlace = hdr
    if interlace:
        raise ValueError(f"{path}: Adam7-interlaced PNGs are not supported")
    if color not in _PNG_CHANNELS or depth not in ((8,) if color == 3 else (8, 16)):
        raise ValueError(f"{path}: unsupported PNG color type {color} at {depth} bits")
    ch = _PNG_CHANNELS[color]
    bpp = ch * depth // 8
    filt = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    px = _unfilter(filt[:h * (1 + w * bpp)].reshape(h, 1 + w * bpp), bpp)
    img = px.view(">u2").astype(np.uint16) if depth == 16 else px  # [h, w, ch]
    if color == 3:
        if plte is None:
            raise ValueError(f"{path}: palette image without PLTE")
        return plte[img[..., 0]]
    if color == 0:
        return img[..., 0]
    if color == 4:
        return np.repeat(img[..., :1], 3, axis=-1)
    return np.ascontiguousarray(img[..., :3])


def save_image(path, img: np.ndarray) -> None:
    """Write an image (float [0, 1] or uint8, gray or RGB) as an RGB PNG."""
    write_png(path, to_u8(img))
