"""The port's standard-library PNG reader (``utils.imaging.read_png``)
against OpenCV's decoder, and the port's dataset loader (which reads PNGs
with it) against easyhec_tpu's (which reads them with OpenCV).

Exact equality throughout: decoding is lossless. Files come from PIL
(gray, RGB with ``optimize``, RGBA, gray+alpha, palette with and without
transparency: PIL's adaptive filtering picks Sub, Up, Average and Paeth
rows), OpenCV (16-bit gray and colour, BGRA) and the port's own
``write_png``; a small encoder in this file writes every row filter type
in turn at 8 and 16 bits, so each of the five filters is decoded on rows
that need the byte wrap-around.
"""
import dataclasses
import struct
import zlib

import cv2
import numpy as np
import pytest
from PIL import Image

from __graft_entry__ import MINI_URDF
from easyhec_torch.data import load_calib_dataset as t_load_data
from easyhec_torch.robot import build_chain as t_build_chain
from easyhec_torch.robot import parse_urdf as t_parse_urdf
from easyhec_torch.utils.imaging import read_png, write_png
from easyhec_tpu.data import load_calib_dataset as j_load_data
from easyhec_tpu.robot import build_chain, parse_urdf
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)


def _cv2_read(path):
    """easyhec_tpu's _imread: cv2 unchanged, the first three channels BGR->RGB."""
    img = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    if img.ndim == 3 and img.shape[2] >= 3:
        img = cv2.cvtColor(img[..., :3], cv2.COLOR_BGR2RGB)
    return img


def _smooth(h=37, w=53, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    g = (np.sin(xx / 5) + np.cos(yy / 7)) * 60 + 128 + rng.normal(0, 8, (h, w))
    return g.clip(0, 255).astype(np.uint8)


def _writers():
    g = _smooth()
    rgb = np.stack([g, np.roll(g, 3, 1), 255 - g], -1)
    return {
        "pil_gray": lambda p: Image.fromarray(g, "L").save(p),
        "pil_rgb_optimize": lambda p: Image.fromarray(rgb).save(p, optimize=True),
        "pil_rgba": lambda p: Image.fromarray(np.dstack([rgb, g])).save(p),
        "pil_gray_alpha": lambda p: Image.fromarray(np.stack([g, g // 2], -1), "LA").save(p),
        "pil_palette": lambda p: Image.fromarray(rgb).convert(
            "P", palette=Image.ADAPTIVE).save(p),
        "pil_palette_trns": lambda p: Image.fromarray(rgb).convert(
            "P", palette=Image.ADAPTIVE).save(p, transparency=3),
        "cv2_gray16": lambda p: cv2.imwrite(str(p), g.astype(np.uint16) * 251),
        "cv2_rgb16": lambda p: cv2.imwrite(str(p), rgb[..., ::-1].astype(np.uint16) * 251),
        "cv2_bgra": lambda p: cv2.imwrite(str(p), np.dstack([rgb[..., ::-1], g])),
        "port_gray": lambda p: write_png(p, g),
        "port_rgb": lambda p: write_png(p, rgb),
    }


@pytest.mark.parametrize("writer", sorted(_writers()))
def test_read_png_matches_opencv(tmp_path, writer):
    path = tmp_path / f"{writer}.png"
    _writers()[writer](path)
    got, want = read_png(path), _cv2_read(path)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _filter_row(ft, row, prior, bpp):
    """PNG's forward filter of one scanline (uint8 bytes), type ft."""
    x = row.astype(np.int32)
    b = prior.astype(np.int32)
    a = np.concatenate([np.zeros(bpp, np.int32), x[:-bpp]])
    c = np.concatenate([np.zeros(bpp, np.int32), b[:-bpp]])
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    pred = [np.zeros_like(x), a, b, (a + b) >> 1, paeth][ft]
    return ((x - pred) & 0xFF).astype(np.uint8)


def _encode(img, depth, color):
    """A PNG whose row r uses filter type r mod 5."""
    h, w = img.shape[:2]
    raw = (img.astype(">u2") if depth == 16 else img.astype(np.uint8)).tobytes()
    stride = len(raw) // h
    bpp = stride // w
    rows, prior = [], np.zeros(stride, np.uint8)
    for r in range(h):
        row = np.frombuffer(raw[r * stride:(r + 1) * stride], np.uint8)
        rows.append(bytes([r % 5]) + _filter_row(r % 5, row, prior, bpp).tobytes())
        prior = row

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data)))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(rows)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("depth,color", [(8, 2), (8, 0), (16, 0), (16, 6)])
def test_read_png_every_filter(tmp_path, depth, color):
    rng = np.random.default_rng(depth + color)
    ch = {0: 1, 2: 3, 6: 4}[color]
    hi = 65536 if depth == 16 else 256
    img = rng.integers(0, hi, (23, 17, ch)).astype(np.uint16 if depth == 16 else np.uint8)
    img[5:15] = img[5:15, :1]  # runs of equal bytes beside noise
    if ch == 1:
        img = img[..., 0]
    path = tmp_path / "f.png"
    path.write_bytes(_encode(img, depth, color))
    got = read_png(path)
    np.testing.assert_array_equal(got, _cv2_read(path))
    np.testing.assert_array_equal(got, img[..., :3] if ch == 4 else img)


def test_read_png_refuses_interlaced(tmp_path):
    path = tmp_path / "adam7.png"
    write_png(path, _smooth())
    data = bytearray(path.read_bytes())
    data[28] = 1  # IHDR's interlace byte; read_png refuses before the CRC matters
    path.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="adam7.png.*interlaced"):
        read_png(path)


def test_dataset_loader_on_pil_files_matches_jax(tmp_path):
    urdf = tmp_path / "mini.urdf"
    urdf.write_text(MINI_URDF)
    jchain, tchain = build_chain(parse_urdf(urdf)), t_build_chain(t_parse_urdf(urdf))
    d = tmp_path / "data"
    for sub in ("color", "mask", "qpos"):
        (d / sub).mkdir(parents=True)
    rng = np.random.default_rng(3)
    for i in range(3):
        g = _smooth(seed=i)
        Image.fromarray(np.stack([g, g[::-1], np.roll(g, 5, 0)], -1)).save(
            d / "color" / f"{i:06d}.png", optimize=True)
        Image.fromarray(((g > 128) * 255).astype(np.uint8), "L").save(d / "mask" / f"{i:06d}.png")
        np.savetxt(d / "qpos" / f"{i:06d}.txt", rng.uniform(-0.5, 0.5, 2))
    np.savetxt(d / "K.txt", np.array([[60.0, 0, 26], [0, 60.0, 18], [0, 0, 1]]))
    links = ["base", "upper", "fore"]
    jb, tb = j_load_data(d, jchain, links), t_load_data(d, tchain, links)
    assert tb.masks.mean() > 0.1 and tb.rgb.shape == (3, 37, 53, 3)
    for f in dataclasses.fields(jb):
        np.testing.assert_array_equal(getattr(tb, f.name), getattr(jb, f.name), err_msg=f.name)
