"""Minimal PNG writer and reader (8-bit gray, RGB or RGBA) on zlib alone,
so image output needs nothing beyond the standard library and numpy."""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_COLOR_TYPE = {1: 0, 3: 2, 4: 6}   # channels -> PNG colour type
_CHANNELS = {v: k for k, v in _COLOR_TYPE.items()}


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def encode_png(img) -> bytes:
    """uint8 [H, W], [H, W, 3] or [H, W, 4] -> PNG bytes."""
    a = np.asarray(img)
    if a.dtype != np.uint8:
        raise ValueError(f"PNG pixels must be uint8, got {a.dtype}")
    if a.ndim == 2:
        a = a[:, :, None]
    h, w, c = a.shape
    if c not in _COLOR_TYPE:
        raise ValueError(f"PNG needs 1, 3 or 4 channels, got {c}")
    # filter type 0 (None) on every scanline
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           np.ascontiguousarray(a).reshape(h, w * c)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[c], 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def write_png(path: str, img) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img))


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes as :func:`encode_png` writes them (8-bit, not interlaced,
    filter type 0 on every row) -> uint8 [H, W, C]."""
    if not data.startswith(_SIGNATURE):
        raise ValueError("not a PNG file")
    pos, idat, header = len(_SIGNATURE), b"", None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat += body
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8 or interlace or ctype not in _CHANNELS:
        raise ValueError("only 8-bit non-interlaced gray/RGB/RGBA PNGs")
    c = _CHANNELS[ctype]
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, w * c + 1)
    if rows[:, 0].any():
        raise ValueError("only filter type 0 scanlines are supported")
    return rows[:, 1:].reshape(h, w, c).copy()


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())
