"""Minimal PNG writer and reader (standard library only).

The app's renders are 8-bit grey, RGB or RGBA images; this encodes them
with ``zlib`` and ``struct`` so the main path needs no imaging package.
Scanlines use filter type 0 (none).  The reader takes exactly what the
writer produces (8-bit, unfiltered, non-interlaced) and refuses the rest.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_COLOR_TYPE = {1: 0, 3: 2, 4: 6}   # channels -> PNG colour type
_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (
        struct.pack(">I", len(data))
        + tag
        + data
        + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
    )


def encode_png(img: np.ndarray) -> bytes:
    """Encode a uint8 ``[H, W]``, ``[H, W, 1]``, ``[H, W, 3]`` or
    ``[H, W, 4]`` array as PNG bytes."""
    a = np.asarray(img)
    if a.dtype != np.uint8:
        raise ValueError(f"PNG writer takes uint8 images, got {a.dtype}")
    if a.ndim == 2:
        a = a[..., None]
    if a.ndim != 3 or a.shape[2] not in _COLOR_TYPE:
        raise ValueError(f"unsupported image shape {img.shape}")
    h, w, c = a.shape
    pixels = np.ascontiguousarray(a).reshape(h, w * c)
    rows = np.concatenate([np.zeros((h, 1), np.uint8), pixels], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[c], 0, 0, 0)
    return (
        _SIGNATURE
        + _chunk(b"IHDR", ihdr)
        + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
        + _chunk(b"IEND", b"")
    )


def write_png(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img))


def decode_png(data: bytes) -> np.ndarray:
    """Decode PNG bytes written by :func:`encode_png` -> uint8
    ``[H, W]`` or ``[H, W, C]``."""
    if not data.startswith(_SIGNATURE):
        raise ValueError("not a PNG file")
    pos, ihdr, idat = len(_SIGNATURE), None, []
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
    if ihdr is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = ihdr
    channels = {v: k for k, v in _COLOR_TYPE.items()}.get(ctype)
    if depth != 8 or channels is None or interlace:
        raise ValueError(f"unsupported PNG header {ihdr}")
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    rows = rows.reshape(h, 1 + w * channels)
    if rows[:, 0].any():
        raise ValueError("filtered PNG scanlines are not supported")
    img = rows[:, 1:].reshape(h, w, channels)
    return img[..., 0] if channels == 1 else img


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())
