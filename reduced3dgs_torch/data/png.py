"""PNG files in numpy and zlib, for machines without Pillow.

``write_png`` writes 8-bit grey, RGB or RGBA images (filter 0, one zlib
stream at level 1: a 1080p frame in a fraction of Pillow's time, the file
somewhat larger), ``decode_png`` reads non-interlaced 8-bit grey, grey +
alpha, RGB and RGBA files with any of the five row filters.  ``read_png`` takes
Pillow where it is installed (every file Pillow reads) and decode_png
where it is not.  The pixels are the same either way: PNG is lossless.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # colour type -> samples per pixel
_COLOUR_TYPE = {v: k for k, v in _CHANNELS.items()}


def _chunk(kind: bytes, data: bytes) -> bytes:
    body = kind + data
    return (struct.pack(">I", len(data)) + body
            + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF))


def encode_png(img) -> bytes:
    """(H, W) or (H, W, C) uint8, C in 1..4 -> PNG bytes."""
    a = np.asarray(img)
    if a.dtype != np.uint8:
        raise ValueError(f"encode_png: uint8 expected, got {a.dtype}")
    if a.ndim == 2:
        a = a[:, :, None]
    h, w, c = a.shape
    rows = np.zeros((h, 1 + w * c), np.uint8)  # filter byte 0 per row
    rows[:, 1:] = a.reshape(h, w * c)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, _COLOUR_TYPE[c], 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 1))
            + _chunk(b"IEND", b""))


def write_png(path, img):
    with open(path, "wb") as f:
        f.write(encode_png(img))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, C) uint8 (C = 1, 2, 3 or 4)."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos, idat, head = 8, [], None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            head = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    w, h, depth, ctype, _, _, interlace = head
    if depth != 8 or ctype not in _CHANNELS or interlace:
        raise ValueError(f"decode_png: bit depth {depth}, colour type "
                         f"{ctype}, interlace {interlace} not supported")
    c = _CHANNELS[ctype]
    stride = w * c
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw.reshape(h, 1 + stride)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        kind, line = raw[y, 0], raw[y, 1:].astype(np.int32)
        if kind == 0:
            row = line
        elif kind == 1:  # sub: a running sum per channel
            row = np.cumsum(line.reshape(w, c), axis=0).reshape(stride)
        elif kind == 2:  # up
            row = line + prev
        elif kind in (3, 4):  # average, paeth: sequential along the row
            row = line.copy()
            for x in range(stride):
                left = row[x - c] & 0xFF if x >= c else 0
                if kind == 3:
                    row[x] += (left + prev[x]) >> 1
                else:
                    up_left = prev[x - c] if x >= c else 0
                    row[x] += _paeth(left, prev[x], up_left)
        else:
            raise ValueError(f"decode_png: unknown filter {kind}")
        out[y] = row & 0xFF
        prev = out[y].astype(np.int32)
    return out.reshape(h, w, c)


def read_png(path) -> np.ndarray:
    """The image at `path` as uint8, (H, W) or (H, W, C) as Pillow gives
    it (Pillow where installed, else decode_png for PNG files)."""
    try:
        from PIL import Image
    except ImportError:
        with open(path, "rb") as f:
            a = decode_png(f.read())
        return a[:, :, 0] if a.shape[2] == 1 else a
    with Image.open(path) as img:
        return np.asarray(img)
