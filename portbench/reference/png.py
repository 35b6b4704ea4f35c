"""A plain PNG reader: 8-bit RGB and RGBA, not interlaced, the five row
filters (PNG specification, §9). Rows filtered with Average or Paeth
depend on the reconstructed byte to their left and above, so the image is
reconstructed one anti-diagonal of pixels at a time; the other filters take
the same steps."""
from __future__ import annotations

import struct
import zlib

import numpy as np


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def read(path: str) -> np.ndarray:
    """(H, W, C) uint8."""
    return read_many([path])[0]


def _parse(path: str):
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, head = 8, [], None
    while pos < len(buf):
        length, kind = struct.unpack(">I4s", buf[pos:pos + 8])
        data = buf[pos + 8:pos + 8 + length]
        if kind == b"IHDR":
            head = struct.unpack(">IIBBBBB", data)
        elif kind == b"IDAT":
            idat.append(data)
        elif kind == b"IEND":
            break
        pos += 12 + length
    w, h, depth, ctype, _, _, interlace = head
    if depth != 8 or ctype not in (2, 6) or interlace:
        raise ValueError(f"{path}: only 8-bit RGB/RGBA without interlacing")
    ch = 3 if ctype == 2 else 4
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, 1 + w * ch)
    return raw[:, 0], raw[:, 1:].reshape(h, w, ch)


def read_many(paths) -> list:
    """Images of one size and pixel format, reconstructed together: each
    anti-diagonal step takes every image's pixels on it."""
    parsed = [_parse(p) for p in paths]
    shapes = {x.shape for _, x in parsed}
    if len(shapes) != 1:
        return [read_many([p])[0] for p in paths]
    h, w, ch = shapes.pop()
    n = len(parsed)
    ftype = np.stack([f for f, _ in parsed])                        # (N, H)
    x = np.stack([x for _, x in parsed]).astype(np.int32)           # (N, H, W, C)
    out = np.zeros((n, h + 1, w + 1, ch), np.int32)                 # a zero row above and column to the left
    ys_all = np.arange(h)
    for d in range(h + w - 1):
        ys = ys_all[max(0, d - w + 1):min(h, d + 1)]
        xs = d - ys
        a, b, c = out[:, ys + 1, xs], out[:, ys, xs + 1], out[:, ys, xs]
        f = ftype[:, ys][..., None]
        pred = np.select([f == 0, f == 1, f == 2, f == 3], [0, a, b, (a + b) // 2], _paeth(a, b, c))
        out[:, ys + 1, xs + 1] = (x[:, ys, xs] + pred) & 0xFF
    return list(out[:, 1:, 1:].astype(np.uint8))
