"""PNG reading and writing on ``zlib``, ``struct`` and numpy.

The port's only image I/O: it needs no imaging library. :func:`imread`
returns what ``imageio.v2.imread`` (Pillow) returns for the same file:

- 8-bit gray (H, W), gray + alpha (H, W, 2), RGB (H, W, 3), RGBA (H, W, 4),
  all uint8;
- 16-bit gray (H, W) uint16; 16-bit gray + alpha (H, W, 4) uint8 RGBA (gray
  in each colour channel), RGB (H, W, 3) and RGBA (H, W, 4) uint8, each
  sample its high byte (Pillow reduces 16-bit colour to 8 bits);
- 1-bit gray (H, W) bool; 2- and 4-bit gray (H, W) uint8, each level
  scaled to 0-255 (x 85, x 17), as Pillow unpacks them;
- palettes of 1, 2, 4 and 8 bits: (H, W, 3) uint8 RGB. A ``tRNS`` chunk
  is read and not applied, as Pillow's conversion of a palette image to its
  palette's mode does not apply it;
- Adam7 interlaced files of any of these kinds: each of the seven passes is
  a small image of its own, unfiltered as below, and its pixels are placed
  on its grid.

Rows are unfiltered with numpy: None, Sub (a cumulative sum per channel)
and Up rows one row at a time; when a file has an Average or Paeth row,
whose byte depends on the reconstructed byte to its left, the whole image
is reconstructed one anti-diagonal of pixels at a time (a pixel needs only
its left, upper and upper-left neighbours, which lie on earlier
anti-diagonals), H + W - 1 vector steps. :func:`imread_many` reads a list
of files and takes those steps once for every group of files of one size
and pixel format, so that each step's vector holds the group's images.

:func:`imwrite` writes 8-bit gray, RGB and RGBA, every row with one filter
type (None by default) or a filter type per row.
"""
from __future__ import annotations

import struct
import zlib
from typing import Sequence, Union

import numpy as np
from numpy.lib.stride_tricks import as_strided

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> channels
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# the seven passes of Adam7 interlacing: first column, first row, steps
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _chunks(buf: bytes, path: str):
    if buf[:8] != SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos = 8
    while pos + 8 <= len(buf):
        length, kind = struct.unpack_from(">I4s", buf, pos)
        data = buf[pos + 8 : pos + 8 + length]
        (crc,) = struct.unpack_from(">I", buf, pos + 8 + length)
        if zlib.crc32(kind + data) & 0xFFFFFFFF != crc:
            raise ValueError(f"{path}: CRC mismatch in chunk {kind!r}")
        yield kind, data
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError(f"{path}: truncated PNG (no IEND)")


def _paeth(a, b, c):
    pa = np.abs(b - c)
    pb = np.abs(a - c)
    pc = np.abs(a + b - 2 * c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter_rows(ft: np.ndarray, x: np.ndarray, bpp: int) -> np.ndarray:
    """Rows filtered with None, Sub or Up: one row at a time."""
    h, row_bytes = x.shape
    out = np.empty_like(x)
    prev = np.zeros(row_bytes, np.uint8)
    for y in range(h):
        f = ft[y]
        if f == 0:
            out[y] = x[y]
        elif f == 1:
            out[y] = np.cumsum(x[y].reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        else:
            out[y] = x[y] + prev
        prev = out[y]
    return out


def _unfilter_wavefront(ft: np.ndarray, x: np.ndarray, bpp: int) -> np.ndarray:
    """Any mix of the five filters in N images of one size, one
    anti-diagonal of pixels at a time: ``ft`` (N, H) filter types, ``x``
    (N, H, row_bytes) filtered bytes -> (N, H, row_bytes) uint8.

    The images are held skewed, ``s[d + 1, y + 1] = pixel (y, x = d - y)``
    of every image, with a zero border, so a diagonal's left, upper and
    upper-left neighbours are the slices ``s[d, y + 1]``, ``s[d, y]`` and
    ``s[d - 1, y]``. The filters are selected by multiplying with 0/1
    masks: ``np.where`` and masked copies cost several times more on
    masks that change from pixel to pixel."""
    n, h, row_bytes = x.shape
    w = row_bytes // bpp
    n_diag = h + w - 1
    # raw[d, y] = filtered pixel (y, d - y), zero off the image: the rows of
    # a zero-padded copy read with a row stride one pixel short (a view)
    pad = np.zeros((h, w + h, n, bpp), np.int16)
    pad[:, :w] = x.reshape(n, h, w, bpp).transpose(1, 2, 0, 3)
    st = pad.strides
    raw = as_strided(pad, (n_diag, h, n, bpp), (st[1], st[0] - st[1], st[2], st[3]), writeable=False)
    s = np.zeros((n_diag + 1, h + 1, n, bpp), np.int16)
    sel = {k: np.broadcast_to((ft.T == k)[:, :, None], (h, n, bpp)).astype(np.int16)
           for k in (1, 2, 3, 4) if (ft == k).any()}
    zero = np.zeros((h, n, bpp), np.int16)
    for d in range(n_diag):
        y0, y1 = max(0, d - w + 1), min(h - 1, d) + 1
        a = s[d, y0 + 1 : y1 + 1]
        b = s[d, y0:y1]
        c = s[d - 1, y0:y1] if d else zero[: y1 - y0]
        out = s[d + 1, y0 + 1 : y1 + 1]
        np.copyto(out, raw[d, y0:y1])
        if 1 in sel:
            out += a * sel[1][y0:y1]
        if 2 in sel:
            out += b * sel[2][y0:y1]
        if 3 in sel:
            out += ((a + b) >> 1) * sel[3][y0:y1]
        if 4 in sel:
            # Paeth: with da = b - c and db = a - c, |p - a| = |da|,
            # |p - b| = |db| and |p - c| = |da + db|
            da, db = b - c, a - c
            pa, pb, pc = np.abs(da), np.abs(db), np.abs(da + db)
            take_a = (pa <= pb) & (pa <= pc)
            take_b = (pb <= pc) & ~take_a
            out += (c + da * take_b + db * take_a) * sel[4][y0:y1]
        np.bitwise_and(out, 0xFF, out=out)
    # pixel (y, x) = s[y + x + 1, y + 1]: a view of s, copied once
    st = s.strides
    img = as_strided(s[1:, 1:], (h, w, n, bpp), (st[0] + st[1], st[0], st[2], st[3]), writeable=False)
    return img.transpose(2, 0, 1, 3).astype(np.uint8).reshape(n, h, row_bytes)


def _scanlines(data: bytes, height: int, row_bytes: int, path: str):
    """Decompressed IDAT bytes -> (filter types (H,), filtered (H, row_bytes))."""
    buf = np.frombuffer(data, np.uint8)
    if buf.size < height * (row_bytes + 1):
        raise ValueError(f"{path}: image data too short")
    buf = buf[: height * (row_bytes + 1)].reshape(height, row_bytes + 1)
    ft, x = buf[:, 0], buf[:, 1:]
    if ft.size and ft.max() > 4:
        raise ValueError(f"{path}: unknown row filter {int(ft.max())}")
    return ft, x


def _parse(path: str):
    """A file's (header fields, palette, passes): one pass (its grid, filter
    types, filtered scanlines) for a file not interlaced, up to seven for Adam7."""
    with open(path, "rb") as f:
        buf = f.read()
    header = palette = None
    idat = []
    for kind, data in _chunks(buf, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", data)
        elif kind == b"PLTE":
            palette = np.frombuffer(data, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(data)
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    width, height, depth, ctype, _, _, interlace = header
    if ctype not in _CHANNELS:
        raise ValueError(f"{path}: unknown colour type {ctype}")
    supported = depth == 8 or (depth == 16 and ctype != 3) or (depth in (1, 2, 4) and ctype in (0, 3))
    if not supported:
        raise NotImplementedError(f"{path}: bit depth {depth} (colour type {ctype}) is not supported")
    if interlace > 1:
        raise ValueError(f"{path}: unknown interlace method {interlace}")
    if ctype == 3 and palette is None:
        raise ValueError(f"{path}: palette image without PLTE")
    data = zlib.decompress(b"".join(idat))
    parts = []
    pos = 0
    for x0, y0, dx, dy in _ADAM7 if interlace else ((0, 0, 1, 1),):
        w, h = -(-(width - x0) // dx), -(-(height - y0) // dy)
        if w <= 0 or h <= 0:
            continue                                      # an empty pass has no bytes
        row_bytes = -(-w * _CHANNELS[ctype] * depth // 8)
        ft, x = _scanlines(data[pos:], h, row_bytes, path)
        parts.append(((x0, y0, dx, dy), ft, x))
        pos += h * (row_bytes + 1)
    return (width, height, depth, ctype), palette, parts


def _filter_bpp(depth: int, ctype: int) -> int:
    """The byte distance of the Sub, Average and Paeth filters' left
    neighbour: the bytes of a pixel, at least 1."""
    return max(1, _CHANNELS[ctype] * depth // 8)


def _pixels(fields, palette, rows: np.ndarray) -> np.ndarray:
    """Reconstructed (H, row_bytes) scanlines of an image or pass of
    ``fields`` ``(width, height, depth, ctype)`` -> the array
    ``imageio.v2.imread`` returns."""
    width, height, depth, ctype = fields
    channels = _CHANNELS[ctype]
    if depth < 8:
        # gray levels or palette indices, packed most significant bits
        # first; a row ends on a byte
        bits = np.unpackbits(rows, axis=1)[:, : width * depth].reshape(height, width, depth)
        level = np.zeros((height, width), np.uint8)
        for b in range(depth):
            level = (level << 1) | bits[..., b]
        if ctype == 3:
            return palette[level]
        return level.astype(bool) if depth == 1 else level * np.uint8(255 // ((1 << depth) - 1))
    if ctype == 3:
        return palette[rows.reshape(height, width)]
    if depth == 16:
        px = rows.reshape(height, width, channels, 2)
        if ctype == 0:
            return (px[..., 0, 0].astype(np.uint16) << 8) | px[..., 0, 1]
        hi = px[..., 0]                                   # high bytes
        if ctype == 4:
            return np.concatenate([np.repeat(hi[..., :1], 3, axis=-1), hi[..., 1:]], axis=-1)
        return np.ascontiguousarray(hi)
    img = rows.reshape(height, width, channels)
    return img[..., 0] if channels == 1 else img


# bytes of int16 work arrays one wavefront group may hold
_GROUP_BYTES = 32 << 20


def imread_many(paths: Sequence[str]) -> list:
    """``[imread(p) for p in paths]``: the files whose rows need the
    wavefront are reconstructed together, a group of one size and pixel
    format at a time."""
    parsed = [_parse(p) for p in paths]
    # every image's passes (one for a file not interlaced), by (image, pass)
    passes = [(i, j, ft, x) for i, (_, _, parts) in enumerate(parsed) for j, (_, ft, x) in enumerate(parts)]
    rows = {}
    groups = {}
    for i, j, ft, x in passes:
        _, _, depth, ctype = parsed[i][0]
        bpp = _filter_bpp(depth, ctype)
        if np.all(ft <= 2):
            rows[i, j] = _unfilter_rows(ft, x, bpp)
        else:
            groups.setdefault((x.shape, bpp), []).append((i, j, ft, x))
    for ((h, row_bytes), bpp), members in groups.items():
        w = row_bytes // bpp
        per_image = 2 * 2 * (h + 1) * (w + h) * bpp       # pad and s, int16
        step = max(1, _GROUP_BYTES // per_image)
        for k in range(0, len(members), step):
            part = members[k : k + step]
            out = _unfilter_wavefront(np.stack([m[2] for m in part]), np.stack([m[3] for m in part]), bpp)
            for (i, j, _, _), r in zip(part, out):
                rows[i, j] = r
    images = []
    for i, ((width, height, depth, ctype), palette, parts) in enumerate(parsed):
        if len(parts) == 1 and parts[0][0] == (0, 0, 1, 1):
            images.append(_pixels((width, height, depth, ctype), palette, rows[i, 0]))
            continue
        img = None
        for j, ((x0, y0, dx, dy), _, x) in enumerate(parts):
            px = _pixels((-(-(width - x0) // dx), x.shape[0], depth, ctype), palette, rows[i, j])
            if img is None:
                img = np.zeros((height, width) + px.shape[2:], px.dtype)
            img[y0::dy, x0::dx] = px
        images.append(img)
    return images


def imread(path: str) -> np.ndarray:
    """Read a PNG file as ``imageio.v2.imread`` does (see the module doc)."""
    return imread_many([path])[0]


def _chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF)


def _filter_rows(img: np.ndarray, filters: np.ndarray) -> np.ndarray:
    """(H, W, C) uint8 pixels and a filter type per row -> (H, 1 + W*C)
    filtered scanlines (each filter reads the unfiltered image only)."""
    h, w, c = img.shape
    f = np.asarray(filters, np.int64)
    if not f.any():
        out = img.reshape(h, w * c)
    else:
        x = img.astype(np.int32)
        a = np.zeros_like(x)
        a[:, 1:] = x[:, :-1]                              # left
        b = np.zeros_like(x)
        b[1:] = x[:-1]                                    # up
        cc = np.zeros_like(x)
        cc[1:, 1:] = x[:-1, :-1]                          # upper left
        preds = [np.zeros_like(x), a, b, (a + b) >> 1, _paeth(a, b, cc)]
        pred = np.choose(f[:, None, None], preds)
        out = ((x - pred) & 0xFF).astype(np.uint8).reshape(h, w * c)
    return np.concatenate([f.astype(np.uint8)[:, None], out], axis=1)


def imwrite(path: str, img: np.ndarray, filters: Union[int, Sequence[int]] = 0) -> None:
    """Write an 8-bit gray (H, W) or (H, W, 1), RGB (H, W, 3) or RGBA
    (H, W, 4) uint8 image. ``filters``: the row filter type (0 None, 1 Sub,
    2 Up, 3 Average, 4 Paeth) of every row, or one per row."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise TypeError(f"imwrite writes uint8 images, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    if img.ndim != 3 or img.shape[-1] not in (1, 3, 4):
        raise ValueError(f"imwrite writes (H, W), (H, W, 1), (H, W, 3) or (H, W, 4), got {img.shape}")
    h, w, c = img.shape
    ctype = {1: 0, 3: 2, 4: 6}[c]
    f = np.broadcast_to(np.asarray(filters, np.int64), (h,))
    if f.size and (f.min() < 0 or f.max() > 4):
        raise ValueError(f"row filter types are 0-4, got {sorted(set(f.tolist()))}")
    data = _filter_rows(img, f).tobytes()
    with open(path, "wb") as fh:
        fh.write(SIGNATURE)
        fh.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0)))
        fh.write(_chunk(b"IDAT", zlib.compress(data)))
        fh.write(_chunk(b"IEND", b""))
