"""An animated GIF (GIF89a) writer on numpy and ``struct``.

It stands in for ``imageio.mimwrite(path, frames, duration=1000 / fps)``,
which the JAX package's video apps fall back to where no mp4 encoder is
installed; the port's host has neither imageio nor an mp4 encoder.

- **Palette.** Each frame carries its own 256-entry colour table. A frame
  of at most 256 distinct colours gets them exactly; any other frame gets
  a deterministic median cut to 256 colours, each pixel mapped to its
  nearest entry (squared RGB distance, the lowest index on a tie), with no
  dithering.
- **Compression.** LZW with a minimum code size of 8 and codes of 9 to 12
  bits; the code width grows once the next free code reaches ``2**width``,
  and a clear code is sent when the table's 4096 codes are used up.
- **Framing.** Image data in sub-blocks of at most 255 bytes; each
  frame's Graphic Control Extension carries the delay Pillow writes for
  the same ``duration`` (``int(duration / 10)`` centiseconds). No
  NETSCAPE2.0 loop extension: imageio's ``mimwrite`` with ``duration``
  alone writes none either, so the animation plays once.
"""
from __future__ import annotations

import struct
from typing import Sequence

import numpy as np

_COLORS = 256
_CLEAR, _EOI = 256, 257
_MAX_CODES = 4096


def _median_cut(colors: np.ndarray, counts: np.ndarray, k: int) -> np.ndarray:
    """Split the box of ``colors`` (n, 3) weighted by ``counts`` into at most
    ``k`` boxes: each time the box with the largest pixel count times its
    widest channel range, at its weighted median along that channel. Returns
    the boxes' count-weighted mean colours, rounded, (m, 3) uint8."""
    c = colors.astype(np.int64)

    def stats(members):
        span = c[members].max(0) - c[members].min(0)
        axis = int(np.argmax(span))
        return int(counts[members].sum()) * int(span[axis]), axis

    boxes = [np.arange(len(c))]
    scores = [stats(boxes[0])]
    while len(boxes) < k:
        best = max(range(len(boxes)), key=lambda i: (scores[i][0], -i))
        score, axis = scores[best]
        if score == 0:                        # every box holds one colour
            break
        members = boxes[best]
        members = members[np.lexsort((members, c[members, axis]))]
        cum = np.cumsum(counts[members])
        cut = int(np.clip(np.searchsorted(cum, cum[-1] / 2.0) + 1, 1, len(members) - 1))
        boxes[best:best + 1] = [members[:cut], members[cut:]]
        scores[best:best + 1] = [stats(members[:cut]), stats(members[cut:])]
    means = [np.rint((c[m] * counts[m, None]).sum(0) / counts[m].sum()) for m in boxes]
    return np.asarray(means, np.uint8)


def _nearest(colors: np.ndarray, palette: np.ndarray, block: int = 16384) -> np.ndarray:
    """Index of the nearest palette entry of each colour (squared RGB
    distance; ``argmin`` takes the lowest index on a tie). The distance
    less the colour's own |c|^2, |p|^2 - 2 c.p, is an integer below 2^20,
    so float32 products hold it exactly."""
    p = palette.astype(np.float32)
    p2 = (p * p).sum(-1)
    out = np.empty(len(colors), np.int64)
    for s in range(0, len(colors), block):
        d = p2[None] - 2.0 * (colors[s:s + block].astype(np.float32) @ p.T)
        out[s:s + block] = np.argmin(d, axis=1)
    return out


def quantize(frame: np.ndarray):
    """(H, W, 3) uint8 -> (palette (m, 3) uint8 with m <= 256, indices (H, W)
    uint8): the frame's own colours when it has at most 256, else the
    median cut's."""
    h, w, _ = frame.shape
    keys = (frame[..., 0].astype(np.int32) << 16) | (frame[..., 1].astype(np.int32) << 8) | frame[..., 2]
    uniq, inverse, counts = np.unique(keys.reshape(-1), return_inverse=True, return_counts=True)
    colors = np.stack([(uniq >> 16) & 255, (uniq >> 8) & 255, uniq & 255], -1).astype(np.uint8)
    if len(uniq) <= _COLORS:
        return colors, inverse.reshape(h, w).astype(np.uint8)
    palette = _median_cut(colors, counts, _COLORS)
    return palette, _nearest(colors, palette)[inverse].reshape(h, w).astype(np.uint8)


def lzw_encode(indices: bytes) -> bytes:
    """GIF LZW of (at least one) 8-bit indices with a minimum code size of
    8: the codes, packed least significant bit first."""
    codes = [_CLEAR]
    widths = [9]
    table = {}
    get = table.get
    next_code, width = _EOI + 1, 9
    prefix = indices[0]
    for byte in indices[1:]:
        key = (prefix << 8) | byte
        code = get(key)
        if code is not None:
            prefix = code
            continue
        codes.append(prefix)
        widths.append(width)
        # the decoder adds this entry one code later and widens once its
        # next free code reaches 2**width; widen here as it will
        if next_code >= 1 << width:
            width += 1
        table[key] = next_code
        next_code += 1
        if next_code == _MAX_CODES:
            codes.append(_CLEAR)
            widths.append(width)
            table.clear()
            next_code, width = _EOI + 1, 9
        prefix = byte
    codes.append(prefix)
    widths.append(width)
    if next_code >= 1 << width:
        width += 1
    codes.append(_EOI)
    widths.append(width)
    return _pack(codes, widths)


def _pack(codes: Sequence[int], widths: Sequence[int]) -> bytes:
    c = np.asarray(codes, np.int64)
    w = np.asarray(widths, np.int64)
    bit = np.arange(12)
    bits = ((c[:, None] >> bit) & 1).astype(np.uint8)
    return np.packbits(bits[bit[None, :] < w[:, None]], bitorder="little").tobytes()


def _sub_blocks(data: bytes) -> bytes:
    out = bytearray()
    for s in range(0, len(data), 255):
        block = data[s:s + 255]
        out.append(len(block))
        out += block
    out.append(0)
    return bytes(out)


def mimwrite(path: str, frames: Sequence[np.ndarray], duration: float = 100.0) -> None:
    """Write ``frames`` ((H, W, 3) uint8 each, one size) as an animated GIF,
    each frame shown ``duration`` milliseconds (stored in whole
    centiseconds, rounded down, as Pillow stores it)."""
    frames = [np.asarray(f) for f in frames]
    if not frames:
        raise ValueError("a GIF needs at least one frame")
    h, w = frames[0].shape[:2]
    for f in frames:
        if f.dtype != np.uint8 or f.shape != (h, w, 3):
            raise ValueError(f"frames must be ({h}, {w}, 3) uint8, got {f.shape} {f.dtype}")
    if not (0 < h < 65536 and 0 < w < 65536):
        raise ValueError(f"a GIF frame is at most 65535 x 65535, got {w} x {h}")
    delay = int(duration / 10)
    out = bytearray(b"GIF89a")
    out += struct.pack("<HHBBB", w, h, 0, 0, 0)          # no global colour table
    for f in frames:
        palette, indices = quantize(f)
        table = np.zeros((_COLORS, 3), np.uint8)
        table[: len(palette)] = palette
        out += b"\x21\xf9\x04" + struct.pack("<BHBB", 0, delay, 0, 0)
        out += b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h, 0x80 | 7)   # a 256-entry local table
        out += table.tobytes()
        out += b"\x08" + _sub_blocks(lzw_encode(indices.tobytes()))
    out += b"\x3b"
    with open(path, "wb") as fh:
        fh.write(bytes(out))
