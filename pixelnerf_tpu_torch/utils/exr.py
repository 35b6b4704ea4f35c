"""Minimal OpenEXR scanline I/O (uncompressed) — no external deps (the
port's own copy of ``pixelnerf_tpu/utils/exr.py``).

The reference's eval writes depth as ``.exr`` via OpenCV
(eval/eval.py:291-310); the port uses neither OpenCV nor imageio, so this
module implements the small needed subset of the OpenEXR 2.0 file
format natively: single-part scanline images, NO_COMPRESSION, FLOAT or HALF
channels. Single-channel images use channel name "Y" (OpenCV's convention
for grayscale EXR); 3-channel images use B/G/R storage order (alphabetical,
as EXR requires channels sorted by name).
"""
from __future__ import annotations

import struct
from typing import Dict, List, Tuple

import numpy as np

_MAGIC = 0x01312F76
_PT_HALF, _PT_FLOAT = 1, 2


def _attr(name: str, type_name: str, data: bytes) -> bytes:
    return (
        name.encode() + b"\x00"
        + type_name.encode() + b"\x00"
        + struct.pack("<i", len(data))
        + data
    )


def _chlist(channels: List[Tuple[str, int]]) -> bytes:
    out = b""
    for name, ptype in channels:
        out += name.encode() + b"\x00"
        out += struct.pack("<i", ptype)      # pixel type
        out += struct.pack("<BBBB", 0, 0, 0, 0)  # pLinear + reserved
        out += struct.pack("<ii", 1, 1)      # x/y sampling
    return out + b"\x00"


def write_exr(path: str, image: np.ndarray, half: bool = False) -> None:
    """Write (H, W) or (H, W, 3) float image as an uncompressed scanline EXR."""
    image = np.asarray(image)
    if image.ndim == 2:
        image = image[..., None]
    H, W, C = image.shape
    assert C in (1, 3), f"1 or 3 channels supported, got {C}"
    ptype = _PT_HALF if half else _PT_FLOAT
    dtype = np.float16 if half else np.float32
    # channels must be stored sorted by name: Y, or B,G,R
    names = ["Y"] if C == 1 else ["B", "G", "R"]
    src_idx = [0] if C == 1 else [2, 1, 0]

    header = b""
    header += _attr("channels", "chlist", _chlist([(n, ptype) for n in names]))
    header += _attr("compression", "compression", struct.pack("<B", 0))
    box = struct.pack("<iiii", 0, 0, W - 1, H - 1)
    header += _attr("dataWindow", "box2i", box)
    header += _attr("displayWindow", "box2i", box)
    header += _attr("lineOrder", "lineOrder", struct.pack("<B", 0))
    header += _attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
    header += _attr("screenWindowCenter", "v2f", struct.pack("<ff", 0.0, 0.0))
    header += _attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
    header += b"\x00"

    pre = struct.pack("<Ii", _MAGIC, 2)  # magic + version 2, single-part
    bytes_per_px = 2 if half else 4
    block_data_size = W * C * bytes_per_px
    block_size = 8 + block_data_size           # y + size prefix + payload
    table_start = len(pre) + len(header)
    data_start = table_start + 8 * H
    offsets = [data_start + y * block_size for y in range(H)]

    with open(path, "wb") as f:
        f.write(pre)
        f.write(header)
        f.write(struct.pack(f"<{H}Q", *offsets))
        img = image.astype(dtype)
        for y in range(H):
            f.write(struct.pack("<ii", y, block_data_size))
            # channel-planar within each scanline, sorted channel order
            for si in src_idx:
                f.write(img[y, :, si].tobytes())


def _read_attrs(buf: bytes, pos: int) -> Tuple[Dict[str, Tuple[str, bytes]], int]:
    attrs = {}
    while buf[pos] != 0:
        end = buf.index(b"\x00", pos)
        name = buf[pos:end].decode()
        pos = end + 1
        end = buf.index(b"\x00", pos)
        type_name = buf[pos:end].decode()
        pos = end + 1
        (size,) = struct.unpack_from("<i", buf, pos)
        pos += 4
        attrs[name] = (type_name, buf[pos : pos + size])
        pos += size
    return attrs, pos + 1


def read_exr(path: str) -> np.ndarray:
    """Read an uncompressed single-part scanline EXR written by write_exr
    (or compatible): returns (H, W) for 1 channel, (H, W, 3) RGB for B/G/R."""
    with open(path, "rb") as f:
        buf = f.read()
    magic, version = struct.unpack_from("<Ii", buf, 0)
    assert magic == _MAGIC, "not an EXR file"
    assert version & 0xFF == 2 and not (version >> 8) & 0x1D, (
        "only single-part scanline EXR supported"
    )
    attrs, pos = _read_attrs(buf, 8)
    assert attrs["compression"][1][0] == 0, "only NO_COMPRESSION supported"
    x0, y0, x1, y1 = struct.unpack("<iiii", attrs["dataWindow"][1])
    W, H = x1 - x0 + 1, y1 - y0 + 1

    chans: List[Tuple[str, int]] = []
    cb = attrs["channels"][1]
    cpos = 0
    while cb[cpos] != 0:
        end = cb.index(b"\x00", cpos)
        name = cb[cpos:end].decode()
        (ptype,) = struct.unpack_from("<i", cb, end + 1)
        chans.append((name, ptype))
        cpos = end + 1 + 16
    dtypes = {_PT_HALF: np.float16, _PT_FLOAT: np.float32}

    offsets = struct.unpack_from(f"<{H}Q", buf, pos)
    out = np.zeros((H, W, len(chans)), np.float32)
    for off in offsets:
        y, _size = struct.unpack_from("<ii", buf, off)
        p = off + 8
        for ci, (_, ptype) in enumerate(chans):
            n = W * np.dtype(dtypes[ptype]).itemsize
            out[y - y0, :, ci] = np.frombuffer(
                buf[p : p + n], dtype=dtypes[ptype]
            ).astype(np.float32)
            p += n
    names = [c[0] for c in chans]
    if names == ["Y"]:
        return out[..., 0]
    if names == ["B", "G", "R"]:
        return out[..., ::-1]
    return out
