"""The SRN-layout data set the training cells read, written at set-up: per
object ``intrinsics.txt``, ``rgb/NNNNNN.png`` and ``pose/NNNNNN.txt``
(camera-to-world in OpenCV's axes, as SRN stores them). The PNGs are
written here, each row with the filter that leaves the smallest sum of
absolute signed bytes (libpng's adaptive heuristic), so that reading them
takes every filter path as real files do."""
from __future__ import annotations

import concurrent.futures as cf
import os
import struct
import zlib

import numpy as np

from . import scene, seeds

FLIP = np.diag(np.array([1.0, -1.0, -1.0, 1.0], dtype=np.float32))


def _chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF)


def encode_png(img: np.ndarray) -> bytes:
    """8-bit RGB (H, W, 3) -> PNG bytes, adaptive row filters."""
    h, w, ch = img.shape
    x = img.reshape(h, w * ch).astype(np.int16)
    left = np.zeros_like(x)
    left[:, ch:] = x[:, :-ch]
    up = np.zeros_like(x)
    up[1:] = x[:-1]
    upleft = np.zeros_like(x)
    upleft[1:, ch:] = x[:-1, :-ch]
    p = left + up - upleft
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
    paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
    cands = np.stack([x, x - left, x - up, x - (left + up) // 2, x - paeth]) & 0xFF      # (5, H, row)
    cost = np.minimum(cands, 256 - cands).sum(axis=-1)                                 # (5, H)
    ftype = cost.argmin(axis=0)
    rows = cands[ftype, np.arange(h)].astype(np.uint8)
    raw = np.concatenate([ftype.astype(np.uint8)[:, None], rows], axis=1).tobytes()
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(raw, 6)) + _chunk(b"IEND", b""))


def _write_object(obj_dir: str, images: np.ndarray, poses: np.ndarray, focal: float, c) -> None:
    os.makedirs(os.path.join(obj_dir, "rgb"))
    os.makedirs(os.path.join(obj_dir, "pose"))
    h, w = images.shape[1:3]
    with open(os.path.join(obj_dir, "intrinsics.txt"), "w") as f:
        f.write(f"{focal} {c[0]} {c[1]} 0.\n0. 0. 0.\n1.\n{h} {w}\n")
    for v in range(images.shape[0]):
        with open(os.path.join(obj_dir, "rgb", f"{v:06d}.png"), "wb") as f:
            f.write(encode_png(images[v]))
        np.savetxt(os.path.join(obj_dir, "pose", f"{v:06d}.txt"), (poses[v] @ FLIP).reshape(1, 16))


def write_srn(root: str, config: dict, objects: int, views: int, seed: int, device, workers: int = 4) -> str:
    """Write ``objects`` objects of ``views`` views under ``root/<name>_train``;
    returns the path the SRN reader takes (``root/<name>``)."""
    cam = config["camera"]
    h, w = cam["image_size"]
    gen = seeds.generator(device, seed, "dataset")
    base = os.path.join(root, "cars")
    jobs = []
    with cf.ThreadPoolExecutor(workers) as pool:
        for start in range(0, objects, 8):
            n = min(8, objects - start)
            objs = scene.random_objects(gen, n, device)
            poses = scene.sphere_poses(gen, n * views, cam["radius"], device).reshape(n, views, 4, 4)
            imgs = scene.render_objects(objs, poses, h, w, cam["focal"], cam["c"]).cpu().numpy()
            poses = poses.cpu().numpy()
            for i in range(n):
                obj_dir = os.path.join(base + "_train", f"obj_{start + i:04d}")
                jobs.append(pool.submit(_write_object, obj_dir, imgs[i], poses[i], cam["focal"], cam["c"]))
        for j in jobs:
            j.result()
    return base
