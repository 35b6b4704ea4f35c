"""SRN's data set as pixelNeRF reads it, and its training batches.

An object directory holds ``intrinsics.txt`` (focal, cx, cy on the first
line), ``rgb/*.png`` and ``pose/*.txt`` (camera-to-world, OpenCV axes,
turned to OpenGL's by diag(1, -1, -1, 1)). Images map to [-1, 1]; a pixel
is foreground where none of its channels is 255, and each view's bounding
box is its foreground's.

A batch (pixelNeRF's train loop, ``train.py``): for each of ``batch_size``
objects of a shuffled epoch order, ``num_source`` source views drawn without
replacement, and ``rays`` target pixels drawn uniformly inside the views'
bounding boxes, each pixel's ray and colour. The draws follow one numpy
``Generator`` in the order the input pipeline makes them: a source-view
count a batch; an epoch's permutation when the index stream needs one (the
stream is read ``lookahead`` indices ahead); then, an object, its source
views, its pixels' views, x and y."""
from __future__ import annotations

import glob
import os

import numpy as np

from . import png

FLIP = np.diag(np.array([1.0, -1.0, -1.0, 1.0], dtype=np.float32))


def read_object(obj_dir: str) -> dict:
    with open(os.path.join(obj_dir, "intrinsics.txt")) as f:
        focal, cx, cy = (float(v) for v in f.readline().split()[:3])
    rgb = np.stack([img[..., :3] for img in png.read_many(sorted(glob.glob(os.path.join(obj_dir, "rgb", "*"))))])
    poses = np.stack([np.loadtxt(p, dtype=np.float32).reshape(4, 4)
                      for p in sorted(glob.glob(os.path.join(obj_dir, "pose", "*")))]) @ FLIP
    fg = (rgb[..., 0] != 255) & (rgb[..., 1] != 255) & (rgb[..., 2] != 255)
    boxes = []
    for m in fg:
        rows, cols = np.where(m.any(axis=1))[0], np.where(m.any(axis=0))[0]
        boxes.append([cols[0], rows[0], cols[-1], rows[-1]])
    return {
        "images": ((rgb.astype(np.float32) / 255.0) - 0.5) / 0.5,
        "poses": poses.astype(np.float32),
        "focal": np.float32(focal),
        "c": np.array([cx, cy], np.float32),
        "bbox": np.array(boxes, np.float32),
    }


def object_dirs(root: str) -> list:
    return sorted(os.path.dirname(p) for p in glob.glob(os.path.join(root, "*", "intrinsics.txt")))


def rays_at(poses, ids, ys, xs, focal, c, near, far) -> np.ndarray:
    """(R, 8) rays through pixel centres' integer positions."""
    d = np.stack([(xs.astype(np.float32) - c[0]) / focal, -(ys.astype(np.float32) - c[1]) / focal,
                  -np.ones(len(xs), np.float32)], axis=-1)
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    dw = np.einsum("rij,rj->ri", poses[ids, :3, :3], d)
    nf = np.broadcast_to(np.array([near, far], np.float32), (len(xs), 2))
    return np.concatenate([poses[ids, :3, 3], dw, nf], axis=-1).astype(np.float32)


def batches(objects, n: int, count: int, seed: int, batch_size: int, rays: int, views, near: float, far: float,
            lookahead: int):
    """The first ``count`` batches: dicts of images (SB, NS, H, W, 3),
    poses, focal (SB,), c (SB, 2), rays (SB, R, 8), rgb_gt (SB, R, 3), and
    the object indices. ``objects(i)`` returns object i's dict, of ``n``."""
    rng = np.random.default_rng(seed)
    stream = []
    out = []

    def next_index():
        if not stream:
            stream.extend(int(i) for i in rng.permutation(n))
        return stream.pop(0)

    submitted = []
    started = False
    for _ in range(count):
        num_source = int(rng.choice(views))
        entries = []
        for _ in range(batch_size):
            if not started:
                submitted += [next_index() for _ in range(lookahead)]
                started = True
            obj = submitted.pop(0)
            submitted.append(next_index())
            d = objects(obj)
            nv, h, w = d["images"].shape[:3]
            src = rng.choice(nv, num_source, replace=False)
            box = d["bbox"]
            ids = rng.integers(0, nv, size=rays)
            b = box[ids]
            xs = (rng.random(rays) * (b[:, 2] + 1 - b[:, 0]) + b[:, 0]).astype(np.int64)
            ys = (rng.random(rays) * (b[:, 3] + 1 - b[:, 1]) + b[:, 1]).astype(np.int64)
            ys, xs = np.clip(ys, 0, h - 1), np.clip(xs, 0, w - 1)
            entries.append({
                "images": d["images"][src], "poses": d["poses"][src], "focal": d["focal"], "c": d["c"],
                "rays": rays_at(d["poses"], ids, ys, xs, d["focal"], d["c"], near, far),
                "rgb_gt": (d["images"][ids, ys, xs] * 0.5 + 0.5).astype(np.float32), "object": obj,
            })
        out.append({k: np.stack([e[k] for e in entries]) for k in entries[0]})
    return out
