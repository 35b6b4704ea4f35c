"""Generate a multi-object synthetic dataset in the NeRF transforms.json
format consumed by MultiObjectDataset, with the PyTorch port's own modules
(counterpart of ``scripts/make_multi_obj_dataset.py``: the same flags, the
same random draws in the same order and the same files; the PNGs are
written by the port's writer, ``pixelnerf_tpu_torch/utils/png.py``, so
their pixels are equal and their bytes are not).

Like the reference's Blender renderer (scripts/render_shapenet.py) it keeps
the same on-disk contract — per-scene directories with ``view_*.png`` (RGB),
``view_*_obj.png`` (RGBA object pass), ``transforms.json`` with
``transform_matrix`` + ``camera_angle_x``, and split list files — but renders
procedural multi-sphere scenes with the built-in analytic ray tracer instead
of requiring a Blender install + ShapeNet OBJs. Train split uses randomized
hemisphere views; val/test use an Archimedes-spiral trajectory, matching the
reference's split design (render_shapenet.py:492-501).

    python scripts/make_multi_obj_dataset_torch.py --out data/multi_sphere \
        --scenes 20 --views 24 --size 64
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pixelnerf_tpu_torch.data.synthetic import _trace_spheres  # noqa: E402
from pixelnerf_tpu_torch.utils import png  # noqa: E402
from pixelnerf_tpu_torch.utils.geometry import look_at  # noqa: E402


def hemisphere_pose(rng, radius):
    theta = rng.uniform(0, 2 * math.pi)
    phi = rng.uniform(0.05, 0.45 * math.pi)
    eye = radius * np.array(
        [math.cos(phi) * math.sin(theta), math.sin(phi), math.cos(phi) * math.cos(theta)]
    )
    return look_at(eye.astype(np.float32), np.zeros(3))


def spiral_pose(i, n, radius):
    """Archimedes spiral over the hemisphere (deterministic eval trajectory)."""
    t = (i + 0.5) / n
    phi = math.asin(t)                      # elevation sweep
    theta = 2.0 * math.pi * 3.0 * t         # 3 revolutions
    eye = radius * np.array(
        [math.cos(phi) * math.sin(theta), math.sin(phi), math.cos(phi) * math.cos(theta)]
    )
    return look_at(eye.astype(np.float32), np.zeros(3))


def render_scene(scene_dir, rng, args, split):
    n_obj = rng.integers(2, args.max_objects + 1)
    centers = rng.uniform(-0.55, 0.55, size=(n_obj, 3)).astype(np.float32)
    radii = rng.uniform(0.15, 0.3, size=n_obj).astype(np.float32)
    colors = rng.uniform(0.15, 1.0, size=(n_obj, 3)).astype(np.float32)
    light = rng.normal(size=3).astype(np.float32)
    light /= np.linalg.norm(light)

    H = W = args.size
    focal = 0.5 * W / math.tan(0.5 * args.camera_angle_x)
    ys, xs = np.meshgrid(
        np.arange(H, dtype=np.float32), np.arange(W, dtype=np.float32), indexing="ij"
    )
    dirs_cam = np.stack(
        [(xs - W / 2) / focal, -(ys - H / 2) / focal, -np.ones_like(xs)], -1
    )
    dirs_cam /= np.linalg.norm(dirs_cam, axis=-1, keepdims=True)

    os.makedirs(scene_dir, exist_ok=True)
    frames = []
    for v in range(args.views):
        pose = (
            hemisphere_pose(rng, args.radius)
            if split == "train"
            else spiral_pose(v, args.views, args.radius)
        )
        dirs_w = dirs_cam.reshape(-1, 3) @ pose[:3, :3].T
        origins = np.broadcast_to(pose[:3, 3], dirs_w.shape).astype(np.float32)
        rgb, _depth, mask = _trace_spheres(
            origins, dirs_w.astype(np.float32), centers, radii, colors, light, bg=1.0
        )
        rgb = rgb.reshape(H, W, 3)
        mask = mask.reshape(H, W)
        rgb8 = (np.clip(rgb, 0, 1) * 255).astype(np.uint8)
        alpha = (mask * 255).astype(np.uint8)
        name = f"view_{v:03d}"
        png.imwrite(os.path.join(scene_dir, f"{name}.png"), rgb8)
        png.imwrite(
            os.path.join(scene_dir, f"{name}_obj.png"),
            np.concatenate([rgb8, alpha[..., None]], axis=-1),
        )
        frames.append(
            {"file_path": f"./{name}", "transform_matrix": pose.tolist()}
        )
    with open(os.path.join(scene_dir, "transforms.json"), "w") as f:
        json.dump(
            {"camera_angle_x": args.camera_angle_x, "frames": frames}, f, indent=1
        )


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--out", type=str, required=True)
    parser.add_argument("--scenes", type=int, default=20)
    parser.add_argument("--views", type=int, default=24)
    parser.add_argument("--size", type=int, default=64)
    parser.add_argument("--max_objects", type=int, default=4)
    parser.add_argument("--radius", type=float, default=6.0,
                        help="camera orbit radius (z bounds 4/9 in the loader)")
    parser.add_argument("--camera_angle_x", type=float, default=0.45)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--val_frac", type=float, default=0.1)
    parser.add_argument("--test_frac", type=float, default=0.1)
    args = parser.parse_args(argv)

    rng = np.random.default_rng(args.seed)
    n_val = max(1, int(args.scenes * args.val_frac))
    n_test = max(1, int(args.scenes * args.test_frac))
    n_train = args.scenes - n_val - n_test
    splits = (
        [("train", i) for i in range(n_train)]
        + [("val", i) for i in range(n_val)]
        + [("test", i) for i in range(n_test)]
    )
    for split, i in splits:
        scene_dir = os.path.join(args.out, split, f"scene_{split}_{i:04d}")
        render_scene(scene_dir, rng, args, split)
        print("rendered", scene_dir)
    print(f"Done: {n_train} train / {n_val} val / {n_test} test scenes in {args.out}")


if __name__ == "__main__":
    main()
