"""Render real ShapeNet OBJ meshes into a multi-object dataset with the
PyTorch port's own modules (counterpart of ``scripts/render_shapenet_objs.py
--backend software``: the same flags, the same random draws in the same
order and the same files; the PNGs are written by the port's writer,
``pixelnerf_tpu_torch/utils/png.py``, so their pixels are equal and their
bytes are not).

The software backend is a numpy z-buffer rasterizer
(``pixelnerf_tpu_torch.utils.mesh_raster``): flat Lambertian shading with
the .mtl diffuse colours, no Blender. ``--backend blender`` is not here:
run ``scripts/render_shapenet_objs.py`` under Blender's own Python for it.

On-disk contract (that of ``scripts/make_multi_obj_dataset_torch.py``,
which renders analytic spheres):

    <out>/<split>/<scene>/view_XXX_obj.png   RGBA object pass
    <out>/<split>/<scene>/view_XXX_depth.exr optional depth pass
    <out>/<split>/<scene>/view_XXX_alpha.png optional alpha pass
    <out>/<split>/<scene>/transforms.json    {frames:[{transform_matrix,file_path}],
                                              model_ids, camera_angle_x}
    <src>/{train,val,test}_split_N.txt

Import normalization: -Z forward / Y up, a random z-rotation, the bbox
diameter scaled to 2 units, resting on z=0; one object centred with the
camera at distance 4, or two moved into opposite quadrants with distance
6; views as (pitch, yaw) eulers of an orbit around the look-at point:
train binned-uniform hemisphere yaws with jitter, val/test an Archimedes
spiral.

    python scripts/render_shapenet_objs_torch.py --backend software \
        --src <shapenet_category_dir> --out <dataset_dir> \
        --n_scenes 100 --n_objects 2 --n_views 50 --split train
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pixelnerf_tpu_torch.utils import png  # noqa: E402
from pixelnerf_tpu_torch.utils.exr import write_exr  # noqa: E402
from pixelnerf_tpu_torch.utils.geometry import look_at  # noqa: E402
from pixelnerf_tpu_torch.utils.mesh_raster import load_obj, normalize_mesh, rasterize  # noqa: E402

PITCH_MAX_DEG = 80.0
# Blender's default camera: 50mm focal length on a 36mm sensor
BLENDER_DEFAULT_ANGLE_X = 2.0 * math.atan(36.0 / (2.0 * 50.0))


def view_eulers(split: str, n_views: int, rng: np.random.Generator):
    """(pitch, yaw) per view, radians. train: yaw = 6 pi i / N + U(0, pi / N)
    (binned uniform around the hemisphere), pitch ~ U(0, 80 deg). val/test:
    the SRN Archimedes spiral, pitch climbing linearly over 0..80 deg while
    yaw wraps 3 full turns."""
    pitch_range = (0.0, math.radians(PITCH_MAX_DEG))
    yaws = 6.0 * np.pi * np.arange(n_views) / n_views
    if split == "train":
        pitches = rng.uniform(*pitch_range, size=(n_views,))
        yaws = yaws + rng.uniform(0.0, np.pi / n_views, size=(n_views,))
    else:
        pitches = np.arange(n_views) / n_views * (pitch_range[1] - pitch_range[0])
    return pitches, yaws


def split_scenes(model_dirs, val_frac: float, test_frac: float, rng):
    """Deterministic train/val/test partition of model directories."""
    models = sorted(model_dirs)
    order = rng.permutation(len(models))
    n_val = int(val_frac * len(models))
    n_test = int(test_frac * len(models))
    val = [models[i] for i in order[:n_val]]
    test = [models[i] for i in order[n_val : n_val + n_test]]
    train = [models[i] for i in order[n_val + n_test :]]
    return train, val, test


def write_split_files(src_dir, train, val, test):
    for name, models in (("train", train), ("val", val), ("test", test)):
        path = os.path.join(src_dir, f"{name}_split_{len(models)}.txt")
        with open(path, "w") as f:
            f.write("\n".join(os.path.basename(m) for m in models) + "\n")
        print(f"wrote {path}")


def parse_args(argv):
    p = argparse.ArgumentParser()
    p.add_argument("--src", required=True, help="ShapeNet category dir of OBJ model dirs")
    p.add_argument("--out", required=True, help="output dataset dir")
    p.add_argument("--model_path", default="models/model_normalized.obj")
    p.add_argument("--split", default="train", choices=["train", "val", "test"])
    p.add_argument("--n_scenes", type=int, default=100)
    p.add_argument("--n_objects", type=int, default=2, choices=[1, 2])
    p.add_argument("--n_views", type=int, default=50)
    p.add_argument("--size", type=int, default=128)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--val_frac", type=float, default=0.1)
    p.add_argument("--test_frac", type=float, default=0.1)
    p.add_argument("--backend", default="blender", choices=["blender", "software"],
                   help="'software' = the port's numpy z-buffer rasterizer (flat Lambertian + .mtl Kd "
                   "colors); 'blender' is scripts/render_shapenet_objs.py's, run under Blender")
    p.add_argument("--engine", default="eevee", choices=["eevee", "cycles"], help="blender backend only")
    p.add_argument("--n_samples", type=int, default=64, help="blender backend only")
    p.add_argument("--light_env", default=None, help="blender backend only")
    p.add_argument("--render_depth", action="store_true")
    p.add_argument("--render_alpha", action="store_true")
    p.add_argument("--overwrite", action="store_true")
    return p.parse_args(argv)


def software_main(args):
    """Render the dataset contract with ``utils.mesh_raster``: import
    normalization, quadrant placement, an orbit camera from
    ``view_eulers``, the RGBA object pass, the optional depth and alpha
    passes, transforms.json."""
    rng = np.random.default_rng(args.seed)
    model_dirs = [os.path.join(args.src, d) for d in sorted(os.listdir(args.src))
                  if os.path.isdir(os.path.join(args.src, d))]
    train, val, test = split_scenes(model_dirs, args.val_frac, args.test_frac, rng)
    write_split_files(args.src, train, val, test)
    pool = {"train": train, "val": val, "test": test}[args.split]
    if not pool:
        raise SystemExit(
            f"the {args.split} split is empty ({len(model_dirs)} models, "
            f"val_frac={args.val_frac}, test_frac={args.test_frac}) — add models or adjust the fractions"
        )

    H = W = args.size
    angle_x = BLENDER_DEFAULT_ANGLE_X
    focal = 0.5 * W / math.tan(0.5 * angle_x)

    for scene_i in range(args.n_scenes):
        picks = [pool[int(i)] for i in rng.integers(0, len(pool), args.n_objects)]
        scene_name = "_".join(os.path.basename(p) for p in picks)[:80]
        scene_dir = os.path.join(args.out, args.split, f"{scene_i:05d}_{scene_name}")
        if os.path.isdir(scene_dir) and not args.overwrite:
            print(f"skip existing {scene_dir}")
            continue
        os.makedirs(scene_dir, exist_ok=True)

        meshes = []
        for p in picks:
            verts, faces, colors = load_obj(os.path.join(p, args.model_path))
            z_rot = rng.uniform(0.0, 2.0 * np.pi)
            verts, (lo, hi), origin = normalize_mesh(verts, z_rot)
            meshes.append({"verts": verts, "faces": faces, "colors": colors, "lo": lo, "hi": hi, "origin": origin})

        # placement: 1 object centred at the origin; 2 objects shifted into
        # opposite quadrants by their own bbox minima. The camera aims at the
        # mean of the objects' origins (with the z rest shift)
        locations = []
        if len(meshes) == 1:
            locations.append(meshes[0]["origin"])
            cam_dist = 4.0
        else:
            sign = -1.0
            for m in meshes:
                shift = np.array([sign * m["lo"][0], sign * m["lo"][1], 0.0], np.float32)
                m["verts"] = m["verts"] + shift
                locations.append(m["origin"] + shift)
                sign *= -1.0
            cam_dist = 6.0
        lookat = np.mean(np.stack(locations), axis=0)

        all_verts = np.concatenate([m["verts"] for m in meshes])
        offs = np.cumsum([0] + [m["verts"].shape[0] for m in meshes[:-1]])
        all_faces = np.concatenate([m["faces"] + o for m, o in zip(meshes, offs)])
        all_colors = np.concatenate([m["colors"] for m in meshes])

        pitches, yaws = view_eulers(args.split, args.n_views, rng)
        frames = []
        for i in range(args.n_views):
            # orbit: offset (0, dist, 0) pitched about x, then spun about z, z-up world
            cp, sp = math.cos(pitches[i]), math.sin(pitches[i])
            cy, sy = math.cos(yaws[i]), math.sin(yaws[i])
            off = np.array([-sy * cp * cam_dist, cy * cp * cam_dist, sp * cam_dist], np.float32)
            pose = look_at(lookat + off, lookat, world_up=(0.0, 0.0, 1.0))
            rgb, depth, alpha = rasterize(all_verts, all_faces, all_colors, pose, H, W, focal, bg=0.0)
            stem = f"view_{i:03d}"
            rgba = np.concatenate([(np.clip(rgb, 0, 1) * 255).astype(np.uint8),
                                   (alpha * 255).astype(np.uint8)[..., None]], axis=-1)
            png.imwrite(os.path.join(scene_dir, f"{stem}_obj.png"), rgba)
            if args.render_alpha:
                png.imwrite(os.path.join(scene_dir, f"{stem}_alpha.png"), (alpha * 255).astype(np.uint8))
            if args.render_depth:
                write_exr(os.path.join(scene_dir, f"{stem}_depth.exr"), depth.astype(np.float32))
            frames.append({"transform_matrix": pose.tolist(), "file_path": f"./{stem}"})
        with open(os.path.join(scene_dir, "transforms.json"), "w") as f:
            json.dump({"frames": frames, "model_ids": [os.path.basename(p) for p in picks],
                       "camera_angle_x": angle_x}, f, indent=1)
        print(f"rendered {scene_dir}")


def main(argv=None):
    if argv is None:
        argv = sys.argv[sys.argv.index("--") + 1:] if "--" in sys.argv else sys.argv[1:]
    args = parse_args(argv)
    if args.backend != "software":
        raise SystemExit(
            "--backend blender renders with bpy inside Blender: run scripts/render_shapenet_objs.py "
            "under `blender --background --python` (it imports nothing of the JAX package), or pass "
            "--backend software here"
        )
    software_main(args)


if __name__ == "__main__":
    main()
