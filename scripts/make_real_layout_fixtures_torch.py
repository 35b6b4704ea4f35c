"""Generate on-disk dataset fixtures in the exact real layouts the readers
consume, with the PyTorch port's own modules (counterpart of
``scripts/make_real_layout_fixtures.py``: the same arguments, defaults and
files; the PNGs are written by the port's writer,
``pixelnerf_tpu_torch/utils/png.py``, so their pixels are equal and their
bytes are not).

Three formats, each bit-for-bit in the layout of the public datasets:

- SRN (Sitzmann): ``<out>/<cls>_<stage>/<obj>/{intrinsics.txt, rgb/%06d.png,
  pose/%06d.txt}`` — 50 views/object at 128x128 with white background, poses
  stored in the OpenCV convention the real files use
  (reference src/data/SRNDataset.py:44-123).
- DVR-DTU (IDR-style): ``<out>/rs_dtu_4/DTU/scan<N>/image/%06d.png`` +
  ``cameras.npz`` holding GENUINE 4x4 ``world_mat_i = K [R|t]`` projection
  products of the UN-normalized world plus non-identity ``scale_mat_i``
  normalization matrices, 49 views at 400x300 with off-center principal
  point (reference src/data/DVRDataset.py:157-238).
- NMR/3D-R2N2 (DVR shapenet): real category-id dirs + ``softras_*.lst`` +
  per-object ``{image/, mask/, cameras.npz}`` with 3x4 ``world_mat_i``
  extrinsics and normalized ``camera_mat_i`` intrinsics at 64x64.

Scene content is the deterministic analytic sphere renderer
(pixelnerf_tpu_torch/data/synthetic.py) so every written camera file
round-trips to a KNOWN ground-truth pose — the writer returns those
targets, which the readers must reproduce.

Full-scale generation for the on-chip soak:

    python scripts/make_real_layout_fixtures_torch.py --out data/soak --format srn \
        --objs 15 --views 50
    python scripts/make_real_layout_fixtures_torch.py --out data/soak --format dtu \
        --objs 4 --views 49
    python scripts/make_real_layout_fixtures_torch.py --out data/soak --format nmr \
        --objs 6 --views 24
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pixelnerf_tpu_torch.data.synthetic import SyntheticSphereDataset  # noqa: E402
from pixelnerf_tpu_torch.utils import png  # noqa: E402

# self-inverse coordinate flips (see the adapters for derivations)
_SRN_TRANS = np.diag(np.array([1.0, -1.0, -1.0, 1.0], dtype=np.float32))
_DTU_FLIP = np.diag(np.array([1.0, -1.0, -1.0, 1.0], dtype=np.float32))
_NMR_WORLD = np.array(
    [[1, 0, 0, 0], [0, 0, -1, 0], [0, 1, 0, 0], [0, 0, 0, 1]], dtype=np.float32
)
_NMR_CAM = np.diag(np.array([1.0, -1.0, -1.0, 1.0], dtype=np.float32))


def _scene_source(num_objs, num_views, hw, focal, c, seed, stage="train",
                  white_bkgd=True):
    """Analytic sphere scenes with overridden intrinsics; returns the dataset
    (its ``render_view``/``_poses`` are the ground truth generators)."""
    ds = SyntheticSphereDataset(
        num_objects=num_objs, num_views=num_views, image_size=hw, seed=seed,
        stage=stage, white_bkgd=white_bkgd,
    )
    ds.focal = (
        np.asarray(focal, np.float32) if np.ndim(focal) else float(focal)
    )
    ds.c = np.asarray(c, dtype=np.float32).copy()
    return ds


def _imwrite(path, arr01):
    png.imwrite(path, np.clip(arr01 * 255.0, 0, 255).astype(np.uint8))


# --------------------------------------------------------------------------
# SRN layout
# --------------------------------------------------------------------------

def write_srn_layout(out, stage="train", num_objs=3, num_views=50, size=128,
                     cls="cars", seed=11):
    """``<out>/<cls>_<stage>/<obj>/{intrinsics.txt, rgb/, pose/}``.

    Returns {obj_name: {"poses": (V,4,4) y-up/-z convention, "focal": f,
    "c": (2,)}} ground truth the SRN adapter must reproduce.
    """
    focal = 1.2 * size
    c = (size / 2.0, size / 2.0)
    ds = _scene_source(num_objs, num_views, (size, size), focal, c, seed,
                       stage=stage)
    base = os.path.join(out, f"{cls}_{stage}")
    truth = {}
    for i in range(num_objs):
        name = f"obj{seed}{i:04d}"
        obj = os.path.join(base, name)
        os.makedirs(os.path.join(obj, "rgb"), exist_ok=True)
        os.makedirs(os.path.join(obj, "pose"), exist_ok=True)
        # real SRN intrinsics.txt: focal cx cy 0. / origin / 1. / H W
        with open(os.path.join(obj, "intrinsics.txt"), "w") as f:
            f.write(f"{focal} {c[0]} {c[1]} 0.\n0. 0. 0.\n1.\n{size} {size}\n")
        poses = ds._poses(i)
        for v in range(num_views):
            rgb, _d, _m = ds.render_view(i, poses[v])
            _imwrite(os.path.join(obj, "rgb", f"{v:06d}.png"), rgb)
            # real pose files: 16 whitespace-separated floats on one line,
            # in the OpenCV y-down/z-forward convention the adapter flips
            disk_pose = poses[v] @ _SRN_TRANS
            with open(os.path.join(obj, "pose", f"{v:06d}.txt"), "w") as f:
                f.write(" ".join(f"{x:.9g}" for x in disk_pose.reshape(-1)))
                f.write("\n")
        truth[name] = {"poses": poses, "focal": focal,
                       "c": np.asarray(c, np.float32)}
    return truth


# --------------------------------------------------------------------------
# DVR-DTU layout
# --------------------------------------------------------------------------

def write_dtu_layout(out, num_scans=2, num_views=49, hw=(300, 400), seed=23,
                     splits=None, white_bkgd=False):
    """``<out>/rs_dtu_4/DTU/scan<N>/{image/, cameras.npz}`` + new_*.lst.

    world_mat_i is the genuine K[R|t] product of the UN-normalized camera;
    scale_mat_i carries the normalization (uniform scale + recenter) exactly
    as IDR's preprocessed DTU release does. Returns
    {scan_name: {"poses", "focal", "c"}} in the final normalized y-up/-z
    convention (what DVRDataset(sub_format="dtu") must output).
    """
    H, W = hw
    # genuinely anamorphic per-axis focal (fx != fy) and off-center
    # principal point — real DTU K has both (DVRDataset.py:157-238
    # decomposes P = K[R|t] into per-axis fx, fy, cx, cy)
    focal = np.array([1.05 * W, 0.97 * W], np.float64)
    c = (W / 2.0 + 3.7, H / 2.0 - 2.2)
    K = np.array(
        [[focal[0], 0.0, c[0]], [0.0, focal[1], c[1]], [0.0, 0.0, 1.0]],
        np.float64,
    )
    # genuine non-identity normalization: unit-sphere scale + recenter
    norm_scale = 2.7
    norm_trans = np.array([0.31, -0.22, 0.47], np.float64)
    scale_mat = np.diag([norm_scale] * 3 + [1.0]).astype(np.float64)
    scale_mat[:3, 3] = norm_trans

    ds = _scene_source(num_scans, num_views, (H, W), focal, c, seed,
                       white_bkgd=white_bkgd)
    dtu_dir = os.path.join(out, "rs_dtu_4", "DTU")
    os.makedirs(dtu_dir, exist_ok=True)
    truth, names = {}, []
    for s in range(num_scans):
        name = f"scan{100 + s}"
        scan = os.path.join(dtu_dir, name)
        os.makedirs(os.path.join(scan, "image"), exist_ok=True)
        poses = ds._poses(s)
        cams = {}
        for v in range(num_views):
            rgb, _d, _m = ds.render_view(s, poses[v])
            _imwrite(os.path.join(scan, "image", f"{v:06d}.png"), rgb)
            # final pose -> pre-flip normalized pose -> raw (un-normalized)
            pre = _DTU_FLIP @ poses[v].astype(np.float64) @ _DTU_FLIP
            center_raw = pre[:3, 3] * norm_scale + norm_trans
            R_w2c = pre[:3, :3].T
            t = -R_w2c @ center_raw
            P = np.eye(4, dtype=np.float64)
            P[:3] = K @ np.concatenate([R_w2c, t[:, None]], axis=1)
            cams[f"world_mat_{v}"] = P
            cams[f"scale_mat_{v}"] = scale_mat
        np.savez(os.path.join(scan, "cameras.npz"), **cams)
        names.append(name)
        truth[name] = {"poses": poses, "focal": focal,
                       "c": np.asarray(c, np.float32)}
    if splits is None:
        n_val = max(1, num_scans // 4) if num_scans > 1 else 0
        splits = {"train": names[: len(names) - 2 * n_val] or names,
                  "val": names[len(names) - 2 * n_val: len(names) - n_val],
                  "test": names[len(names) - n_val:]}
    for split, objs in splits.items():
        with open(os.path.join(dtu_dir, f"new_{split}.lst"), "w") as f:
            f.write("\n".join(objs) + ("\n" if objs else ""))
    return truth


# --------------------------------------------------------------------------
# NMR (DVR shapenet) layout
# --------------------------------------------------------------------------

def write_nmr_layout(out, num_cats=2, objs_per_cat=3, num_views=24, size=64,
                     seed=37):
    """``<out>/<catid>/<obj>/{image/, mask/, cameras.npz}`` + softras_*.lst,
    with 3x4 world_mat extrinsics (the real NMR shape — exercises the
    adapter's vstack path) and normalized camera_mat intrinsics."""
    cat_ids = ["02958343", "03001627", "02691156", "04379243"][:num_cats]
    focal = 1.2 * size
    f_norm = focal / (size / 2.0)
    truth = {}
    for ci, cat in enumerate(cat_ids):
        cat_dir = os.path.join(out, cat)
        os.makedirs(cat_dir, exist_ok=True)
        ds = _scene_source(objs_per_cat, num_views, (size, size), focal,
                           (size / 2.0, size / 2.0), seed + 131 * ci)
        names = []
        for i in range(objs_per_cat):
            name = f"{cat[:4]}obj{i:04d}"
            obj = os.path.join(cat_dir, name)
            os.makedirs(os.path.join(obj, "image"), exist_ok=True)
            os.makedirs(os.path.join(obj, "mask"), exist_ok=True)
            poses = ds._poses(i)
            cams = {}
            for v in range(num_views):
                rgb, _d, mask = ds.render_view(i, poses[v])
                _imwrite(os.path.join(obj, "image", f"{v:04d}.png"), rgb)
                _imwrite(os.path.join(obj, "mask", f"{v:04d}.png"),
                         mask.astype(np.float32))
                # adapter: pose = NMR_WORLD @ inv(world_mat) @ NMR_CAM, so
                # world_mat = NMR_CAM @ inv(pose) @ NMR_WORLD (CAM is
                # self-inverse; WORLD is a rotation, NOT self-inverse)
                P = poses[v].astype(np.float64)
                cams[f"world_mat_{v}"] = (
                    _NMR_CAM.astype(np.float64) @ np.linalg.inv(P)
                    @ _NMR_WORLD.astype(np.float64)
                )[:3].astype(np.float32)
                cams[f"camera_mat_{v}"] = np.diag(
                    [f_norm, f_norm, 1.0, 1.0]).astype(np.float32)
            np.savez(os.path.join(obj, "cameras.npz"), **cams)
            names.append(name)
            truth[name] = {"poses": poses, "focal": focal, "cat": cat}
        n_hold = max(1, objs_per_cat // 4) if objs_per_cat > 1 else 0
        splits = {"train": names[: len(names) - 2 * n_hold] or names,
                  "val": names[len(names) - 2 * n_hold: len(names) - n_hold],
                  "test": names[len(names) - n_hold:]}
        for split, objs in splits.items():
            with open(os.path.join(cat_dir, f"softras_{split}.lst"), "w") as f:
                f.write("\n".join(objs) + ("\n" if objs else ""))
    return truth


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--format", required=True, choices=["srn", "dtu", "nmr"])
    ap.add_argument("--objs", type=int, default=None)
    ap.add_argument("--views", type=int, default=None)
    ap.add_argument("--size", type=int, default=None)
    ap.add_argument("--seed", type=int, default=None,
                    help="scene seed; seed 0 reproduces the in-memory "
                    "synthetic generator's scenes exactly (same class, "
                    "same stage offsets) so a disk-fed run continues a "
                    "generator-fed one")
    ap.add_argument("--eval_objs", type=int, default=None,
                    help="val/test object count (default objs//4)")
    args = ap.parse_args(argv)

    if args.format == "srn":
        objs, views = args.objs or 15, args.views or 50
        size = args.size or 128
        n_eval = args.eval_objs or max(2, objs // 4)
        seed = 11 if args.seed is None else args.seed
        for stage, n in (("train", objs), ("val", n_eval), ("test", n_eval)):
            t = write_srn_layout(args.out, stage=stage, num_objs=n,
                                 num_views=views, size=size, seed=seed)
            print(f"srn {stage}: {len(t)} objs x {views} views @ {size}^2",
                  flush=True)
    elif args.format == "dtu":
        t = write_dtu_layout(args.out, num_scans=args.objs or 4,
                             num_views=args.views or 49,
                             hw=(args.size or 300, int((args.size or 300) * 4 / 3)))
        print(f"dtu: {len(t)} scans x {args.views or 49} views")
    else:
        t = write_nmr_layout(args.out, num_cats=2,
                             objs_per_cat=args.objs or 3,
                             num_views=args.views or 24,
                             size=args.size or 64)
        print(f"nmr: {len(t)} objs x {args.views or 24} views")


if __name__ == "__main__":
    main()
