"""Full evaluation sweep (counterpart of ``pixelnerf_tpu/apps/eval.py``).

Per test object: encode fixed (-P) or viewlist (-L) source views, render
every other view, write PNGs, accumulate PSNR/SSIM, and append to an
append-only ``finish.txt``, so an interrupted sweep resumes where it
stopped. Runs on the GPU (``--device cuda``, the default) unless asked for
the CPU.

    python -m pixelnerf_tpu_torch.apps.eval -n srn_car -D <data>/cars -F srn -P "64" -O eval_out
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from ..config import ConfigNode
from ..data import dataset_kwargs_from_conf, get_split_dataset
from ..eval.common import FullRenderer, depth_cmap, resize_area_like_cv2
from ..models import coarse_only, load_reference_state_dict, make_model
from ..render.renderer import RenderConfig
from ..train.state import load_variables
from ..utils import geometry, metrics, png
from ..utils.exr import write_exr
from .args import parse_args


def extra_args(parser):
    parser.add_argument("--split", type=str, default="test")
    parser.add_argument("--source", "-P", type=str, default="64",
                        help="space-separated source view ids")
    parser.add_argument("--viewlist", "-L", type=str, default="",
                        help="path to per-object source-view list file")
    parser.add_argument("--include_src", action="store_true")
    parser.add_argument("--multicat", action="store_true")
    parser.add_argument("--output", "-O", type=str, default="eval_out")
    parser.add_argument("--write_depth", action="store_true")
    parser.add_argument("--write_compare", action="store_true",
                        help="also write side-by-side [gt | render] images")
    parser.add_argument("--coarse", action="store_true",
                        help="render coarse-only with a 64/128 sample hierarchy")
    parser.add_argument("--limit", type=int, default=None,
                        help="evaluate at most N objects (smoke runs)")
    parser.add_argument("--eval_view_list", type=str, default=None,
                        help="file whose first line lists the target view ids to evaluate")
    parser.add_argument("--no_compare_gt", action="store_true",
                        help="skip GT comparison (no metrics), only render")
    parser.add_argument("--scale", type=float, default=1.0,
                        help="render scale relative to input size")
    parser.add_argument("--free_pose", action="store_true",
                        help="accepted for reference-CLI compatibility; rays are "
                        "regenerated per object, so varying poses are always handled")
    parser.add_argument("--seed", type=int, default=0)


def load_net_and_state(args, conf, device):
    """Build the model on ``device`` and restore it from the port's
    checkpoint, else from a reference ``pixel_nerf_latest`` state_dict,
    else keep the random init (with a warning)."""
    net = make_model(conf["model"], device=device, generator=torch.Generator().manual_seed(0))
    ckpt_dir = os.path.join(args.checkpoints_path, args.name)
    restored = load_variables(ckpt_dir, device)
    if restored is not None:
        net.load_state_dict(restored["model"])
        print(f"Loaded checkpoint at step {restored['step']} from {ckpt_dir}")
        return net
    torch_path = os.path.join(ckpt_dir, "pixel_nerf_latest")
    if os.path.exists(torch_path):
        load_reference_state_dict(net, torch.load(torch_path, map_location=device, weights_only=True))
        print(f"Loaded reference torch checkpoint {torch_path}")
        return net
    print("WARNING: no checkpoint found; evaluating a random-init model")
    return net


def eval_render_config(conf, dset, coarse: bool) -> RenderConfig:
    """The renderer of the eval apps: at least 64 coarse samples, and with
    ``coarse`` the 64/128 hierarchy (both passes through the coarse MLP)."""
    if getattr(dset, "lindisp", False):
        raise NotImplementedError("lindisp sampling is not ported yet")
    cfg = RenderConfig.from_conf(conf.get_config("renderer", ConfigNode()))
    if cfg.n_coarse < 64:
        cfg = dataclasses.replace(cfg, n_coarse=64)
    if coarse:
        cfg = dataclasses.replace(cfg, n_coarse=64, n_fine=128)
    return cfg


def render_object(renderer, data, src, target_views, z_near, z_far, scale=1.0, generator=None, noise=None):
    """Encode one object's source views and render its target views at
    ``scale`` of the input size (focal and principal point scale with it).

    :param renderer: a ``FullRenderer`` of the model
    :param data: the dataset's item (numpy arrays, NHWC)
    :param noise: one pre-drawn noise dict per ray chunk, or None to draw
        from ``generator``
    :return: (rgb (T, rH, rW, 3), depth (T, rH, rW)) float32 tensors on the
        model's device
    """
    net = renderer.net
    dev = next(net.parameters()).device
    H, W = data["images"].shape[1:3]
    rH, rW = int(round(H * scale)), int(round(W * scale))
    c_arr = data.get("c", np.array([W / 2.0, H / 2.0], np.float32))
    with torch.inference_mode():
        enc = net.encode(
            torch.from_numpy(data["images"][None, src]).to(dev),
            torch.from_numpy(data["poses"][None, src]).to(dev),
            torch.as_tensor(data["focal"]),
            c=torch.as_tensor(c_arr[None]),
        )
    rays = geometry.gen_rays(
        data["poses"][target_views], rW, rH, data["focal"] * scale, z_near, z_far,
        c=c_arr * scale, device=dev,
    ).reshape(-1, 8)
    out = renderer(enc, rays, generator, noise)
    branch = out["fine"] if renderer.cfg.using_fine else out["coarse"]
    return (branch["rgb"].reshape(len(target_views), rH, rW, 3),
            branch["depth"].reshape(len(target_views), rH, rW))


def main(argv=None):
    args, conf = parse_args(extra_args, argv=argv)
    device = torch.device(args.device)
    dset = get_split_dataset(
        args.dataset_format, args.datadir, want_split=args.split, training=False,
        **dataset_kwargs_from_conf(conf),
    )
    cfg = eval_render_config(conf, dset, args.coarse)

    source = np.array([int(x) for x in args.source.split()])
    viewlist = {}
    if args.viewlist:
        with open(args.viewlist, "r") as f:
            for line in f:
                parts = line.strip().split()
                if len(parts) >= 3:
                    viewlist[(parts[0], parts[1])] = [int(x) for x in parts[2:]]

    d0 = dset[0]
    H, W = d0["images"].shape[1:3]

    net = load_net_and_state(args, conf, device)
    if args.coarse:
        net = coarse_only(net)  # the fine pass reuses the coarse MLP
    renderer = FullRenderer(net, cfg, ray_chunk=args.ray_batch_size)

    os.makedirs(args.output, exist_ok=True)
    finish_path = os.path.join(args.output, "finish.txt")
    finished = {}
    if os.path.exists(finish_path):
        with open(finish_path, "r") as f:
            for line in f:
                parts = line.split()
                if len(parts) == 4:
                    finished[parts[0]] = (float(parts[1]), float(parts[2]), int(parts[3]))
    finish_file = open(finish_path, "a", buffering=1)

    total_psnr = sum(v[0] * v[2] for v in finished.values())
    total_ssim = sum(v[1] * v[2] for v in finished.values())
    cnt = sum(v[2] for v in finished.values())

    # optional target-view subset: the file's first line lists the view ids
    eval_views = None
    if args.eval_view_list:
        with open(args.eval_view_list, "r") as f:
            eval_views = {int(x) for x in f.readline().split()}

    generator = torch.Generator(device=device).manual_seed(args.seed)
    n_objs = len(dset) if args.limit is None else min(args.limit, len(dset))
    for obj_idx in range(n_objs):
        data = dset[obj_idx]
        if not data:
            continue
        if args.multicat:
            cat = os.path.basename(os.path.dirname(data["path"]))
            obj_name = f"{cat}_{os.path.basename(data['path'])}"
        else:
            obj_name = os.path.basename(data["path"])
        if obj_name in finished:
            continue

        NV = data["images"].shape[0]
        key = (os.path.basename(os.path.dirname(data["path"])), os.path.basename(data["path"]))
        src = np.array(viewlist[key]) if key in viewlist else source
        src = src[src < NV]
        target_views = (
            np.arange(NV)
            if args.include_src
            else np.array([v for v in range(NV) if v not in set(src.tolist())])
        )
        if eval_views is not None:
            target_views = np.array([v for v in target_views if v in eval_views])
            if target_views.size == 0:
                print(f"skip {obj_name}: no target views in eval_view_list")
                continue

        rgb_all, depth_all = render_object(
            renderer, data, src, target_views, dset.z_near, dset.z_far, args.scale, generator
        )
        rgb_all, depth_all = rgb_all.cpu().numpy(), depth_all.cpu().numpy()
        rH, rW = rgb_all.shape[1:3]

        obj_dir = os.path.join(args.output, obj_name)
        os.makedirs(obj_dir, exist_ok=True)
        obj_psnr = obj_ssim = 0.0
        for ti, view in enumerate(target_views):
            pred = np.clip(rgb_all[ti], 0, 1)
            gt = data["images"][view] * 0.5 + 0.5
            if args.scale != 1.0:
                gt = np.clip(resize_area_like_cv2(gt, rH, rW), 0.0, 1.0)
            if not args.no_compare_gt:
                obj_psnr += metrics.psnr(pred, gt)
                obj_ssim += metrics.ssim(pred, gt, data_range=1.0)
            png.imwrite(os.path.join(obj_dir, f"{view:06d}.png"), (pred * 255).astype(np.uint8))
            if args.write_compare:
                compare = np.concatenate([gt, pred], axis=1)
                png.imwrite(
                    os.path.join(obj_dir, f"{view:06d}_compare.png"),
                    (np.clip(compare, 0, 1) * 255).astype(np.uint8),
                )
            if args.write_depth:
                # normalized depth EXR + colormapped PNG
                depth_norm = (depth_all[ti] - dset.z_near) / (dset.z_far - dset.z_near)
                write_exr(os.path.join(obj_dir, f"{view:06d}_depth.exr"), np.asarray(depth_norm, np.float32))
                png.imwrite(
                    os.path.join(obj_dir, f"{view:06d}_depth_norm.png"),
                    (depth_cmap(depth_all[ti], dset.z_near, dset.z_far) * 255).astype(np.uint8),
                )
        n = len(target_views)
        obj_psnr /= n
        obj_ssim /= n
        total_psnr += obj_psnr * n
        total_ssim += obj_ssim * n
        cnt += n
        print(
            f"[{obj_idx+1}/{n_objs}] {obj_name} psnr {obj_psnr:.3f} ssim {obj_ssim:.4f}"
            f" | running psnr {total_psnr/cnt:.3f} ssim {total_ssim/cnt:.4f}"
        )
        finish_file.write(f"{obj_name} {obj_psnr} {obj_ssim} {n}\n")
    finish_file.close()
    if cnt:
        print(f"FINAL psnr {total_psnr/cnt:.4f} ssim {total_ssim/cnt:.4f} over {cnt} views")


if __name__ == "__main__":
    main()
