"""Training CLI (counterpart of ``pixelnerf_tpu/apps/train.py``).

    python -m pixelnerf_tpu_torch.apps.train -c conf/exp/srn.conf -F synthetic \
        --epochs 2 --epoch_batches 50 [--train_ray_chunk 256 --train_remat features] \
        [--profile_dir prof/]

Runs on the GPU (``--device cuda``, the default) unless asked for the CPU.
Datasets: ``-F srn`` (``-D <data>/cars``), ``-F dvr|dvr_gen`` (NMR
ShapeNet), ``-F dvr_dtu`` (DTU, ``-V 3``), ``-F multi_obj`` and
``-F synthetic``.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..config import ConfigNode
from ..data import RayBatchPipeline, dataset_kwargs_from_conf, get_split_dataset
from ..eval.common import FullRenderer, depth_cmap
from ..models import load_pretrained_encoder, make_model
from ..render.renderer import RenderConfig, RenderSchedule
from ..train.trainer import Trainer
from ..utils import geometry, metrics
from ..utils.profiling import trace
from .args import parse_args


def extra_args(parser):
    parser.add_argument("--batch_size", "-B", type=int, default=4)
    parser.add_argument("--nviews", "-V", type=str, default="1",
                        help="source view counts, e.g. '1' or '1 2'")
    parser.add_argument("--freeze_enc", action="store_true")
    parser.add_argument("--no_bbox_step", type=int, default=100000)
    parser.add_argument("--fixed_test", action="store_true")
    parser.add_argument("--lr", type=float, default=1e-4)
    parser.add_argument("--gamma", type=float, default=1.0)
    parser.add_argument("--epoch_batches", type=int, default=1000)
    parser.add_argument("--train_ray_chunk", type=int, default=None,
                        help="render the train batch in chunks of this many rays "
                        "per object (bounds memory at large -R)")
    parser.add_argument("--train_remat", type=str, default="true",
                        choices=["true", "false", "dots", "features"],
                        help="what the chunked train render recomputes in the "
                        "backward: true=the whole chunk, false=nothing, "
                        "dots=all but the matrix products' outputs, "
                        "features=only the MLPs (the gathered features are kept)")
    parser.add_argument("--workers", type=int, default=4,
                        help="dataset-loading threads in the input pipeline")
    parser.add_argument("--pretrained_encoder", type=str, default=None,
                        help="torchvision resnet state_dict (.pth) to initialize the "
                        "spatial encoder from ImageNet weights, as the reference does")
    parser.add_argument("--seed", type=int, default=0)


# rays per chunk of the visual's full-frame render: with its weights, the
# memory high-water mark of a training run
VIS_RAY_CHUNK = 1024


def make_vis_step(net, vis_dset, render_cfg, views):
    """The trainer's visual: one full novel view of a seeded object of
    ``vis_dset`` from its first source views, one row per pass with the
    columns [source | gt | depth colormap | rgb | alpha], and its PSNR
    (the fine pass's where there is one)."""
    vis_renderer = FullRenderer(net, render_cfg, ray_chunk=VIS_RAY_CHUNK, want_weights=True)

    def vis_step(generator, epoch, batch_idx):
        d = vis_dset[int(np.random.default_rng(epoch * 1000 + batch_idx).integers(len(vis_dset)))]
        if not d:
            return None, {}
        dev = next(net.parameters()).device
        NV = d["images"].shape[0]
        src = list(range(min(views[-1], NV - 1)))
        target = NV - 1
        H, W = d["images"].shape[1:3]
        # a per-object (fx, fy) focal vector gets the batch dim encode expects
        focal = np.asarray(d["focal"], np.float32)
        if focal.ndim == 1:
            focal = focal[None]
        with torch.inference_mode():
            enc = net.encode(
                torch.from_numpy(d["images"][None, src]).to(dev),
                torch.from_numpy(d["poses"][None, src]).to(dev),
                torch.from_numpy(focal),
                c=torch.from_numpy(d.get("c", np.array([W / 2, H / 2], np.float32))[None]),
            )
        rays = geometry.gen_rays(
            d["poses"][target : target + 1], W, H, d["focal"], vis_dset.z_near, vis_dset.z_far,
            c=d.get("c"), device=dev,
        )[0]
        out = vis_renderer(enc, rays.reshape(-1, 8), generator)
        gt = d["images"][target] * 0.5 + 0.5
        src_img = d["images"][src[0]] * 0.5 + 0.5

        rows = []
        psnr = None
        for phase in ("coarse", "fine"):
            if phase not in out:
                continue
            rgb = np.clip(out[phase]["rgb"].reshape(H, W, 3).cpu().numpy(), 0, 1)
            depth = out[phase]["depth"].reshape(H, W).cpu().numpy()
            alpha = out[phase]["weights"].sum(-1).reshape(H, W).cpu().numpy()
            rows.append(np.concatenate(
                [src_img, gt, depth_cmap(depth, vis_dset.z_near, vis_dset.z_far), rgb,
                 np.repeat(np.clip(alpha, 0, 1)[..., None], 3, -1)],
                axis=1,
            ))
            psnr = metrics.psnr(rgb, gt)  # fine overwrites coarse
        vis = np.concatenate(rows, axis=0)
        print(f"*** vis psnr {psnr:.2f}")
        return vis, {"psnr": psnr}

    return vis_step


def main(argv=None):
    args, conf = parse_args(extra_args, default_ray_batch_size=128, argv=argv)
    views = tuple(int(v) for v in args.nviews.split())
    device = torch.device(args.device)

    dset_kwargs = dataset_kwargs_from_conf(conf)
    train_dset = get_split_dataset(args.dataset_format, args.datadir, want_split="train", **dset_kwargs)
    try:
        test_dset = get_split_dataset(args.dataset_format, args.datadir, want_split="val", training=False,
                                      **dset_kwargs)
    except FileNotFoundError:   # no held-out split on disk: train without eval
        test_dset = None
    has_test = test_dset is not None and len(test_dset) > 0

    net = make_model(
        conf["model"], device=device, generator=torch.Generator().manual_seed(args.seed),
        stop_encoder_grad=args.freeze_enc,
    )
    render_cfg = RenderConfig.from_conf(conf.get_config("renderer", ConfigNode()),
                                        lindisp=getattr(train_dset, "lindisp", False))
    train_pipe = RayBatchPipeline(
        train_dset, batch_size=args.batch_size, rays_per_object=args.ray_batch_size,
        views=views, no_bbox_step=args.no_bbox_step, seed=args.seed, workers=args.workers,
    )
    test_pipe = None
    if has_test:
        test_pipe = RayBatchPipeline(
            test_dset, batch_size=args.batch_size, rays_per_object=args.ray_batch_size,
            views=views, no_bbox_step=args.no_bbox_step,
            # --fixed_test: deterministic source views for the held-out batches
            fixed_source_views=list(range(max(views))) if args.fixed_test else None,
            seed=args.seed + 1,
        )
    if args.pretrained_encoder:
        # resume (inside Trainer) still wins over this warm start
        load_pretrained_encoder(net, torch.load(args.pretrained_encoder, map_location=device, weights_only=True))
        print(f"Encoder initialized from {args.pretrained_encoder}")
    n_params = sum(p.numel() for p in net.parameters())
    print(f"Model parameters: {n_params / 1e6:.2f}M; d_in={net.d_in} device={device}")

    trainer = Trainer(
        net=net,
        train_pipeline=train_pipe,
        test_pipeline=test_pipe,
        render_cfg=render_cfg,
        conf=conf,
        name=args.name,
        ckpt_dir=os.path.join(args.checkpoints_path, args.name),
        visual_dir=os.path.join(args.visual_path, args.name),
        log_dir=os.path.join(args.logs_path, args.name),
        lr=args.lr,
        gamma=args.gamma,
        num_epochs=args.epochs,
        epoch_batches=args.epoch_batches,
        train_encoder=not args.freeze_enc,
        resume=args.resume,
        vis_fn=make_vis_step(net, test_dset if has_test else train_dset, render_cfg, views),
        render_schedule=RenderSchedule.from_conf(conf.get_config("renderer", ConfigNode()), render_cfg),
        train_ray_chunk=args.train_ray_chunk,
        train_remat={"true": True, "false": False}.get(args.train_remat, args.train_remat),
        seed=args.seed,
    )
    with trace(args.profile_dir):
        trainer.start()
    return trainer


if __name__ == "__main__":
    main()
