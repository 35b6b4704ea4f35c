"""Training CLI (counterpart of ``pixelnerf_tpu/apps/train.py``).

    python -m pixelnerf_tpu_torch.apps.train -c conf/exp/srn.conf -F synthetic \
        --epochs 2 --epoch_batches 50 [--train_ray_chunk 256 --train_remat features]

Runs on the GPU (``--device cuda``, the default) unless asked for the CPU.
Only the synthetic scenes are ported as a dataset so far.
"""
from __future__ import annotations

import os

import torch

from ..config import ConfigNode
from ..data import RayBatchPipeline, dataset_kwargs_from_conf, get_split_dataset
from ..models import make_model
from ..render.renderer import RenderConfig, RenderSchedule
from ..train.trainer import Trainer
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
                        choices=["true", "false", "features"],
                        help="what the chunked train render recomputes in the "
                        "backward: true=the whole chunk, false=nothing, "
                        "features=only the MLPs (the gathered features are kept)")
    parser.add_argument("--workers", type=int, default=4,
                        help="dataset-loading threads in the input pipeline")
    parser.add_argument("--seed", type=int, default=0)


def main(argv=None):
    args, conf = parse_args(extra_args, default_ray_batch_size=128, argv=argv)
    views = tuple(int(v) for v in args.nviews.split())
    device = torch.device(args.device)

    dset_kwargs = dataset_kwargs_from_conf(conf)
    train_dset = get_split_dataset(args.dataset_format, args.datadir, want_split="train", **dset_kwargs)
    test_dset = get_split_dataset(args.dataset_format, args.datadir, want_split="val", **dset_kwargs)

    net = make_model(
        conf["model"], device=device, generator=torch.Generator().manual_seed(args.seed),
        stop_encoder_grad=args.freeze_enc,
    )
    render_cfg = RenderConfig.from_conf(conf.get_config("renderer", ConfigNode()))
    train_pipe = RayBatchPipeline(
        train_dset, batch_size=args.batch_size, rays_per_object=args.ray_batch_size,
        views=views, no_bbox_step=args.no_bbox_step, seed=args.seed, workers=args.workers,
    )
    test_pipe = None
    if len(test_dset) > 0:
        test_pipe = RayBatchPipeline(
            test_dset, batch_size=args.batch_size, rays_per_object=args.ray_batch_size,
            views=views, no_bbox_step=args.no_bbox_step,
            # --fixed_test: deterministic source views for the held-out batches
            fixed_source_views=list(range(max(views))) if args.fixed_test else None,
            seed=args.seed + 1,
        )
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
        log_dir=os.path.join(args.logs_path, args.name),
        lr=args.lr,
        gamma=args.gamma,
        num_epochs=args.epochs,
        epoch_batches=args.epoch_batches,
        train_encoder=not args.freeze_enc,
        resume=args.resume,
        render_schedule=RenderSchedule.from_conf(conf.get_config("renderer", ConfigNode()), render_cfg),
        train_ray_chunk=args.train_ray_chunk,
        train_remat={"true": True, "false": False}.get(args.train_remat, args.train_remat),
        seed=args.seed,
    )
    trainer.start()
    return trainer


if __name__ == "__main__":
    main()
