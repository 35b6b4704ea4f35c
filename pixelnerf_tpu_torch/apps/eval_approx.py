"""Fast approximate evaluation (counterpart of
``pixelnerf_tpu/apps/eval_approx.py``): one random seeded target view per
object, ``-B`` objects encoded and rendered together (one SB-object
encoding, whose latents kernel A reads as one table). Runs on the GPU
(``--device cuda``, the default) unless asked for the CPU.

    python -m pixelnerf_tpu_torch.apps.eval_approx -n srn_car -D <data>/cars -F srn -P 64
"""
from __future__ import annotations

import numpy as np
import torch

from ..data import dataset_kwargs_from_conf, get_split_dataset
from ..eval.common import FullRenderer
from ..models import coarse_only
from ..utils import geometry, metrics
from .args import parse_args
from .eval import eval_render_config, load_net_and_state


def extra_args(parser):
    parser.add_argument("--split", type=str, default="test")
    parser.add_argument("--source", "-P", type=str, default="64")
    parser.add_argument("--seed", type=int, default=1234)
    parser.add_argument("--limit", type=int, default=None)
    parser.add_argument("--batch_size", "-B", type=int, default=4,
                        help="objects rendered per batch (the reference evaluates SB=4 objects at once)")
    parser.add_argument("--coarse", action="store_true",
                        help="coarse network as fine: drop the fine MLP, keep a 64/128 hierarchy")


def pick_targets(dset, source, n_objs, seed):
    """(data, src, target, c) per valid object, with the seeded per-object
    target choice (``np.random.default_rng(seed)``) drawn in dataset order."""
    rng_np = np.random.default_rng(seed)
    for obj_idx in range(n_objs):
        data = dset[obj_idx]
        if not data:
            continue
        NV, H, W = data["images"].shape[:3]
        src = source[source < NV]
        if len(src) == 0:
            raise SystemExit(
                f"source view(s) {source.tolist()} out of range for object with {NV} views — "
                "pass e.g. -P 0 (the default -P 64 matches the reference's 251-view SRN layout)"
            )
        if len(src) < len(source):
            print(
                f"WARNING: dropping out-of-range source view(s) "
                f"{sorted(set(source.tolist()) - set(src.tolist()))} (object has {NV} views) — "
                f"conditioning on {len(src)} view(s), not {len(source)}"
            )
        choices = [v for v in range(NV) if v not in set(src.tolist())]
        target = int(rng_np.choice(choices))
        c_arr = data.get("c", np.array([W / 2.0, H / 2.0], np.float32))
        yield data, src, target, c_arr


def render_group(renderer, group, z_near, z_far, generator=None, noise=None):
    """Encode a group of objects as one SB-object batch and render each
    one's target view: -> rgb (SB, H, W, 3) on the model's device."""
    net = renderer.net
    dev = next(net.parameters()).device
    H, W = group[0][0]["images"].shape[1:3]
    images = torch.from_numpy(np.stack([d["images"][s] for d, s, _, _ in group])).to(dev)
    poses = torch.from_numpy(np.stack([d["poses"][s] for d, s, _, _ in group])).to(dev)
    focal = torch.from_numpy(np.stack([
        np.broadcast_to(np.atleast_1d(np.asarray(d["focal"], np.float32)), (2,)) for d, _, _, _ in group
    ]))
    c = torch.from_numpy(np.stack([ca for _, _, _, ca in group]))
    with torch.inference_mode():
        enc = net.encode(images, poses, focal, c=c)
    rays = torch.stack([
        geometry.gen_rays(d["poses"][t : t + 1], W, H, d["focal"], z_near, z_far, c=ca, device=dev)[0].reshape(-1, 8)
        for d, _, t, ca in group
    ])                                                                     # (SB, H*W, 8)
    out = renderer.render_batch(enc, rays, generator, noise)
    branch = out["fine"] if renderer.cfg.using_fine else out["coarse"]
    return branch["rgb"].reshape(len(group), H, W, 3)


def main(argv=None):
    args, conf = parse_args(extra_args, argv=argv)
    device = torch.device(args.device)
    dset = get_split_dataset(
        args.dataset_format, args.datadir, want_split=args.split, training=False,
        **dataset_kwargs_from_conf(conf),
    )
    cfg = eval_render_config(conf, dset, args.coarse)
    source = np.array([int(x) for x in args.source.split()])

    net = load_net_and_state(args, conf, device)
    if args.coarse:
        net = coarse_only(net)  # the fine pass reuses the coarse MLP
    renderer = FullRenderer(net, cfg, ray_chunk=args.ray_batch_size)

    generator = torch.Generator(device=device).manual_seed(args.seed)
    total_psnr = total_ssim = 0.0
    cnt = 0
    n_objs = len(dset) if args.limit is None else min(args.limit, len(dset))
    entries = list(pick_targets(dset, source, n_objs, args.seed))
    for gi in range(0, len(entries), args.batch_size):
        group = entries[gi : gi + args.batch_size]
        rgbs = render_group(renderer, group, dset.z_near, dset.z_far, generator).cpu().numpy()
        for k, (d, _, t, _) in enumerate(group):
            rgb = np.clip(rgbs[k], 0, 1)
            gt = d["images"][t] * 0.5 + 0.5
            p = metrics.psnr(rgb, gt)
            s = metrics.ssim(rgb, gt, data_range=1.0)
            total_psnr += p
            total_ssim += s
            cnt += 1
            print(f"[{cnt}/{len(entries)}] psnr {p:.3f} ssim {s:.4f} "
                  f"| running {total_psnr/cnt:.3f} / {total_ssim/cnt:.4f}")
    if cnt:
        print(f"APPROX FINAL psnr {total_psnr/cnt:.4f} ssim {total_ssim/cnt:.4f}")
        return total_psnr / cnt, total_ssim / cnt


if __name__ == "__main__":
    main()
