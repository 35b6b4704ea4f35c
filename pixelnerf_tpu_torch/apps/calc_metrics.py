"""Offline metric map-reduce over rendered PNGs (counterpart of
``pixelnerf_tpu/apps/calc_metrics.py``).

Map: for every dataset object with a rendered output dir, compare rendered
``{view:06}.png`` frames against ground-truth images (per-object mean PSNR,
SSIM and, when weights are given, VGG-LPIPS) and write ``metrics.txt``.
Reduce: aggregate per category (names from the dataset's ``metadata.yaml``)
and in total, in the reference's report format (``all_metrics.txt``).

Flags: ``--viewlist/-L`` source-view exclusion (keyed ``cat/obj``),
``--primary/-P`` base excludes, ``--exclude_dtu_bad`` (the 15 DTU views
the reference leaves out), ``--eval_view_list``, ``--list_name`` split
filtering, ``--multicat`` with ``--metadata``, ``--dtu_sort``,
``--reduce_only/-R``, ``--overwrite``, ``--lpips_batch_size``,
``--override data.*``.

LPIPS is the port's module (``utils/lpips.py``), run on ``--device`` (the
GPU by default) in batches of ``--lpips_batch_size``; pass
``--lpips_weights`` a torch .pth holding either a whole
``lpips.LPIPS(net='vgg')`` state_dict or torchvision vgg16 weights merged
with the lin heads. Images are read by the port's PNG reader.
"""
from __future__ import annotations

import argparse
import json
import os
import os.path as osp
import sys

import numpy as np
import torch

from ..config.hocon import _parse_value
from ..utils import metrics, png

# the 15 corrupt/background-heavy DTU views the reference hardcodes
# (eval/calc_metrics.py:142-145)
DTU_BAD_VIEWS = [3, 4, 5, 6, 7, 16, 17, 18, 19, 20, 21, 36, 37, 38, 39]
METRIC_NAMES = ["psnr", "ssim", "lpips"]


def _is_image(path: str) -> bool:
    return osp.splitext(path)[1] in (".jpg", ".png")


def _load_lpips(args):
    if not args.lpips_weights:
        # the reference's totals include VGG-LPIPS (eval/calc_metrics.py:186);
        # omitting it silently would make results incomparable — be loud
        msg = (
            "WARNING: LPIPS is SKIPPED (no --lpips_weights). Reported totals "
            "omit the reference's third headline metric. Fetch weights with "
            "scripts/fetch_lpips_weights.py (needs network) and pass "
            "--lpips_weights <path>."
        )
        if args.require_lpips:
            raise SystemExit(
                "ERROR: --require_lpips set but no --lpips_weights given. " + msg
            )
        print(msg, file=sys.stderr)
        print(msg)
        return None
    from ..utils.lpips import LPIPS

    return LPIPS.from_torch_file(args.lpips_weights).to(torch.device(args.device))


def _lpips_mean(lp, preds, gts, batch_size):
    """The mean LPIPS of (pred, gt) pairs ([-1, 1] NHWC arrays), in batches."""
    dev = lp.shift.device
    dists = [
        lp(torch.from_numpy(np.stack(preds[i : i + batch_size])).to(dev),
           torch.from_numpy(np.stack(gts[i : i + batch_size])).to(dev)).cpu().numpy()
        for i in range(0, len(gts), batch_size)
    ]
    return float(np.concatenate(dists).mean())


def _collect_objects(args):
    """(gt_dir, render_dir) pairs, honoring multicat layout + split lists."""
    if args.dataset_format == "dvr":
        list_name, img_dir_name = args.list_name + ".lst", "image"
    elif args.dataset_format == "srn":
        list_name, img_dir_name = "", "rgb"
    else:
        return None, None  # adapter-based formats (synthetic, multi_obj)

    cats = sorted(os.listdir(args.datadir)) if args.multicat else ["."]
    all_objs, total = [], 0
    for cat in cats:
        cat_root = osp.join(args.datadir, cat)
        if not osp.isdir(cat_root):
            continue
        objs = sorted(os.listdir(cat_root))
        if list_name:
            list_path = osp.join(cat_root, list_name)
            if osp.exists(list_path):
                with open(list_path) as f:
                    split = {x.strip() for x in f}
                objs = [x for x in objs if x in split]
        pairs = []
        for obj in objs:
            gt_dir = osp.join(cat_root, obj)
            if not osp.isdir(gt_dir):
                continue
            name = f"{cat}_{obj}" if args.multicat else obj
            pairs.append((gt_dir, osp.join(args.output, name)))
        avail = [p for p in pairs if osp.exists(p[1])]
        print(cat, "TOTAL", len(pairs), "AVAILABLE", len(avail))
        total += len(pairs)
        all_objs.extend(avail)
    print(">>> USING", len(all_objs), "OF", total, "OBJECTS")
    return all_objs, img_dir_name


def run_map(args):
    lp = _load_lpips(args)
    all_objs, img_dir_name = _collect_objects(args)
    if all_objs is None:
        return run_map_dataset(args, lp)

    exclude_lut = None
    if args.viewlist:
        print("Excluding views from list", args.viewlist)
        with open(args.viewlist) as f:
            rows = [x.strip().split() for x in f]
        exclude_lut = {
            f"{r[0]}/{r[1]}": [int(v) for v in r[2:]] for r in rows
        }
    base_exclude = [int(v) for v in args.primary.split()]
    if args.exclude_dtu_bad:
        base_exclude.extend(DTU_BAD_VIEWS)
    eval_views = None
    if args.eval_view_list is not None:
        with open(args.eval_view_list) as f:
            eval_views = [int(v) for v in f.readline().split()]
        print("Only using views", eval_views)

    for gt_dir, rend_dir in all_objs:
        out_path = osp.join(rend_dir, "metrics.txt")
        if osp.exists(out_path) and not args.overwrite:
            continue
        im_root = osp.join(gt_dir, img_dir_name) if img_dir_name else gt_dir
        exclude_views = list(base_exclude)
        if exclude_lut is not None:
            exclude_views.extend(
                exclude_lut.get(osp.basename(rend_dir).replace("_", "/"), [])
            )

        psnr_avg = ssim_avg = 0.0
        gts, preds = [], []
        for im_name in sorted(os.listdir(im_root)):
            if not _is_image(im_name):
                continue
            view_id = int(osp.splitext(im_name)[0])
            rend_path = osp.join(rend_dir, f"{view_id:06}.png")
            if not osp.exists(rend_path) or view_id in exclude_views:
                continue
            if eval_views is not None and view_id not in eval_views:
                continue
            gt = png.imread(osp.join(im_root, im_name)).astype(np.float32)
            gt = gt[..., :3] / 255.0
            pred = png.imread(rend_path).astype(np.float32)[..., :3] / 255.0
            psnr_avg += metrics.psnr(pred, gt)
            ssim_avg += metrics.ssim(pred, gt, data_range=1.0)
            gts.append(gt * 2.0 - 1.0)
            preds.append(pred * 2.0 - 1.0)
        if not gts:
            continue
        n = len(gts)
        entry = {"psnr": psnr_avg / n, "ssim": ssim_avg / n}
        if lp is not None:
            entry["lpips"] = _lpips_mean(lp, preds, gts, args.lpips_batch_size)
        with open(out_path, "w") as f:
            f.write("\n".join(f"{k} {v}" for k, v in entry.items()))
        print(osp.basename(rend_dir), {k: round(v, 4) for k, v in entry.items()})


def run_map_dataset(args, lp):
    """Map over a dataset adapter for formats without the dvr/srn on-disk
    layout (synthetic fixtures, multi_obj): GT comes from the adapter's
    decoded images instead of raw files."""
    from ..data import get_split_dataset

    dset = get_split_dataset(
        args.dataset_format, args.datadir, want_split="test", training=False,
        **getattr(args, "data_kwargs", {}),
    )
    for obj_idx in range(len(dset)):
        data = dset[obj_idx]
        if not data:
            continue
        obj_name = osp.basename(data["path"])
        if args.multicat:
            obj_name = f"{osp.basename(osp.dirname(data['path']))}_{obj_name}"
        rend_dir = osp.join(args.output, obj_name)
        out_path = osp.join(rend_dir, "metrics.txt")
        if not osp.isdir(rend_dir) or (osp.exists(out_path) and not args.overwrite):
            continue
        psnr_avg = ssim_avg = 0.0
        gts, preds = [], []
        for view in range(data["images"].shape[0]):
            rend_path = osp.join(rend_dir, f"{view:06}.png")
            if not osp.exists(rend_path):
                continue
            gt = data["images"][view] * 0.5 + 0.5
            pred = png.imread(rend_path).astype(np.float32)[..., :3] / 255.0
            psnr_avg += metrics.psnr(pred, gt)
            ssim_avg += metrics.ssim(pred, gt, data_range=1.0)
            gts.append(np.asarray(gt * 2.0 - 1.0, np.float32))
            preds.append(pred * 2.0 - 1.0)
        if not gts:
            continue
        n = len(gts)
        entry = {"psnr": psnr_avg / n, "ssim": ssim_avg / n}
        if lp is not None:
            entry["lpips"] = _lpips_mean(lp, preds, gts, args.lpips_batch_size)
        with open(out_path, "w") as f:
            f.write("\n".join(f"{k} {v}" for k, v in entry.items()))
        print(obj_name, {k: round(v, 4) for k, v in entry.items()})


def run_reduce(args):
    cats = cat_description = None
    if args.multicat:
        # NMR-style metadata.yaml is JSON-compatible; the reference reads it
        # with json.load too (eval/calc_metrics.py:259)
        with open(osp.join(args.datadir, args.metadata)) as f:
            meta = json.load(f)
        cats = sorted(meta.keys())
        cat_description = {c: meta[c]["name"].split(",")[0] for c in cats}

    objs = [
        osp.join(args.output, x)
        for x in os.listdir(args.output)
        if x[0] != "_" and osp.isdir(osp.join(args.output, x))
    ]
    if args.dtu_sort:
        objs.sort(key=lambda x: int(osp.basename(x)[4:]))  # 'scanNNN' order
    else:
        objs.sort()
    print(">>> PROCESSING", len(objs), "OBJECTS")

    all_metrics = {n: 0.0 for n in METRIC_NAMES}
    counts = {n: 0 for n in METRIC_NAMES}
    cat_sz = {c: 0 for c in cats} if cats else {}
    if cats:
        for c in cats:
            for n in METRIC_NAMES:
                all_metrics[f"{c}.{n}"] = 0.0
    print_objs = len(objs) < 100

    n_objs = 0
    for obj_root in objs:
        metrics_path = osp.join(obj_root, "metrics.txt")
        if not osp.exists(metrics_path):
            continue
        n_objs += 1
        with open(metrics_path) as f:
            rows = [line.split() for line in f if line.strip()]
        # keep only known metric lines: metrics.txt may carry extra
        # bookkeeping rows (e.g. an 'n <count>' line from older writers)
        rows = [r for r in rows if r[0] in METRIC_NAMES]
        if cats:
            cat_name = osp.basename(obj_root).split("_")[0]
            if cat_name in cat_sz:
                cat_sz[cat_name] += 1
                for metric, val in rows:
                    all_metrics[f"{cat_name}.{metric}"] += float(val)
        for metric, val in rows:
            all_metrics[metric] += float(val)
            counts[metric] += 1
        if print_objs:
            print(obj_root, " ".join(v for _, v in rows))

    if n_objs == 0:
        print("No results found")
        return
    have = [n for n in METRIC_NAMES if counts[n] > 0]
    for name in have:
        if cats:
            for c in cats:
                if cat_sz[c] > 0:
                    all_metrics[f"{c}.{name}"] /= cat_sz[c]
        all_metrics[name] /= counts[name]
        print(name, all_metrics[name])

    lines = []
    if cats:
        for c in cats:
            if cat_sz[c] > 0:
                row = "{:12s}".format(cat_description[c])
                row += "".join(
                    " {}: {:.6f}".format(n, all_metrics[f"{c}.{n}"]) for n in have
                )
                lines.append(row + f" n_inst: {cat_sz[c]}")
        total_row = "---\n{:12s}".format("total")
    else:
        total_row = ""
    total_row += "".join(" {}: {:.6f}".format(n, all_metrics[n]) for n in have)
    lines.append(total_row)
    text = "\n".join(lines)
    out_path = osp.join(args.output, "all_metrics.txt")
    with open(out_path, "w") as f:
        f.write(text)
    print("WROTE", out_path)
    print(text)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--datadir", "-D", type=str, required=True)
    parser.add_argument("--output", "-O", type=str, default="eval")
    parser.add_argument("--dataset_format", "-F", type=str, default="dvr")
    parser.add_argument("--list_name", type=str, default="softras_test")
    parser.add_argument("--overwrite", action="store_true")
    parser.add_argument("--exclude_dtu_bad", action="store_true")
    parser.add_argument("--multicat", action="store_true")
    parser.add_argument("--viewlist", "-L", type=str, default="")
    parser.add_argument("--eval_view_list", type=str, default=None)
    parser.add_argument("--primary", "-P", type=str, default="")
    parser.add_argument("--lpips_batch_size", type=int, default=32)
    parser.add_argument("--lpips_weights", type=str, default=None,
                        help="torch .pth with lpips VGG weights")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device LPIPS runs on; the CPU only when asked for")
    parser.add_argument("--require_lpips", action="store_true",
                        help="error out instead of skipping LPIPS when no "
                             "weights are given")
    parser.add_argument("--reduce_only", "-R", action="store_true")
    parser.add_argument("--metadata", type=str, default="metadata.yaml")
    parser.add_argument("--dtu_sort", action="store_true")
    parser.add_argument(
        "--override", action="append", default=[], metavar="KEY=VALUE",
        help="data.* overrides forwarded to the dataset adapter "
        "(e.g. data.num_objects=2048); other keys are rejected since this "
        "app has no model/renderer config",
    )
    args = parser.parse_args(argv)

    args.data_kwargs = {}
    for ov in args.override:
        key, _, val = ov.partition("=")
        if not key.startswith("data.") or not _:
            parser.error(f"--override {ov}: only data.KEY=VALUE is accepted")
        args.data_kwargs[key[len("data."):]] = _parse_value(val)
    if not args.reduce_only:
        print(">>> Compute")
        run_map(args)
    print(">>> Reduce")
    run_reduce(args)


if __name__ == "__main__":
    main()
