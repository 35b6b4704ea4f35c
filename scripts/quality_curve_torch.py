#!/usr/bin/env python
"""Evaluate a series of the PyTorch port's checkpoint snapshots into a
quality curve (counterpart of ``scripts/quality_curve.py``).

The port's trainer overwrites ``train_state.pt`` in place;
``scripts/snapshot_watcher_torch.py`` (or ``cp train_state.pt
train_state_step<N>.pt``) keeps the trajectory. This script runs the
port's seeded batched evaluator (``pixelnerf_tpu_torch.apps.eval_approx``:
PSNR/SSIM on unseen split objects) on every snapshot, each copied alone
into a temporary checkpoint directory, and prints one JSON line per point:
the PSNR-vs-steps curve that tells learning from memorization. Every other
flag (``-c``, ``-F``, ``-D``, ``--device``, ``--cpu``, ...) is passed to
the evaluator.

    python scripts/quality_curve_torch.py -n srn_car -c conf/exp/srn.conf \
        -F srn -D <data>/cars -P 64 --split test --limit 16 -B 4

Snapshots are ``checkpoints/<name>/train_state_step*.pt`` and the live
``train_state.pt`` (labelled by the step stored in it).
"""
from __future__ import annotations

import argparse
import glob
import io
import json
import os
import re
import shutil
import sys
import tempfile
from contextlib import redirect_stdout

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pixelnerf_tpu_torch.train.state import CKPT_NAME  # noqa: E402


def find_snapshots(ckdir: str):
    """[(step or None, path)]: the step-tagged snapshots by the step in
    their name, the live file with None (its step is read later)."""
    stem, ext = os.path.splitext(CKPT_NAME)
    snaps = []
    for path in glob.glob(os.path.join(ckdir, f"{stem}_step*{ext}")):
        m = re.search(rf"_step(\d+){re.escape(ext)}$", path)
        if m:
            snaps.append((int(m.group(1)), path))
    live = os.path.join(ckdir, CKPT_NAME)
    if os.path.isfile(live):
        snaps.append((None, live))
    return snaps


def resolve_steps(snaps):
    """Label the live checkpoint by its stored step (None when it cannot be
    read) and sort by step, unlabelled last."""
    import torch

    resolved = []
    for step, path in snaps:
        if step is None:
            try:
                step = int(torch.load(path, map_location="cpu", weights_only=True)["step"])
            except Exception:
                pass  # unreadable state: keep the null label
        resolved.append((step, path))
    resolved.sort(key=lambda s: (s[0] is None, s[0]))
    return resolved


def main(argv=None):
    ap = argparse.ArgumentParser(description="PSNR/SSIM curve over checkpoint snapshots", allow_abbrev=False)
    ap.add_argument("--name", "-n", required=True)
    ap.add_argument("--checkpoints_path", default="checkpoints")
    ap.add_argument("--steps", default=None, help="comma-separated step subset (default: all snapshots)")
    args, passthrough = ap.parse_known_args(argv)

    ckdir = os.path.join(args.checkpoints_path, args.name)
    snaps = find_snapshots(ckdir)
    if not snaps:
        raise SystemExit(f"no snapshots under {ckdir}")
    want = {int(s) for s in args.steps.split(",")} if args.steps else None

    from pixelnerf_tpu_torch.apps.eval_approx import main as eval_approx_main

    curve = []
    for step, path in resolve_steps(snaps):
        if want is not None and (step is None or step not in want):
            continue
        with tempfile.TemporaryDirectory() as tmp:
            os.makedirs(os.path.join(tmp, args.name))
            shutil.copy(path, os.path.join(tmp, args.name, CKPT_NAME))
            buf = io.StringIO()
            with redirect_stdout(buf):
                res = eval_approx_main(["-n", args.name, "--checkpoints_path", tmp] + passthrough)
        point = {
            "step": step,
            "file": os.path.basename(path),
            "psnr": round(float(res[0]), 4) if res else None,
            "ssim": round(float(res[1]), 4) if res else None,
        }
        if res is None:
            point["raw_tail"] = buf.getvalue().strip().splitlines()[-3:]
        curve.append(point)
        print(json.dumps(point), flush=True)
    return curve


if __name__ == "__main__":
    main()
