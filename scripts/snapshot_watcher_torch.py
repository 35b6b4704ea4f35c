#!/usr/bin/env python
"""Snapshot a live training checkpoint of the PyTorch port into step-tagged
copies (counterpart of ``scripts/snapshot_watcher.py``).

The port's trainer overwrites ``checkpoints/<name>/train_state.pt`` in
place; ``scripts/quality_curve_torch.py`` wants ``train_state_step<N>.pt``
snapshots to plot PSNR against steps. This watcher polls the live file's
mtime and, only when it changed, copies the file and reads the trained step
from the copy (``torch.load(..., weights_only=True)``, no model built),
keeping the copy as a step-tagged file whenever the step advanced by
``--every`` since the last snapshot.

    python scripts/snapshot_watcher_torch.py -n srn_car --every 2000 &
"""
from __future__ import annotations

import argparse
import os
import shutil
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pixelnerf_tpu_torch.train.state import CKPT_NAME  # noqa: E402


def read_step(path: str) -> int:
    import torch

    return int(torch.load(path, map_location="cpu", weights_only=True)["step"])


def snapshot_if_due(live: str, last_snap: int, every: int) -> int:
    """Copy ``live`` to a step-tagged sibling when its step advanced by
    ``every`` since ``last_snap``. Returns the new last_snap (unchanged when
    not due). The file is copied first and the step read from the copy:
    the trainer can replace the live file at any moment, and a step read
    before the copy could tag a snapshot with a step that is not its own.
    The copy is renamed into place, so readers never see a torn file."""
    tmp = live + ".snap.tmp"
    shutil.copyfile(live, tmp)
    try:
        step = read_step(tmp)
        if step - last_snap < every:
            return last_snap
        stem, ext = os.path.splitext(os.path.basename(live))
        dst = os.path.join(os.path.dirname(live), f"{stem}_step{step}{ext}")
        os.replace(tmp, dst)
        tmp = None
        print(f"[snapshot] step {step} -> {dst}", flush=True)
        return step
    finally:
        if tmp is not None and os.path.exists(tmp):
            os.remove(tmp)


def main(argv=None):
    ap = argparse.ArgumentParser(allow_abbrev=False)
    ap.add_argument("--name", "-n", required=True)
    ap.add_argument("--ckpt_root", default="checkpoints")
    ap.add_argument("--every", type=int, default=2000, help="min step delta between snapshots")
    ap.add_argument("--poll", type=float, default=120.0, help="seconds between polls of the live file")
    ap.add_argument("--max_wait", type=float, default=3600.0,
                    help="exit if the live file does not appear/advance for this long")
    args = ap.parse_args(argv)

    live = os.path.join(args.ckpt_root, args.name, CKPT_NAME)
    last_snap = -args.every  # snapshot the first checkpoint seen
    last_change = time.time()
    last_mtime = 0.0
    while True:
        if os.path.exists(live):
            try:
                mtime = os.path.getmtime(live)
                if mtime != last_mtime:
                    last_change = time.time()
                    last_snap = snapshot_if_due(live, last_snap, args.every)
                    # the mtime counts as seen only once the copy and read
                    # succeeded: a torn read retries on the next poll
                    last_mtime = mtime
            except Exception as e:  # torn read etc.: retry next poll
                print(f"[snapshot] skipped: {e}", flush=True)
        if time.time() - last_change > args.max_wait:
            print("[snapshot] live file idle too long; exiting", flush=True)
            return
        time.sleep(args.poll)


if __name__ == "__main__":
    main()
