"""Crash-tolerant checkpoints of a training run (counterpart of
``pixelnerf_tpu/train/state.py``).

One file holds the model's state_dict (parameters and running statistics),
the optimizer's state_dict and the step counter, written with
``torch.save``. Saves copy the current file to ``*_backup`` first, write a
tmp file and rename it into place, so a crash mid-write leaves a loadable
file. Loads fall back to the backup when the primary is unreadable, and to
a partial restore (model and step, the optimizer left as it was built) when
the optimizer no longer matches the saved one.
"""
from __future__ import annotations

import os
import shutil
from typing import Optional

import torch

CKPT_NAME = "train_state.pt"
BACKUP_SUFFIX = "_backup"


def save_checkpoint(ckpt_dir: str, net: torch.nn.Module, optimizer: torch.optim.Optimizer, step: int) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, CKPT_NAME)
    if os.path.exists(path):
        shutil.copyfile(path, path + BACKUP_SUFFIX)
    tmp = path + ".tmp"
    torch.save(
        {
            "model": net.state_dict(),
            "optimizer": optimizer.state_dict(),
            "optimizer_class": type(optimizer).__name__,
            "step": int(step),
        },
        tmp,
    )
    os.replace(tmp, path)
    return path


def _read(path: str, device) -> dict:
    raw = torch.load(path, map_location=device, weights_only=True)
    if not isinstance(raw, dict) or "model" not in raw:
        raise ValueError(f"{path} holds no train state")
    return raw


def load_checkpoint(
    ckpt_dir: str, net: torch.nn.Module, optimizer: torch.optim.Optimizer
) -> Optional[int]:
    """Restore ``net`` and ``optimizer`` in place from the newest readable
    file (primary, then backup). When the optimizer's class or parameter
    groups changed between runs, restore the model and the step only and
    keep the optimizer as built (a partial restore). Returns the restored
    step, or None when there was nothing to restore."""
    path = os.path.join(ckpt_dir, CKPT_NAME)
    device = next(net.parameters()).device
    for candidate in (path, path + BACKUP_SUFFIX):
        if not os.path.exists(candidate):
            continue
        try:
            raw = _read(candidate, device)
            net.load_state_dict(raw["model"])
        except Exception as e:  # corrupt file or another model
            print(f"WARNING: failed to load {candidate}: {e}")
            continue
        step = int(raw.get("step", 0))
        try:
            if raw.get("optimizer_class") != type(optimizer).__name__:
                raise ValueError(f"saved {raw.get('optimizer_class')}, built {type(optimizer).__name__}")
            optimizer.load_state_dict(raw["optimizer"])
        except Exception as e:
            print(
                f"WARNING: partial restore from {candidate}: model and step={step} restored, "
                f"optimizer state REINITIALIZED ({e})"
            )
        return step
    return None


def load_variables(ckpt_dir: str, device="cpu") -> Optional[dict]:
    """Restore for inference without an optimizer: ``{'model': state_dict,
    'step': int}`` from the primary file or its backup, or None."""
    path = os.path.join(ckpt_dir, CKPT_NAME)
    for candidate in (path, path + BACKUP_SUFFIX):
        if not os.path.exists(candidate):
            continue
        try:
            raw = _read(candidate, device)
            return {"model": raw["model"], "step": int(raw.get("step", 0))}
        except Exception as e:
            print(f"WARNING: failed to load {candidate}: {e}")
    return None
