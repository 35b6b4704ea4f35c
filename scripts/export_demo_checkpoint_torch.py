"""Export an inference checkpoint of the PyTorch port from a training run
(counterpart of ``scripts/export_demo_checkpoint.py``).

The full ``train_state.pt`` holds the model, the Adam moments and the step.
This script keeps the model and the step, and stores the floating-point
parameters in bfloat16 (``--dtype bfloat16``, the default) or float32:
about a sixth of the full file at bfloat16. The batch norms' running
statistics and integer buffers keep their dtype, as the JAX script keeps
``batch_stats`` in float32: a running variance spans orders of magnitude
that bfloat16's 8-bit mantissa would cost.

The output keeps the ``train_state.pt`` name, so every eval app loads it
through ``pixelnerf_tpu_torch.train.state.load_variables`` (the parameters
are widened to the model's float32 on load). Resuming training from it
takes ``load_checkpoint``'s partial restore: the model and the step, the
optimizer reinitialised, with a warning.

    python scripts/export_demo_checkpoint_torch.py \
        --src checkpoints/srn_car --dst demo/checkpoints/srn_car
"""
from __future__ import annotations

import argparse
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pixelnerf_tpu_torch.models.resnet import BatchNorm2d  # noqa: E402
from pixelnerf_tpu_torch.train.state import CKPT_NAME, load_variables  # noqa: E402


def batch_norm_buffers(state_dict) -> set:
    """The keys of ``state_dict`` that are buffers of a batch norm: those of
    every module prefix whose entries are exactly the port's
    ``BatchNorm2d``'s, minus its parameters."""
    probe = BatchNorm2d(1)
    entries = set(probe.state_dict())
    buffers = entries - {name for name, _ in probe.named_parameters()}
    by_prefix = {}
    for key in state_dict:
        prefix, _, leaf = key.rpartition(".")
        by_prefix.setdefault(prefix, set()).add(leaf)
    return {f"{prefix}.{leaf}" for prefix, leaves in by_prefix.items() if leaves == entries for leaf in buffers}


def export(src: str, dst: str, dtype: str = "bfloat16") -> str:
    raw = load_variables(src)
    if raw is None:
        raise SystemExit(f"no loadable checkpoint under {src}")
    dt = getattr(torch, dtype)
    keep = batch_norm_buffers(raw["model"])
    model = {k: (v if k in keep or not v.is_floating_point() else v.to(dt)) for k, v in raw["model"].items()}
    os.makedirs(dst, exist_ok=True)
    path = os.path.join(dst, CKPT_NAME)
    torch.save({"model": model, "step": int(raw["step"])}, path)
    return path


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", required=True, help="checkpoint dir holding a full train_state.pt")
    ap.add_argument("--dst", required=True, help="output checkpoint dir")
    ap.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    args = ap.parse_args(argv)
    path = export(args.src, args.dst, args.dtype)
    step = torch.load(path, map_location="cpu", weights_only=True)["step"]
    print(f"wrote {path}: {os.path.getsize(path) / 1e6:.1f} MB (step {step}, params {args.dtype})")
    return path


if __name__ == "__main__":
    main()
