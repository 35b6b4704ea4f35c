"""Export a trained checkpoint as a reference-compatible torch state_dict
(counterpart of ``pixelnerf_tpu/apps/export_torch.py``).

    python -m pixelnerf_tpu_torch.apps.export_torch -n my_exp \
        --out checkpoints/my_exp/pixel_nerf_latest

The file loads into the reference's ``PixelNeRFNet`` and back into the
port (``load_reference_state_dict``, which the eval apps call when a
checkpoint directory holds no ``train_state.pt``).
"""
from __future__ import annotations

import argparse
import os

import torch

from ..models import export_state_dict
from ..train.state import load_variables


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--name", "-n", type=str, required=True)
    parser.add_argument("--checkpoints_path", type=str, default="checkpoints")
    parser.add_argument("--out", type=str, default=None,
                        help="output path (default: <ckpt_dir>/pixel_nerf_latest)")
    args = parser.parse_args(argv)

    ckpt_dir = os.path.join(args.checkpoints_path, args.name)
    variables = load_variables(ckpt_dir)
    if variables is None:
        raise FileNotFoundError(f"no checkpoint found in {ckpt_dir}")
    sd = export_state_dict(variables["model"])
    out = args.out or os.path.join(ckpt_dir, "pixel_nerf_latest")
    torch.save(sd, out)
    print(f"Exported step-{variables['step']} weights ({len(sd)} tensors) to {out}")


if __name__ == "__main__":
    main()
