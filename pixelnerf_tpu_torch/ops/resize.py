"""Torch-compatible bilinear resizing as separable matmuls.

Counterpart of ``pixelnerf_tpu/ops/resize.py`` ``resize_bilinear``: the
encoder upsamples each ResNet stage to the first stage's resolution with
``align_corners=True`` before the channel concat. The same explicit 1-D
interpolation matrices as the JAX package, contracted in float32.
"""
from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=128)
def _bilinear_matrix(out_size: int, in_size: int, align_corners: bool) -> np.ndarray:
    """(out_size, in_size) row-stochastic linear interpolation matrix."""
    m = np.zeros((out_size, in_size), dtype=np.float32)
    for o in range(out_size):
        if align_corners:
            src = o * (in_size - 1) / (out_size - 1) if out_size > 1 else 0.0
        else:
            src = (o + 0.5) * in_size / out_size - 0.5
        src = min(max(src, 0.0), in_size - 1)
        lo = int(np.floor(src))
        hi = min(lo + 1, in_size - 1)
        w = src - lo
        m[o, lo] += 1.0 - w
        m[o, hi] += w
    return m


def resize_bilinear(
    x: torch.Tensor, out_h: int, out_w: int, align_corners: bool = True
) -> torch.Tensor:
    """Bilinear resize of NHWC float32 maps, matching torch F.interpolate."""
    _, h, w, _ = x.shape
    if (h, w) == (out_h, out_w):
        return x
    mh = torch.as_tensor(_bilinear_matrix(out_h, h, align_corners), device=x.device)
    mw = torch.as_tensor(_bilinear_matrix(out_w, w, align_corners), device=x.device)
    x = torch.einsum("oh,nhwc->nowc", mh, x)
    return torch.einsum("pw,nowc->nopc", mw, x)
