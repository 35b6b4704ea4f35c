"""Torch-compatible resizing as separable matmuls.

Counterpart of ``pixelnerf_tpu/ops/resize.py``: ``resize_bilinear`` (the
encoder upsamples each ResNet stage to the first stage's resolution with
``align_corners=True`` before the channel concat, and pre-scales its input
for ``feature_scale`` above 1) and ``resize_area`` (the adaptive average:
the encoder's pre-scale below 1; the datasets' host-side downscale
contracts its matrix). The same
explicit 1-D matrices as the JAX package, contracted in float32.
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


@functools.lru_cache(maxsize=128)
def _area_matrix(out_size: int, in_size: int) -> np.ndarray:
    """(out_size, in_size) adaptive-average (torch 'area' mode) matrix."""
    m = np.zeros((out_size, in_size), dtype=np.float32)
    for o in range(out_size):
        lo = (o * in_size) // out_size
        hi = -(-((o + 1) * in_size) // out_size)  # ceil
        m[o, lo:hi] = 1.0 / (hi - lo)
    return m


@functools.lru_cache(maxsize=128)
def _device_matrix(make, out_size: int, in_size: int, *args, device: torch.device) -> torch.Tensor:
    """``make(out_size, in_size, *args)`` as a tensor on ``device``, made
    once and kept: a copy from the host's pageable memory waits for the
    device's queue to drain, and the encoder resizes three maps an encode.
    Made outside inference mode, so that a training step can save it for
    its backward."""
    with torch.inference_mode(False):
        return torch.as_tensor(make(out_size, in_size, *args), device=device)


def _apply_separable(x: torch.Tensor, mh: torch.Tensor, mw: torch.Tensor) -> torch.Tensor:
    """x (N, H, W, C) -> (N, H', W', C) via two contractions, in float32."""
    x = torch.einsum("oh,nhwc->nowc", mh, x)
    return torch.einsum("pw,nowc->nopc", mw, x)


def resize_bilinear(
    x: torch.Tensor, out_h: int, out_w: int, align_corners: bool = True
) -> torch.Tensor:
    """Bilinear resize of NHWC float32 maps, matching torch F.interpolate."""
    _, h, w, _ = x.shape
    if (h, w) == (out_h, out_w):
        return x
    return _apply_separable(
        x, _device_matrix(_bilinear_matrix, out_h, h, align_corners, device=x.device),
        _device_matrix(_bilinear_matrix, out_w, w, align_corners, device=x.device),
    )


def resize_area(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Area (adaptive-average) downscale of NHWC float32 images, matching
    torch's 'area' mode (the encoder's ``feature_scale`` below 1)."""
    _, h, w, _ = x.shape
    if (h, w) == (out_h, out_w):
        return x
    return _apply_separable(x, _device_matrix(_area_matrix, out_h, h, device=x.device),
                            _device_matrix(_area_matrix, out_w, w, device=x.device))
