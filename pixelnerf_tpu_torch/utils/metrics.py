"""Image quality metrics: PSNR and SSIM (the port's own copy of
``pixelnerf_tpu/utils/metrics.py``; numpy and scipy).

PSNR matches reference util.py:474-481 (``-10 log10(mse)``).

SSIM reimplements the legacy ``skimage.measure.compare_ssim`` semantics the
reference's evaluator relies on (eval/eval.py:321-329 with
``multichannel=True, data_range=1``; skimage 0.17 defaults: win_size=7,
uniform window, sample covariance, K1=0.01, K2=0.03, edge-cropped mean).
"""
from __future__ import annotations

import math

import numpy as np


def psnr(pred, target) -> float:
    """PSNR in dB between same-shaped arrays with values in [0, 1]."""
    pred = np.asarray(pred, dtype=np.float64)
    target = np.asarray(target, dtype=np.float64)
    mse = float(np.mean((pred - target) ** 2))
    return -10.0 * math.log10(mse)


def _uniform_filter(x: np.ndarray, size: int) -> np.ndarray:
    from scipy.ndimage import uniform_filter

    return uniform_filter(x, size=size)


def ssim(
    im1: np.ndarray,
    im2: np.ndarray,
    data_range: float = 1.0,
    win_size: int = 7,
    K1: float = 0.01,
    K2: float = 0.03,
    multichannel: bool = True,
) -> float:
    """Structural similarity, skimage-0.17-compatible (uniform 7x7 window)."""
    im1 = np.asarray(im1, dtype=np.float64)
    im2 = np.asarray(im2, dtype=np.float64)
    if multichannel and im1.ndim == 3:
        vals = [
            ssim(im1[..., c], im2[..., c], data_range, win_size, K1, K2, False)
            for c in range(im1.shape[-1])
        ]
        return float(np.mean(vals))

    NP = win_size ** im1.ndim
    cov_norm = NP / (NP - 1)  # sample covariance

    ux = _uniform_filter(im1, win_size)
    uy = _uniform_filter(im2, win_size)
    uxx = _uniform_filter(im1 * im1, win_size)
    uyy = _uniform_filter(im2 * im2, win_size)
    uxy = _uniform_filter(im1 * im2, win_size)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)

    C1 = (K1 * data_range) ** 2
    C2 = (K2 * data_range) ** 2
    A1 = 2 * ux * uy + C1
    A2 = 2 * vxy + C2
    B1 = ux**2 + uy**2 + C1
    B2 = vx + vy + C2
    S = (A1 * A2) / (B1 * B2)

    pad = (win_size - 1) // 2
    crop = tuple(slice(pad, s - pad) for s in S.shape)
    return float(S[crop].mean())
