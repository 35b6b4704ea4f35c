"""Pixel-aligned feature sampling (``grid_sample``), plain PyTorch.

Counterpart of ``pixelnerf_tpu/ops/grid_sample.py``: bilinear / nearest
modes with border / zeros / reflection padding, ``align_corners`` as in
torch, NHWC features. The view index is folded into the row index of ONE
flat ``(N*H*W, C)`` table, as the JAX package does, so the gather kernel
(``ops/gather.py``) takes the same inputs.

This is the plain oracle of the gather kernel and the path for the modes
the kernel does not cover (everything but bilinear/border).
"""
from __future__ import annotations

import torch


def _unnormalize(coord: torch.Tensor, size: int, align_corners: bool) -> torch.Tensor:
    """[-1, 1] grid coordinate -> pixel coordinate (torch convention)."""
    if align_corners:
        return (coord + 1.0) * 0.5 * (size - 1)
    return ((coord + 1.0) * size - 1.0) * 0.5


def _reflect(coord: torch.Tensor, low: float, high: float) -> torch.Tensor:
    """Reflect coordinate into [low, high] (torch reflection padding)."""
    span = high - low
    coord = torch.remainder(torch.abs(coord - low), 2.0 * span)
    return low + torch.minimum(coord, 2.0 * span - coord)


def _compute_source_index(
    coord: torch.Tensor, size: int, padding_mode: str, align_corners: bool
) -> torch.Tensor:
    x = _unnormalize(coord, size, align_corners)
    if padding_mode == "border":
        x = torch.clamp(x, 0.0, size - 1)
    elif padding_mode == "reflection":
        if align_corners:
            x = _reflect(x, 0.0, size - 1)
        else:
            x = _reflect(x, -0.5, size - 0.5)
        x = torch.clamp(x, 0.0, size - 1)
    elif padding_mode != "zeros":
        raise ValueError(f"Unknown padding_mode {padding_mode!r}")
    return x


def grid_sample(
    features: torch.Tensor,
    grid: torch.Tensor,
    mode: str = "bilinear",
    padding_mode: str = "border",
    align_corners: bool = True,
) -> torch.Tensor:
    """Sample ``features`` at normalized grid points.

    :param features: (N, H, W, C) feature maps (NHWC)
    :param grid: (Ng, P, 2) sampling locations, (x, y) in [-1, 1]; Ng == N,
        or N == 1 (one map sampled by Ng point sets)
    :param mode: 'bilinear' | 'nearest'
    :return: (Ng, P, C); float32 for a bf16 map under bilinear (the lerp
        weights are float32), the map's dtype under nearest
    """
    N, H, W, C = features.shape
    Ng, P = grid.shape[:2]
    if not (Ng == N or N == 1):
        raise ValueError(f"batch mismatch: features {N}, grid {Ng}")
    ix = _compute_source_index(grid[..., 0], W, padding_mode, align_corners)
    iy = _compute_source_index(grid[..., 1], H, padding_mode, align_corners)
    flat = features.reshape(N * H * W, C)
    off = (torch.arange(Ng, device=grid.device) * (H * W if N > 1 else 0))[:, None]

    def gather(iy_idx: torch.Tensor, ix_idx: torch.Tensor) -> torch.Tensor:
        """Rows at integer (y, x) -> (Ng*P, C); zero out of bounds if needed."""
        ycl = torch.clamp(iy_idx, 0, H - 1)
        xcl = torch.clamp(ix_idx, 0, W - 1)
        idx = (ycl * W + xcl + off).reshape(-1)
        vals = flat[idx]
        if padding_mode == "zeros":
            valid = (
                (ix_idx >= 0) & (ix_idx <= W - 1) & (iy_idx >= 0) & (iy_idx <= H - 1)
            ).reshape(-1, 1)
            vals = torch.where(valid, vals, torch.zeros((), dtype=vals.dtype, device=vals.device))
        return vals

    if mode == "nearest":
        # torch uses nearbyint (round half to even), as does torch.round
        return gather(
            torch.round(iy).to(torch.int64), torch.round(ix).to(torch.int64)
        ).reshape(Ng, P, C)
    if mode != "bilinear":
        raise ValueError(f"Unknown mode {mode!r}")

    ix0 = torch.floor(ix)
    iy0 = torch.floor(iy)
    wx = (ix - ix0).reshape(-1, 1)
    wy = (iy - iy0).reshape(-1, 1)
    ix0i = ix0.to(torch.int64)
    iy0i = iy0.to(torch.int64)

    v00 = gather(iy0i, ix0i)
    v01 = gather(iy0i, ix0i + 1)
    v10 = gather(iy0i + 1, ix0i)
    v11 = gather(iy0i + 1, ix0i + 1)

    top = v00 * (1.0 - wx) + v01 * wx
    bot = v10 * (1.0 - wx) + v11 * wx
    return (top * (1.0 - wy) + bot * wy).reshape(Ng, P, C)


def bilinear_pair_bases(
    ix: torch.Tensor, iy: torch.Tensor, H: int, W: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Row bases and fractional weights of the gather kernel's inputs
    (counterpart of ``bilinear_pair_bases`` in ``ops/gather_pallas.py``).

    :param ix, iy: (...,) pixel coords already border-clamped
    :return: base (..., 2) int32 [y0*W+x0, y1*W+x0]; w (..., 2) f32 [wx, wy]
    """
    ix0 = torch.floor(ix)
    iy0 = torch.floor(iy)
    wx = (ix - ix0).to(torch.float32)
    wy = (iy - iy0).to(torch.float32)
    x0 = torch.clamp(ix0.to(torch.int32), 0, W - 1)
    y0 = torch.clamp(iy0.to(torch.int32), 0, H - 1)
    y1 = torch.clamp(y0 + 1, max=H - 1)   # clamped: wy == 0 there, exact
    base = torch.stack([y0 * W + x0, y1 * W + x0], dim=-1)
    w = torch.stack([wx, wy], dim=-1)
    return base, w
