"""Pixel-aligned feature sampling (``grid_sample``), plain PyTorch.

Counterpart of ``pixelnerf_tpu/ops/grid_sample.py``: bilinear / nearest
modes with border / zeros / reflection padding, ``align_corners`` as in
torch, NHWC features. The view index is folded into the row index of ONE
flat ``(N*H*W, C)`` table, as the JAX package does, so the gather kernel
(``ops/gather.py``) takes the same inputs.

This is the plain oracle of the gather kernels and the path for the modes
they do not cover (everything but bilinear/border). The quad-corner gather
(:func:`build_quad_features`, :func:`grid_sample_quad`) is plain PyTorch
too, as the JAX package leaves it to XLA.
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


def _clip(x: torch.Tensor, low: float, high: float) -> torch.Tensor:
    """``jnp.clip``: as ``torch.clamp``, but a value exactly at a bound
    passes half its gradient (max/min split ties), as in JAX. The bounds
    are filled on ``x``'s device (``new_tensor`` would copy from the host
    and stall the stream)."""
    return torch.minimum(torch.maximum(x, x.new_full((), low)), x.new_full((), high))


def _compute_source_index(
    coord: torch.Tensor, size: int, padding_mode: str, align_corners: bool
) -> torch.Tensor:
    x = _unnormalize(coord, size, align_corners)
    if padding_mode == "border":
        x = _clip(x, 0.0, size - 1)
    elif padding_mode == "reflection":
        if align_corners:
            x = _reflect(x, 0.0, size - 1)
        else:
            x = _reflect(x, -0.5, size - 0.5)
        x = _clip(x, 0.0, size - 1)
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


def build_quad_features(features: torch.Tensor) -> torch.Tensor:
    """The four bilinear corners of every pixel: (N, H, W, C) -> (N, H, W, 4C).

    Row (y, x) holds [f(y,x), f(y,x+1), f(y+1,x), f(y+1,x+1)] with the edges
    clamped: the four corners that a border-padded bilinear sample in cell
    (y, x) reads (the model's ``quad_gather``), so the lookup is one row
    gather per point at four times the map's memory.
    """
    right = torch.cat([features[:, :, 1:], features[:, :, -1:]], dim=2)
    down = torch.cat([features[:, 1:], features[:, -1:]], dim=1)
    downright = torch.cat([right[:, 1:], right[:, -1:]], dim=1)
    return torch.cat([features, right, down, downright], dim=-1)


def grid_sample_quad(quad: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Bilinear/border sample against a quad-corner map, one row gather per
    point (counterpart of ``grid_sample_quad`` in the JAX package, which
    XLA computes outside any kernel; torch's indexing here, differentiable
    in the map and, through the weights, in ``grid``).

    :param quad: (N, H, W, 4C) from :func:`build_quad_features`
    :param grid: (N, P, 2) normalized (x, y) in [-1, 1]
    :return: (N, P, C), float32 for a bf16 map (the weights are float32);
        the values of ``grid_sample(features, grid, 'bilinear', 'border')``
        (align_corners, as the model indexes)
    """
    N, H, W, C4 = quad.shape
    P = grid.shape[1]
    C = C4 // 4
    ix = _compute_source_index(grid[..., 0], W, "border", True)
    iy = _compute_source_index(grid[..., 1], H, "border", True)
    ix0 = torch.floor(ix)
    iy0 = torch.floor(iy)
    wx = (ix - ix0).reshape(N * P, 1)
    wy = (iy - iy0).reshape(N * P, 1)
    off = (torch.arange(N, device=grid.device) * (H * W))[:, None]
    idx = (iy0.to(torch.int64) * W + ix0.to(torch.int64) + off).reshape(-1)
    rows = quad.reshape(N * H * W, C4)[idx]                     # (N*P, 4C)
    v00, v01, v10, v11 = rows[:, :C], rows[:, C : 2 * C], rows[:, 2 * C : 3 * C], rows[:, 3 * C :]
    top = v00 * (1.0 - wx) + v01 * wx
    bot = v10 * (1.0 - wx) + v11 * wx
    return (top * (1.0 - wy) + bot * wy).reshape(N, P, C)


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


def bilinear_corners(
    ix: torch.Tensor, iy: torch.Tensor, H: int, W: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Corner rows and weights of kernel C's inputs (counterpart of
    ``bilinear_corners`` in ``ops/gather_pallas.py``). The weights are
    differentiable in ``ix``/``iy`` (floor carries no gradient), so the
    gather's weight gradient flows on to the sample positions.

    :param ix, iy: (...,) pixel coords already border-clamped
    :return: idx (..., 4) int32 rows [00, 01, 10, 11] into the (H*W, C)
        table; w (..., 4) f32 weights [w00, w01, w10, w11]
    """
    ix0 = torch.floor(ix)
    iy0 = torch.floor(iy)
    wx = (ix - ix0).to(torch.float32)
    wy = (iy - iy0).to(torch.float32)
    x0 = torch.clamp(ix0.to(torch.int32), 0, W - 1)
    y0 = torch.clamp(iy0.to(torch.int32), 0, H - 1)
    x1 = torch.clamp(x0 + 1, max=W - 1)
    y1 = torch.clamp(y0 + 1, max=H - 1)
    idx = torch.stack([y0 * W + x0, y0 * W + x1, y1 * W + x0, y1 * W + x1], dim=-1)
    w = torch.stack([(1 - wx) * (1 - wy), wx * (1 - wy), (1 - wx) * wy, wx * wy], dim=-1)
    return idx, w
