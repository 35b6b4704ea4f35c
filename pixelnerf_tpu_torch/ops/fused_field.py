"""Fused pixel-aligned gather + conditioned ResnetFC MLP (kernel D): the
CUDA kernel ``csrc/fused_field.cu`` and its plain PyTorch version.

Counterpart of ``fused_gather_resnetfc_infer``
(``pixelnerf_tpu/ops/fused_field.py``): the bilinear gather of kernel A
(``ops/gather.py``), rounded to bf16, then the MLP of kernel B
(``ops/fused_mlp.py``) in one launch, so the gathered latents never reach
global memory. On the card it equals kernel B fed by kernel A bit for bit:
the three kernels share one lerp and one MLP chain (``csrc/*.cuh``).

Where the TPU kernel reads an LR-packed int32 table that holds each pixel's
right-hand neighbour in the same lane, this one reads the plain bf16 map and
clamps the neighbour itself, so it takes the map's width beside the table.

:func:`fused_gather_resnetfc_infer` launches the kernel for CUDA tensors
and runs :func:`fused_gather_resnetfc_infer_plain` for CPU tensors; it never
falls back from one to the other. ``fused_gather_resnetfc_infer.launches``
counts launches.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build
from .fused_mlp import (
    KC, _check as _check_mlp, _round_up, check_kernel_fits, check_kernel_shapes,
    fused_resnetfc_infer_plain, kernel_weight_pointers, weight_image,
)
from .gather import _check as _check_gather, gather_bilerp_plain


def fused_gather_resnetfc_infer_plain(
    table: torch.Tensor,
    base: torch.Tensor,
    wg: torch.Tensor,
    x: torch.Tensor,
    weights: Tuple[torch.Tensor, ...],
    n_blocks: int,
    combine_layer: int,
    width: int,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch: kernel A's plain version
    (bf16 output) feeding kernel B's plain version."""
    z = gather_bilerp_plain(table, base, wg, width, torch.bfloat16)
    return fused_resnetfc_infer_plain(z, x, weights, n_blocks, combine_layer)


def _check(table, base, wg, x, weights, n_blocks, combine_layer, width):
    _check_gather(table, base, wg, width, torch.bfloat16)
    if table.dtype != torch.bfloat16:
        raise TypeError(f"table must be bfloat16 (pack_encoding), got {table.dtype}")
    if x.dim() != 2 or x.shape[0] != base.shape[0]:
        raise ValueError(f"x must be (N, d_in) with base's N, got {tuple(x.shape)}")
    if x.device != table.device:
        raise ValueError(f"x on {x.device}, table on {table.device}")
    # the MLP's checks, on a stand-in (a view, no memory) for the latents
    # the kernel gathers
    z = table[:1].expand(x.shape[0], table.shape[1])
    return (table, base, wg) + _check_mlp(z, x, weights, n_blocks, combine_layer)[1:]


def fused_gather_resnetfc_infer(
    table: torch.Tensor,
    base: torch.Tensor,
    wg: torch.Tensor,
    x: torch.Tensor,
    weights: Tuple[torch.Tensor, ...],
    n_blocks: int,
    combine_layer: int,
    width: int,
) -> torch.Tensor:
    """Gather per-point latents and run the conditioned MLP in one kernel.

    :param table: (R, C) bf16 feature rows (``pack_encoding``; all views
        folded into R)
    :param base: (N, 2) int32 row bases (``ops.grid_sample.bilinear_pair_bases``)
    :param wg: (N, 2) float32 [wx, wy] fractional lerp weights
    :param x: (N, d_in) bf16 spatial code
    :param weights: the packed MLP weights (``ops.fused_mlp.pack_weights``)
    :param width: W, the row length of one view of the map
    :return: (N, 4) float32 raw rgb and sigma
    """
    tensors = _check(table, base, wg, x, weights, n_blocks, combine_layer, width)
    if table.device.type == "cpu":
        return fused_gather_resnetfc_infer_plain(
            table, base, wg, x, weights, n_blocks, combine_layer, width
        )
    if table.device.type != "cuda":
        raise ValueError(f"unsupported device {table.device}")
    dh = weights[0].shape[0]
    c = table.shape[1]
    kx = _round_up(x.shape[1], KC)
    n_lin_z = min(combine_layer, n_blocks)
    check_kernel_shapes(tensors[2:], kx, c, dh)     # wg, x, then the weights
    if table.data_ptr() % 16 or any(not t.is_contiguous() for t in tensors[:2]):
        raise ValueError("table and base must be contiguous, table 16-byte aligned")
    image = weight_image(weights, kx, n_blocks, n_lin_z, with_wz=True)
    lib = _build.load("fused_field")
    check_kernel_fits(lib, kx, c, dh)
    n = base.shape[0]
    out = torch.empty((n, 4), dtype=torch.float32, device=table.device)
    fn = lib.fused_gather_resnetfc_infer
    # table, base, wg, x, the image, six weight arrays, out: 12 pointers
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int64] + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(table.device).cuda_stream
    with torch.cuda.device(table.device):
        err = fn(
            table.data_ptr(), base.data_ptr(), wg.data_ptr(), x.data_ptr(), image.data_ptr(),
            *kernel_weight_pointers(weights), out.data_ptr(),
            n, x.shape[1], kx, c, dh, n_blocks, n_lin_z, int(width), stream,
        )
    _build.check(err, "fused_gather_resnetfc_infer launch")
    fused_gather_resnetfc_infer.launches += 1
    return out


fused_gather_resnetfc_infer.launches = 0

