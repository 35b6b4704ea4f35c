"""Pixel-aligned bilinear gather: the CUDA kernel ``csrc/gather.cu`` and
its plain PyTorch version.

Counterpart of ``gather_packed_lerp`` (``pixelnerf_tpu/ops/gather_pallas.py``),
without its int32 LR-packing: the kernel reads a bf16 or f32 table directly.

:func:`gather_bilerp` launches the kernel for CUDA tensors and runs
:func:`gather_bilerp_plain` for CPU tensors; it never falls back from one to
the other. ``gather_bilerp.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def gather_bilerp_plain(
    table: torch.Tensor,
    base: torch.Tensor,
    w: torch.Tensor,
    width: int,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch: rows at ``base`` and their
    right neighbours ``min(x0+1, W-1)``, lerped in float32 in
    ``packed_bilerp``'s order and association.

    :param table: (R, C) feature rows (all views folded into R)
    :param base: (N, 2) int32 [y0*W+x0, y1*W+x0] (view offset included)
    :param w: (N, 2) float32 [wx, wy]
    :param width: W, the row length of one view
    :return: (N, C) in ``out_dtype``
    """
    b = base.to(torch.int64)
    dx = (torch.remainder(b[:, 0], width) < width - 1).to(torch.int64)
    l0 = table[b[:, 0]].float()
    r0 = table[b[:, 0] + dx].float()
    l1 = table[b[:, 1]].float()
    r1 = table[b[:, 1] + dx].float()
    wx = w[:, 0:1].float()
    wy = w[:, 1:2].float()
    top = l0 + wx * (r0 - l0)
    bot = l1 + wx * (r1 - l1)
    return (top + wy * (bot - top)).to(out_dtype)


def _check(table, base, w, width, out_dtype) -> None:
    if table.dim() != 2 or base.dim() != 2 or w.dim() != 2:
        raise ValueError("table, base and w must be 2-D")
    n = base.shape[0]
    if base.shape != (n, 2) or w.shape != (n, 2):
        raise ValueError(f"base and w must be (N, 2), got {tuple(base.shape)}, {tuple(w.shape)}")
    if table.dtype not in _DTYPE_CODE or out_dtype not in _DTYPE_CODE:
        raise TypeError(f"table and out dtype must be float32 or bfloat16, got {table.dtype}, {out_dtype}")
    if base.dtype != torch.int32 or w.dtype != torch.float32:
        raise TypeError(f"base must be int32 and w float32, got {base.dtype}, {w.dtype}")
    if width < 1 or table.shape[0] % width != 0:
        raise ValueError(f"table rows {table.shape[0]} are not whole rows of width {width}")
    if table.shape[1] % 8 != 0:
        raise ValueError(f"channel count {table.shape[1]} must be a multiple of 8")
    devices = {t.device for t in (table, base, w)}
    if len(devices) != 1:
        raise ValueError(f"tensors on different devices: {devices}")


def gather_bilerp(
    table: torch.Tensor,
    base: torch.Tensor,
    w: torch.Tensor,
    width: int,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Bilinear gather of N points from a (R, C) table: see
    :func:`gather_bilerp_plain` for the function. CUDA tensors launch the
    kernel; CPU tensors run the plain version."""
    _check(table, base, w, width, out_dtype)
    if table.device.type == "cpu":
        return gather_bilerp_plain(table, base, w, width, out_dtype)
    if table.device.type != "cuda":
        raise ValueError(f"unsupported device {table.device}")
    for name, t in (("table", table), ("base", base), ("w", w)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if table.data_ptr() % 16 != 0:
        raise ValueError("table must be 16-byte aligned")
    if base.data_ptr() % 8 != 0 or w.data_ptr() % 8 != 0:
        raise ValueError("base and w must be 8-byte aligned (one record a load)")
    n, c = base.shape[0], table.shape[1]
    out = torch.empty((n, c), dtype=out_dtype, device=table.device)
    lib = _build.load("gather")
    fn = lib.gather_bilerp
    fn.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(table.device).cuda_stream
    with torch.cuda.device(table.device):
        err = fn(
            table.data_ptr(), base.data_ptr(), w.data_ptr(), out.data_ptr(),
            n, c, int(width), _DTYPE_CODE[table.dtype], _DTYPE_CODE[out_dtype],
            stream,
        )
    _build.check(err, "gather_bilerp launch")
    gather_bilerp.launches += 1
    return out


gather_bilerp.launches = 0
