"""Weighted 4-row gather (kernel C) and its backward: the CUDA kernels of
``csrc/gather_rows.cu`` and their plain PyTorch versions.

Counterpart of ``gather_rows_lerp`` (``pixelnerf_tpu/ops/gather_pallas.py``):
``out[n] = sum_k w[n,k] * table[idx[n,k]]``, the general-weight form of the
pixel-aligned gather, with idx and w from ``bilinear_corners``
(``ops/grid_sample.py``). Training gathers through :class:`GatherRowsLerp`,
whose backward is the scatter-add into the table plus the per-tap weight
gradient; the JAX package gets the same two terms from XLA's gather
transpose.

:func:`gather_rows_lerp` and :func:`gather_rows_lerp_bwd` launch their
kernels for CUDA tensors and run the plain versions for CPU tensors; they
never fall back from one to the other. Each counts its launches in
``.launches``.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def gather_rows_lerp_plain(
    table: torch.Tensor, idx: torch.Tensor, w: torch.Tensor, out_dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """The kernel's function in plain PyTorch: the four weighted rows
    summed in float32 in the TPU kernel's order,
    ``((w0*r0 + w1*r1) + w2*r2) + w3*r3``.

    :param table: (R, C) feature rows (all views folded into R)
    :param idx: (N, 4) int32 row indices, in range
    :param w: (N, 4) float32 weights
    :return: (N, C) in ``out_dtype``
    """
    rows = idx.to(torch.int64)
    acc = w[:, 0:1] * table[rows[:, 0]].float()
    for k in range(1, 4):
        acc = acc + w[:, k : k + 1] * table[rows[:, k]].float()
    return acc.to(out_dtype)


def gather_rows_lerp_bwd_plain(
    table: torch.Tensor, idx: torch.Tensor, w: torch.Tensor, grad_out: torch.Tensor,
    want_table: bool = True, want_w: bool = True,
) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """The backward in plain PyTorch: ``index_add_`` of ``w * grad_out``
    into a float32 table cast to the table's dtype, and
    ``grad_w[n,k] = <grad_out[n], table[idx[n,k]]>`` in float32.

    :return: (grad_table (R, C) or None, grad_w (N, 4) float32 or None)
    """
    g = grad_out.float()
    rows = idx.to(torch.int64)
    grad_table = grad_w = None
    if want_table:
        contrib = (w[:, :, None] * g[:, None, :]).reshape(-1, g.shape[1])
        grad_table = torch.zeros(table.shape, dtype=torch.float32, device=table.device)
        grad_table.index_add_(0, rows.reshape(-1), contrib)
        grad_table = grad_table.to(table.dtype)
    if want_w:
        grad_w = torch.einsum("nc,nkc->nk", g, table[rows].float())
    return grad_table, grad_w


def _check(table, idx, w, out_dtype) -> None:
    if table.dim() != 2 or idx.dim() != 2 or w.dim() != 2:
        raise ValueError("table, idx and w must be 2-D")
    n = idx.shape[0]
    if idx.shape != (n, 4) or w.shape != (n, 4):
        raise ValueError(f"idx and w must be (N, 4), got {tuple(idx.shape)}, {tuple(w.shape)}")
    if table.dtype not in _DTYPE_CODE or out_dtype not in _DTYPE_CODE:
        raise TypeError(f"table and out dtype must be float32 or bfloat16, got {table.dtype}, {out_dtype}")
    if idx.dtype != torch.int32 or w.dtype != torch.float32:
        raise TypeError(f"idx must be int32 and w float32, got {idx.dtype}, {w.dtype}")
    if table.shape[1] % 8 != 0:
        raise ValueError(f"channel count {table.shape[1]} must be a multiple of 8")
    devices = {t.device for t in (table, idx, w)}
    if len(devices) != 1:
        raise ValueError(f"tensors on different devices: {devices}")


def _check_cuda(tensors) -> None:
    for name, t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"unsupported device {t.device} for {name}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16 != 0:
            raise ValueError(f"{name} must be 16-byte aligned")


def _fn(name: str, n_ptrs: int):
    fn = getattr(_build.load("gather_rows"), name)
    fn.argtypes = [ctypes.c_void_p] * n_ptrs + [
        ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def gather_rows_lerp(
    table: torch.Tensor, idx: torch.Tensor, w: torch.Tensor, out_dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """Weighted 4-row gather of N points from a (R, C) table: see
    :func:`gather_rows_lerp_plain` for the function. CUDA tensors launch the
    kernel; CPU tensors run the plain version."""
    _check(table, idx, w, out_dtype)
    if table.device.type == "cpu":
        return gather_rows_lerp_plain(table, idx, w, out_dtype)
    _check_cuda((("table", table), ("idx", idx), ("w", w)))
    n, c = idx.shape[0], table.shape[1]
    out = torch.empty((n, c), dtype=out_dtype, device=table.device)
    stream = torch.cuda.current_stream(table.device).cuda_stream
    with torch.cuda.device(table.device):
        err = _fn("gather_rows_lerp", 4)(
            table.data_ptr(), idx.data_ptr(), w.data_ptr(), out.data_ptr(),
            n, c, _DTYPE_CODE[table.dtype], _DTYPE_CODE[out_dtype], stream,
        )
    _build.check(err, "gather_rows_lerp launch")
    gather_rows_lerp.launches += 1
    return out


gather_rows_lerp.launches = 0


def gather_rows_lerp_bwd(
    table: torch.Tensor, idx: torch.Tensor, w: torch.Tensor, grad_out: torch.Tensor,
    want_table: bool = True, want_w: bool = True,
) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """The backward of :func:`gather_rows_lerp` (see
    :func:`gather_rows_lerp_bwd_plain`). CUDA tensors launch the kernel,
    which accumulates ``grad_table`` with float32 atomics (the summation
    order varies between runs); CPU tensors run the plain version."""
    _check(table, idx, w, grad_out.dtype)
    if grad_out.shape != (idx.shape[0], table.shape[1]):
        raise ValueError(f"grad_out must be (N, C), got {tuple(grad_out.shape)}")
    if grad_out.device != table.device:
        raise ValueError(f"grad_out on {grad_out.device}, table on {table.device}")
    if table.device.type == "cpu":
        return gather_rows_lerp_bwd_plain(table, idx, w, grad_out, want_table, want_w)
    _check_cuda((("table", table), ("idx", idx), ("w", w), ("grad_out", grad_out)))
    if not (want_table or want_w):
        return None, None
    n, c = idx.shape[0], table.shape[1]
    dev = table.device
    grad_table = torch.zeros(table.shape, dtype=torch.float32, device=dev) if want_table else None
    grad_w = torch.empty((n, 4), dtype=torch.float32, device=dev) if want_w else None
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = _fn("gather_rows_lerp_bwd", 6)(
            table.data_ptr(), idx.data_ptr(), w.data_ptr(), grad_out.data_ptr(),
            grad_table.data_ptr() if want_table else None,
            grad_w.data_ptr() if want_w else None,
            n, c, _DTYPE_CODE[table.dtype], _DTYPE_CODE[grad_out.dtype], stream,
        )
    _build.check(err, "gather_rows_lerp_bwd launch")
    gather_rows_lerp_bwd.launches += 1
    if want_table:
        grad_table = grad_table.to(table.dtype)
    return grad_table, grad_w


gather_rows_lerp_bwd.launches = 0


class GatherRowsLerp(torch.autograd.Function):
    """Differentiable :func:`gather_rows_lerp`: gradients for the table and
    the weights (none for the integer indices).

    ``apply(table, idx, w, out_dtype, use_kernels)``: with ``use_kernels``
    the forward and backward go through the wrappers above (the kernels on
    CUDA tensors), else through their plain versions; a caller-side choice,
    used to compare the two on the card."""

    @staticmethod
    def forward(ctx, table, idx, w, out_dtype, use_kernels):
        ctx.save_for_backward(table, idx, w)
        ctx.use_kernels = use_kernels
        if use_kernels:
            return gather_rows_lerp(table, idx, w, out_dtype)
        _check(table, idx, w, out_dtype)
        return gather_rows_lerp_plain(table, idx, w, out_dtype)

    @staticmethod
    def backward(ctx, grad_out):
        table, idx, w = ctx.saved_tensors
        want_table, _, want_w = ctx.needs_input_grad[:3]
        bwd = gather_rows_lerp_bwd if ctx.use_kernels else gather_rows_lerp_bwd_plain
        grad_table, grad_w = bwd(table, idx, w, grad_out.contiguous(), want_table, want_w)
        return grad_table, None, grad_w, None, None
