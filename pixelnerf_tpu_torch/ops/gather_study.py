"""The weighted 4-row gather in four formulations (kernels E and F): the
CUDA kernels of ``csrc/gather_study.cu`` and their plain PyTorch version.

Counterpart of the Pallas study kernels of ``scripts/probe_gather_kernels.py``
(``k_loop_ds``, ``k_take``, ``k_adv_index``, the block-mask kernel) and of
``block_mask_gather`` in ``scripts/bench_gather_pallas.py``. Every
formulation computes kernel C's function (``ops/gather_rows.py``) to
float32 from a float32 or bf16 table,
``out[n] = ((w0*r0 + w1*r1) + w2*r2) + w3*r3`` with ``r_k = table[idx[n,k]]``;
they differ in how rows are addressed and staged (see the CUDA source).
The scripts are ``scripts/probe_gather_kernels_torch.py`` (builds and checks
each) and ``scripts/bench_gather_torch.py`` (times them at full scale).

:func:`gather_study` launches the named formulation for CUDA tensors and
runs :func:`gather_study_plain` for CPU tensors; it never falls back from
one to the other. ``gather_study.launches[name]`` counts each
formulation's launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .fused_mlp import SMEM_LIMIT
from .gather_rows import _DTYPE_CODE, _check, _check_cuda, gather_rows_lerp_plain

# name -> the kernel's code in csrc/gather_study.cu
FORMULATIONS = {"warp_direct": 0, "thread_global_idx": 1, "thread_smem_idx": 2, "block_stage": 3}
_STAGE_ROWS = 16   # block_stage keeps 4 points x 4 taps of rows in shared memory


def gather_study_plain(table: torch.Tensor, idx: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The kernels' function in plain PyTorch: kernel C's plain version with
    a float32 result.

    :param table: (R, C) float32 or bf16 feature rows
    :param idx: (N, 4) int32 row indices, in range
    :param w: (N, 4) float32 weights
    :return: (N, C) float32
    """
    return gather_rows_lerp_plain(table, idx, w, torch.float32)


def gather_study(
    table: torch.Tensor, idx: torch.Tensor, w: torch.Tensor, formulation: str, tile: int = 128
) -> torch.Tensor:
    """The weighted 4-row gather through one formulation of the study.

    :param formulation: one of :data:`FORMULATIONS`
    :param tile: points per block of the tiled formulations (all but
        ``warp_direct``); N need not be a multiple of it
    :return: (N, C) float32
    """
    if formulation not in FORMULATIONS:
        raise ValueError(f"unknown formulation {formulation!r}; one of {sorted(FORMULATIONS)}")
    if not 1 <= tile <= 4096:
        raise ValueError(f"tile must be in [1, 4096], got {tile}")
    _check(table, idx, w, torch.float32)
    if table.device.type == "cpu":
        return gather_study_plain(table, idx, w)
    _check_cuda((("table", table), ("idx", idx), ("w", w)))
    n, c = idx.shape[0], table.shape[1]
    if c // 8 > 1024:
        raise ValueError(f"channel count {c} exceeds a block's 1024 threads of 8 channels")
    if _STAGE_ROWS * c * table.element_size() + tile * 32 > SMEM_LIMIT:
        raise ValueError(f"channel count {c} and tile {tile} exceed the block's shared memory")
    out = torch.empty((n, c), dtype=torch.float32, device=table.device)
    fn = _build.load("gather_study").gather_study
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(table.device).cuda_stream
    with torch.cuda.device(table.device):
        err = fn(
            table.data_ptr(), idx.data_ptr(), w.data_ptr(), out.data_ptr(),
            n, c, _DTYPE_CODE[table.dtype], FORMULATIONS[formulation], int(tile), stream,
        )
    _build.check(err, f"gather_study {formulation} launch")
    gather_study.launches[formulation] += 1
    return out


gather_study.launches = {name: 0 for name in FORMULATIONS}
