"""The weighted 4-row gather in four formulations (kernels E and F): the
CUDA kernels of ``csrc/gather_study.cu`` and their plain PyTorch version.

Counterpart of the Pallas study kernels of ``scripts/probe_gather_kernels.py``
(``k_loop_ds``, ``k_take``, ``k_adv_index``, the block-mask kernel) and of
``block_mask_gather`` in ``scripts/bench_gather_pallas.py``. Every
formulation computes kernel C's function (``ops/gather_rows.py``) to
float32 from a float32 or bf16 table,
``out[n] = ((w0*r0 + w1*r1) + w2*r2) + w3*r3`` with ``r_k = table[idx[n,k]]``;
they differ in how rows are addressed and staged (see the CUDA source).
``block_stage`` (kernel E) first bins the points by their lowest tap row;
:func:`block_stage_plan_plain` mirrors its binning and
:func:`block_stage_plain` its serving order in plain PyTorch, and
:func:`block_stage_plan` returns the binning of the card's passes.
The scripts are ``scripts/probe_gather_kernels_torch.py`` (builds and checks
each) and ``scripts/bench_gather_torch.py`` (times them at full scale).

:func:`gather_study` launches the named formulation for CUDA tensors and
runs :func:`gather_study_plain` for CPU tensors; it never falls back from
one to the other. ``gather_study.launches[name]`` counts each
formulation's launches.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import _build
from .gather_rows import _DTYPE_CODE, _check, _check_cuda, gather_rows_lerp_plain

# name -> the kernel's code in csrc/gather_study.cu
FORMULATIONS = {"warp_direct": 0, "thread_global_idx": 1, "thread_smem_idx": 2, "block_stage": 3}
# as in csrc/gather_study.cu: block_stage's slab (S rows of C channels in
# SLAB_BYTES, at least MIN_SLAB_ROWS) and its most bins
SLAB_BYTES = 196608
MIN_SLAB_ROWS = 8
HIST_BINS = 2048


class BlockStagePlan(NamedTuple):
    """``block_stage``'s binning: bins of ``step`` rows by each point's
    lowest tap row; bin b stages table rows [b*step, b*step + S)."""

    step: int
    offsets: torch.Tensor   # (bins + 1,) int32: each bin's first place in perm
    perm: torch.Tensor      # (N,) int32: the points by bin, ascending within one


def slab_rows(c: int, element_size: int) -> int:
    """S, the table rows of ``block_stage``'s slab."""
    return SLAB_BYTES // (c * element_size)


def block_stage_plan_plain(idx: torch.Tensor, rows: int, c: int, element_size: int) -> BlockStagePlan:
    """The binning of ``block_stage`` in plain PyTorch. With ``span`` the
    widest tap span of any point, ``step = S - span`` when that is at least
    ``max(S // 8, ceil(rows / HIST_BINS))`` rows, so that every point's taps
    lie in its bin's slab; else ``step`` is the larger of S and that least
    step. The points are ordered by bin, stably."""
    s = slab_rows(c, element_size)
    rows64 = idx.to(torch.int64)
    lo = rows64.min(1).values
    span = int((rows64.max(1).values - lo).max()) if idx.shape[0] else 0
    least = max(s // 8, 1, -(-rows // HIST_BINS))
    step = s - span if s - span >= least else max(s, least)
    bins = lo // step
    offsets = torch.zeros(-(-rows // step) + 1, dtype=torch.int64)
    offsets[1:] = torch.cumsum(torch.bincount(bins, minlength=offsets.shape[0] - 1), 0)
    perm = torch.argsort(bins, stable=True)
    return BlockStagePlan(step, offsets.to(torch.int32), perm.to(torch.int32))


def block_stage_served(idx: torch.Tensor, plan: BlockStagePlan, c: int, element_size: int) -> torch.Tensor:
    """(N,) bool: the points whose four taps lie in their bin's slab, which
    ``block_stage`` serves from shared memory (the others from the table)."""
    rows64 = idx.to(torch.int64)
    base = rows64.min(1).values // plan.step * plan.step
    return rows64.max(1).values < base + slab_rows(c, element_size)


def block_stage_plain(table: torch.Tensor, idx: torch.Tensor, w: torch.Tensor, plan: BlockStagePlan) -> torch.Tensor:
    """``block_stage``'s serving in plain PyTorch: bin by bin in the plan's
    order, the served points reduced from the bin's slab of rows, the others
    from the table. Equal to :func:`gather_study_plain`, bit for bit."""
    n, c = idx.shape[0], table.shape[1]
    s = slab_rows(c, table.element_size())
    served = block_stage_served(idx, plan, c, table.element_size())
    out = torch.empty((n, c), dtype=torch.float32, device=table.device)
    offsets = plan.offsets.tolist()
    for b in range(len(offsets) - 1):
        points = plan.perm[offsets[b]:offsets[b + 1]].to(torch.int64)
        base = b * plan.step
        inner, outer = points[served[points]], points[~served[points]]
        out[inner] = gather_rows_lerp_plain(table[base:base + s], idx[inner] - base, w[inner], torch.float32)
        out[outer] = gather_rows_lerp_plain(table, idx[outer], w[outer], torch.float32)
    return out


def gather_study_plain(table: torch.Tensor, idx: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The kernels' function in plain PyTorch: kernel C's plain version with
    a float32 result.

    :param table: (R, C) float32 or bf16 feature rows
    :param idx: (N, 4) int32 row indices, in range
    :param w: (N, 4) float32 weights
    :return: (N, C) float32
    """
    return gather_rows_lerp_plain(table, idx, w, torch.float32)


def _check_width(table: torch.Tensor, formulation: str) -> None:
    c = table.shape[1]
    if formulation == "block_stage" and slab_rows(c, table.element_size()) < MIN_SLAB_ROWS:
        raise ValueError(f"channel count {c}: fewer than {MIN_SLAB_ROWS} {table.dtype} rows fit "
                         f"block_stage's {SLAB_BYTES}-byte slab")


def _scratch(lib, n: int, table: torch.Tensor) -> torch.Tensor:
    """The int32 words of block_stage's plan."""
    fn = lib.gather_study_scratch_words
    fn.argtypes = [ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int64
    words = fn(n, table.shape[0], table.shape[1], _DTYPE_CODE[table.dtype])
    if words < 0:
        raise ValueError(f"block_stage does not take a {tuple(table.shape)} {table.dtype} table")
    return torch.empty(words, dtype=torch.int32, device=table.device)


def gather_study(
    table: torch.Tensor, idx: torch.Tensor, w: torch.Tensor, formulation: str, tile: int = 128
) -> torch.Tensor:
    """The weighted 4-row gather through one formulation of the study.

    :param formulation: one of :data:`FORMULATIONS`
    :param tile: points per block of ``thread_global_idx`` and
        ``thread_smem_idx``; N need not be a multiple of it
        (``warp_direct`` takes a warp per point, ``block_stage`` an equal
        share of the binned points per SM)
    :return: (N, C) float32
    """
    if formulation not in FORMULATIONS:
        raise ValueError(f"unknown formulation {formulation!r}; one of {sorted(FORMULATIONS)}")
    if not 1 <= tile <= 4096:
        raise ValueError(f"tile must be in [1, 4096], got {tile}")
    _check(table, idx, w, torch.float32)
    _check_width(table, formulation)
    if table.device.type == "cpu":
        return gather_study_plain(table, idx, w)
    _check_cuda((("table", table), ("idx", idx), ("w", w)))
    n, c = idx.shape[0], table.shape[1]
    out = torch.empty((n, c), dtype=torch.float32, device=table.device)
    lib = _build.load("gather_study")
    scratch = _scratch(lib, n, table) if formulation == "block_stage" else None
    fn = lib.gather_study
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(table.device).cuda_stream
    with torch.cuda.device(table.device):
        err = fn(
            table.data_ptr(), idx.data_ptr(), w.data_ptr(), out.data_ptr(), n, c, table.shape[0],
            _DTYPE_CODE[table.dtype], FORMULATIONS[formulation], int(tile),
            None if scratch is None else scratch.data_ptr(), stream,
        )
    _build.check(err, f"gather_study {formulation} launch")
    gather_study.launches[formulation] += 1
    return out


gather_study.launches = {name: 0 for name in FORMULATIONS}


def block_stage_plan(table: torch.Tensor, idx: torch.Tensor) -> BlockStagePlan:
    """``block_stage``'s binning of ``idx`` for ``table``: from its four
    binning passes for CUDA tensors, from :func:`block_stage_plan_plain`
    for CPU tensors."""
    if table.dim() != 2 or table.dtype not in _DTYPE_CODE:
        raise TypeError(f"table must be a 2-D float32 or bf16 tensor, got {table.dtype} {tuple(table.shape)}")
    if idx.dim() != 2 or idx.shape[1] != 4 or idx.dtype is not torch.int32:
        raise TypeError(f"idx must be (N, 4) int32, got {idx.dtype} {tuple(idx.shape)}")
    _check_width(table, "block_stage")
    (rows, c), n = table.shape, idx.shape[0]
    if idx.device.type == "cpu" or n == 0:
        plan = block_stage_plan_plain(idx.cpu(), rows, c, table.element_size())
        return BlockStagePlan(plan.step, plan.offsets.to(idx.device), plan.perm.to(idx.device))
    _check_cuda((("idx", idx),))
    lib = _build.load("gather_study")
    scratch = _scratch(lib, n, table)
    fn = lib.gather_study_plan
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    with torch.cuda.device(idx.device):
        err = fn(idx.data_ptr(), n, rows, c, _DTYPE_CODE[table.dtype], scratch.data_ptr(),
                 torch.cuda.current_stream(idx.device).cuda_stream)
    _build.check(err, "gather_study_plan launch")
    block_stage_plan.launches += 1
    _, step, bins, _ = scratch[:4].tolist()
    return BlockStagePlan(step, scratch[4 + n:4 + n + bins + 1].clone(), scratch[4:4 + n].clone())


block_stage_plan.launches = 0
