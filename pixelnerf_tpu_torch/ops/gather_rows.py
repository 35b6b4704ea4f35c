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
from typing import Dict, Optional, Tuple

import torch

from . import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# entries per chunk of the backward kernel's row-owner pass (a power of
# two, at most MAX_CHUNK of csrc/gather_rows.cu)
ROW_CHUNK = 64
# the scan's state in the index buffer: SCAN_WORDS of csrc/gather_rows.cu
# (a ticket, then a flag and four sums for each of 128 blocks)
_SCAN_WORDS = 1 + 128 + 4 * 128


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


def row_owner_plan_plain(idx: torch.Tensor, rows: int, chunk: int = ROW_CHUNK) -> Dict[str, torch.Tensor]:
    """The index that the backward kernel's first three launches build, in
    plain PyTorch. Entry ``e = 4n + k`` of the E = 4N taps goes to row
    ``idx[n, k]``; a row's entries are cut into chunks of ``chunk``, and a
    row with no entries gets one empty chunk (so that its zeros are
    written). All int32:

    - ``counts`` (R,): entries per row;
    - ``offsets`` (R+1,): exclusive scan of ``counts``;
    - ``chunk_start`` (R+1,): exclusive scan of ``max(1, ceil(count/chunk))``;
    - ``multi_start`` (R+1,): exclusive scan of the chunk counts of rows
      with two chunks or more (0 for the others): their partials' slots;
    - ``chunk_row``, ``chunk_first`` (Q,): each chunk's row and the position
      of its first entry in ``perm``;
    - ``multi_rows``: the rows of two chunks or more, ascending;
    - ``perm`` (E,): the entries grouped by row, rows ascending, and within
      a row ascending (the order the kernel sums them in: its fill places
      them as its atomics fall, then its sort and owner order them).
    """
    e_rows = idx.reshape(-1).long()
    counts = torch.bincount(e_rows, minlength=rows)
    n_chunks = torch.clamp((counts + chunk - 1) // chunk, min=1)
    multi = torch.where(n_chunks >= 2, n_chunks, torch.zeros_like(n_chunks))

    def exclusive(x):
        return torch.cat([x.new_zeros(1), torch.cumsum(x, 0)])

    offsets, chunk_start, multi_start = exclusive(counts), exclusive(n_chunks), exclusive(multi)
    chunk_row = torch.repeat_interleave(torch.arange(rows, device=idx.device), n_chunks)
    within = torch.arange(chunk_row.shape[0], device=idx.device) - chunk_start[chunk_row]
    plan = {
        "counts": counts, "offsets": offsets, "chunk_start": chunk_start, "multi_start": multi_start,
        "chunk_row": chunk_row, "chunk_first": offsets[chunk_row] + within * chunk,
        "multi_rows": torch.nonzero(n_chunks >= 2).flatten(),
        "perm": torch.argsort(e_rows, stable=True),
    }
    return {k: v.to(torch.int32) for k, v in plan.items()}


def row_owner_bwd_plain(
    table: torch.Tensor, idx: torch.Tensor, w: torch.Tensor, grad_out: torch.Tensor, chunk: int = ROW_CHUNK,
    want_table: bool = True, want_w: bool = True,
) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """The backward as the kernel computes it, in plain PyTorch, for the
    tests: the index of :func:`row_owner_plan_plain`; each chunk's float32
    partial, its entries' ``w * grad_out`` summed in ascending order, each
    product rounded before its add; a row of one chunk takes its partial, a
    row of several the sum of its partials in chunk order; rounded once to
    the table's dtype. This ``grad_table`` is the kernel's bit for bit.
    ``grad_w`` is each entry's dot of its ``grad_out`` and table rows, in
    float32 (the kernel's within float32 rounding: its sums run in another
    order).

    :return: as :func:`gather_rows_lerp_bwd_plain`
    """
    rows, c = table.shape
    plan = row_owner_plan_plain(idx, rows, chunk)
    g = grad_out.float()
    perm = plan["perm"].long()
    grad_table = grad_w = None
    if want_w:
        grad_w = torch.einsum("nc,nkc->nk", g, table[idx.long()].float())
    if not want_table:
        return grad_table, grad_w
    chunk_row, first = plan["chunk_row"].long(), plan["chunk_first"].long()
    end = torch.minimum(first + chunk, plan["offsets"].long()[chunk_row + 1])
    partial = torch.zeros((chunk_row.shape[0], c), dtype=torch.float32, device=table.device)
    w_flat = w.reshape(-1)
    for j in range(chunk if perm.numel() else 0):
        pos = first + j
        e = perm[pos.clamp(max=perm.numel() - 1)]
        w_e = torch.where(pos < end, w_flat[e], torch.zeros_like(w_flat[e]))
        partial = partial + w_e[:, None] * g[e // 4]
    chunk_start = plan["chunk_start"].long()
    grad_table = partial[chunk_start[:-1]]
    for r in torch.nonzero(chunk_start[1:] - chunk_start[:-1] >= 2).flatten().tolist():
        acc = partial[chunk_start[r]]
        for q in range(chunk_start[r] + 1, chunk_start[r + 1]):
            acc = acc + partial[q]
        grad_table[r] = acc
    return grad_table.to(table.dtype), grad_w


def _check(table, idx, w, out_dtype) -> None:
    if table.dim() != 2 or idx.dim() != 2 or w.dim() != 2:
        raise ValueError("table, idx and w must be 2-D")
    n = idx.shape[0]
    if idx.shape != (n, 4) or w.shape != (n, 4):
        raise ValueError(f"idx and w must be (N, 4), got {tuple(idx.shape)}, {tuple(w.shape)}")
    if table.dtype not in _DTYPE_CODE or out_dtype not in _DTYPE_CODE:
        raise TypeError(f"table and out dtype must be float32 or bfloat16, got {table.dtype}, {out_dtype}")
    # dtypes are singletons: `is` spares the slow `!=` (this runs per call)
    if idx.dtype is not torch.int32 or w.dtype is not torch.float32:
        raise TypeError(f"idx must be int32 and w float32, got {idx.dtype}, {w.dtype}")
    if table.shape[1] % 8 != 0:
        raise ValueError(f"channel count {table.shape[1]} must be a multiple of 8")
    devices = {t.device for t in (table, idx, w)}
    if len(devices) != 1:
        raise ValueError(f"tensors on different devices: {devices}")


def _check_cuda(tensors) -> None:
    for name, t in tensors:
        if not t.is_cuda:
            raise ValueError(f"unsupported device {t.device} for {name}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16 != 0:
            raise ValueError(f"{name} must be 16-byte aligned")


_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# (argtypes, restype) of the C entry points of csrc/gather_rows.cu
_SIGNATURES = {
    "gather_rows_lerp": ([_P] * 4 + [_I64, _I, _I, _I, _P], _I),
    "gather_rows_lerp_bwd": ([_P] * 7 + [_I64] + [_I] * 5 + [_P], _I),
    "gather_rows_bwd_plan": ([_P, _P, _I64, _I, _I, _P], _I),
}
_FNS: Dict[str, ctypes._CFuncPtr] = {}


def _fn(name: str):
    """The C entry point ``name``, its signature declared once (the backward
    is called many times a step, and its host time shows beside its
    device time)."""
    fn = _FNS.get(name)
    if fn is None:
        fn = getattr(_build.load("gather_rows"), name)
        fn.argtypes, fn.restype = _SIGNATURES[name]
        _FNS[name] = fn
    return fn


def gather_rows_lerp(
    table: torch.Tensor, idx: torch.Tensor, w: torch.Tensor, out_dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """Weighted 4-row gather of N points from a (R, C) table: see
    :func:`gather_rows_lerp_plain` for the function. CUDA tensors launch the
    kernel; CPU tensors run the plain version."""
    _check(table, idx, w, out_dtype)
    if table.is_cpu:
        return gather_rows_lerp_plain(table, idx, w, out_dtype)
    _check_cuda((("table", table), ("idx", idx), ("w", w)))
    n, c = idx.shape[0], table.shape[1]
    out = torch.empty((n, c), dtype=out_dtype, device=table.device)
    stream = torch.cuda.current_stream(table.device).cuda_stream
    with torch.cuda.device(table.device):
        err = _fn("gather_rows_lerp")(
            table.data_ptr(), idx.data_ptr(), w.data_ptr(), out.data_ptr(),
            n, c, _DTYPE_CODE[table.dtype], _DTYPE_CODE[out_dtype], stream,
        )
    _build.check(err, "gather_rows_lerp launch")
    gather_rows_lerp.launches += 1
    return out


gather_rows_lerp.launches = 0


def _plan_sections(rows: int, entries: int, chunk: int):
    """The sections of the index's int32 buffer, in the order of ``Plan`` in
    ``csrc/gather_rows.cu``: (name, length) each. Q = R + ceil(E/chunk)
    bounds the chunks, floor(E/(chunk+1)) the rows of two chunks or more."""
    q = rows + -(-entries // chunk)
    return [("counts", rows), ("cursor", rows), ("scan", _SCAN_WORDS), ("offsets", rows + 1),
            ("chunk_start", rows + 1), ("multi_start", rows + 1), ("chunk_row", q), ("chunk_first", q),
            ("multi_count", 1), ("multi_rows", entries // (chunk + 1)), ("perm", entries),
            ("perm_tmp", entries)]


def row_owner_plan(idx: torch.Tensor, rows: int, chunk: int = ROW_CHUNK) -> Dict[str, torch.Tensor]:
    """The backward kernel's index launches alone (count, scan, fill, sort)
    on a CUDA ``idx``, for the tests: the sections of
    :func:`row_owner_plan_plain`, ``chunk_row``, ``chunk_first`` and
    ``multi_rows`` cut to their true counts, ``perm`` ascending within each
    row of two chunks or more and, within the others, in the order the
    fill's atomics fell (the owner sorts those). Counts no launch."""
    _check_cuda((("idx", idx),))
    entries = idx.numel()
    sections = _plan_sections(rows, entries, chunk)
    plan = torch.empty(sum(n for _, n in sections), dtype=torch.int32, device=idx.device)
    stream = torch.cuda.current_stream(idx.device).cuda_stream
    with torch.cuda.device(idx.device):
        err = _fn("gather_rows_bwd_plan")(idx.data_ptr(), plan.data_ptr(), idx.shape[0], rows, chunk, stream)
    _build.check(err, "gather_rows_bwd_plan launch")
    out = dict(zip([k for k, _ in sections], torch.split(plan, [n for _, n in sections])))
    n_chunks = int(out["chunk_start"][-1])
    out["chunk_row"], out["chunk_first"] = out["chunk_row"][:n_chunks], out["chunk_first"][:n_chunks]
    out["multi_rows"] = out["multi_rows"][: int(out["multi_count"][0])]
    for k in ("cursor", "scan", "multi_count", "perm_tmp"):
        del out[k]
    return out


def gather_rows_lerp_bwd(
    table: torch.Tensor, idx: torch.Tensor, w: torch.Tensor, grad_out: torch.Tensor,
    want_table: bool = True, want_w: bool = True,
) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """The backward of :func:`gather_rows_lerp` (see
    :func:`gather_rows_lerp_bwd_plain`). CPU tensors run the plain version.
    CUDA tensors launch the row-owner pass (``csrc/gather_rows.cu``): an
    index of the 4N taps by row, each row's taps ascending (count, scan,
    fill, and a sort of the rows of more than one chunk), then one warp per
    chunk of ``ROW_CHUNK`` of a row's taps sorts them (if the sort has not)
    and sums ``w * grad_out`` in float32 in that order and takes
    ``grad_w``'s dots; a row of one chunk is written in the table's dtype,
    a row of several by a last launch that adds its chunks' partials in
    chunk order. ``grad_table`` is :func:`row_owner_bwd_plain`'s bit for
    bit, the same on every run. Without ``want_table`` one warp per point
    takes the dots alone and no index is built. No float atomics and no
    float32 copy of the table; each call makes seven device launches (the
    index's zeroed counters, count, scan, fill, sort, owner, combine). Its
    bound is the bytes: grad_out, the table, idx and w read once, the two
    gradients written once; the owner reads grad_out ~4 times through L2."""
    _check(table, idx, w, grad_out.dtype)
    if grad_out.shape != (idx.shape[0], table.shape[1]):
        raise ValueError(f"grad_out must be (N, C), got {tuple(grad_out.shape)}")
    if grad_out.device != table.device:
        raise ValueError(f"grad_out on {grad_out.device}, table on {table.device}")
    if table.is_cpu:
        return gather_rows_lerp_bwd_plain(table, idx, w, grad_out, want_table, want_w)
    _check_cuda((("table", table), ("idx", idx), ("w", w), ("grad_out", grad_out)))
    if not (want_table or want_w):
        return None, None
    (rows, c), n = table.shape, idx.shape[0]
    entries = 4 * n
    plan_words = sum(k for _, k in _plan_sections(rows, entries, ROW_CHUNK))
    if plan_words >= 2 ** 31:
        raise ValueError(f"{n} points into {rows} rows overflow the kernel's int32 index")
    dev = table.device
    grad_table = torch.empty(table.shape, dtype=table.dtype, device=dev) if want_table else None
    grad_w = torch.empty((n, 4), dtype=torch.float32, device=dev) if want_w else None
    # the index's words, then (16-byte aligned) float32 slots for the chunks
    # of rows of two chunks or more, at most 2E/chunk of them: the layout of
    # launch_bwd in csrc/gather_rows.cu
    scratch = None
    if want_table:
        nbytes = -(-plan_words * 4 // 16) * 16 + 2 * -(-entries // ROW_CHUNK) * c * 4
        scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)

    def ptr(t):  # an empty or absent output is skipped (null)
        return t.data_ptr() if t is not None and t.numel() else None

    with torch.cuda.device(dev):
        err = _fn("gather_rows_lerp_bwd")(
            table.data_ptr(), idx.data_ptr(), w.data_ptr(), grad_out.data_ptr(),
            ptr(grad_table), ptr(grad_w), ptr(scratch), n, c, rows, ROW_CHUNK,
            _DTYPE_CODE[table.dtype], _DTYPE_CODE[grad_out.dtype], torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(err, "gather_rows_lerp_bwd launch")
    gather_rows_lerp_bwd.launches += 1
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
