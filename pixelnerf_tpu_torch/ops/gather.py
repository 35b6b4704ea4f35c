"""Pixel-aligned bilinear gather: the CUDA kernel ``csrc/gather.cu`` and
its plain PyTorch version.

Counterpart of ``gather_packed_lerp`` (``pixelnerf_tpu/ops/gather_pallas.py``),
without its int32 LR-packing: the kernel reads a bf16 or f32 table directly.

:func:`gather_bilerp` launches the kernel for CUDA tensors and runs
:func:`gather_bilerp_plain` for CPU tensors; it never falls back from one to
the other. ``gather_bilerp.launches`` counts kernel launches.

:func:`gather_bilerp_field` is the kernel's field instance: the whole
feature stage of ``PixelNeRFNet.query_features`` in one launch, from world
points and the views' cameras to the gathered latent rows and the MLP's x
rows (:func:`gather_bilerp_field_plain` is its plain mirror);
``gather_bilerp_field.launches`` counts its launches.
"""
from __future__ import annotations

import ctypes

import torch

from ..utils.geometry import device_vector
from . import _build
from .grid_sample import _compute_source_index, bilinear_pair_bases

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


def field_rows_wide(channels: int, table_dtype: torch.dtype) -> bool:
    """Whether kernel A serves a latent row of ``channels`` a warp a point
    (more than 32 pieces of 16 bytes), the form of its field instance."""
    return table_dtype in _DTYPE_CODE and channels % 8 == 0 and channels * table_dtype.itemsize > 32 * 16


def _scaling(hl: int, wl: int):
    """``models/encoder.py`` ``latent_scaling``'s numbers, [sx, sy]."""
    return wl / (wl - 1) * 2.0, hl / (hl - 1) * 2.0


def _rotate(w2c: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(N, 3, 4) poses' rotations times (N, B, 3) vectors, each product and
    sum rounded on its own in the kernel's order: (r0 x + r1 y) + r2 z."""
    r = w2c[:, None, :, :3]
    return r[..., 0] * v[..., 0:1] + r[..., 1] * v[..., 1:2] + r[..., 2] * v[..., 2:3]


def _view_rows(v: torch.Tensor, n: int) -> torch.Tensor:
    """Per-scene (SB, 2) intrinsics repeated to the (SB*NS, 2) view rows."""
    return v if v.shape[0] == n else torch.repeat_interleave(v, n // v.shape[0], dim=0)


def gather_bilerp_field_plain(
    latent: torch.Tensor,
    xyz: torch.Tensor,
    dirs: torch.Tensor,
    w2c: torch.Tensor,
    focal: torch.Tensor,
    c: torch.Tensor,
    image_shape: torch.Tensor,
    freqs: torch.Tensor,
    phases: torch.Tensor,
    out_dtype: torch.dtype = torch.float32,
):
    """The field instance's function in plain PyTorch: the feature stage
    of ``PixelNeRFNet.query_features`` (``use_xyz``, ``normalize_z``, the
    code on xyz alone with its input, view directions, bilinear/border), with the camera
    rotations' sums in the kernel's order instead of ``einsum``'s.

    :param latent: (N, Hl, Wl, C) maps, N = SB*NS (views interleaved)
    :param xyz, dirs: (SB, B, 3) float32 world points and view directions
    :param w2c: (N, 3, 4) world->camera poses
    :param focal, c: (SB, 2) or (N, 2) float32 [fx, fy] and principal points
    :param image_shape: (2,) float32 [W, H] of the encoded images
    :param freqs, phases: (K,) float32 tables of the positional code
    :return: latent rows (N, B, C) and x rows (N, B, 3 + 3K + 3), both in
        ``out_dtype``
    """
    n, hl, wl, ch = latent.shape
    views = n // xyz.shape[0]
    b = xyz.shape[1]
    rot = _rotate(w2c, torch.repeat_interleave(xyz, views, dim=0))
    cam = rot + w2c[:, None, :, 3]
    uv = -cam[..., :2] / cam[..., 2:3] * _view_rows(focal, n)[:, None] + _view_rows(c, n)[:, None]
    uv = uv * (device_vector(_scaling(hl, wl), uv.device) / image_shape) - 1.0
    ix = _compute_source_index(uv[..., 0], wl, "border", True)
    iy = _compute_source_index(uv[..., 1], hl, "border", True)
    base, w = bilinear_pair_bases(ix, iy, hl, wl)
    base = base + torch.arange(n, device=base.device, dtype=torch.int32)[:, None, None] * (hl * wl)
    rows = gather_bilerp_plain(latent.reshape(n * hl * wl, ch), base.reshape(-1, 2), w.reshape(-1, 2), wl,
                               out_dtype)
    code = torch.sin(rot[..., None, :] * freqs[:, None] + phases[:, None]).reshape(n, b, -1)
    vdirs = _rotate(w2c, torch.repeat_interleave(dirs, views, dim=0))
    x = torch.cat([rot, code, vdirs], dim=-1)
    return rows.reshape(n, b, ch), x.to(out_dtype)


def _check_field(latent, xyz, dirs, w2c, focal, c, image_shape, freqs, phases, out_dtype) -> None:
    if latent.dim() != 4 or latent.dtype not in _DTYPE_CODE or out_dtype not in _DTYPE_CODE:
        raise TypeError(f"latent must be (N, Hl, Wl, C) float32 or bfloat16 and the out dtype one of them, got "
                        f"{tuple(latent.shape)} {latent.dtype}, {out_dtype}")
    n, hl, wl, ch = latent.shape
    if ch % 8 != 0 or min(hl, wl) < 2:
        raise ValueError(f"channel count {ch} must be a multiple of 8 and the maps at least 2x2, got {hl}x{wl}")
    if n * hl * wl >= 2 ** 31:
        raise ValueError("the latent table's rows must fit int32")
    if xyz.dim() != 3 or xyz.shape[-1] != 3 or dirs.shape != xyz.shape or n % xyz.shape[0] != 0:
        raise ValueError(f"xyz and dirs must be (SB, B, 3) with SB dividing {n}, got {tuple(xyz.shape)}, "
                         f"{tuple(dirs.shape)}")
    if w2c.shape != (n, 3, 4):
        raise ValueError(f"w2c must be ({n}, 3, 4), got {tuple(w2c.shape)}")
    for name, v in (("focal", focal), ("c", c)):
        if v.dim() != 2 or v.shape[1] != 2 or v.shape[0] not in (xyz.shape[0], n):
            raise ValueError(f"{name} must be (SB, 2) or (SB*NS, 2), got {tuple(v.shape)}")
    if image_shape.shape != (2,) or freqs.dim() != 1 or freqs.shape != phases.shape:
        raise ValueError("image_shape must be (2,), freqs and phases (K,) each")
    for name, t in (("xyz", xyz), ("dirs", dirs), ("w2c", w2c), ("focal", focal), ("c", c),
                    ("image_shape", image_shape), ("freqs", freqs), ("phases", phases)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    devices = {t.device for t in (latent, xyz, dirs, w2c, focal, c, image_shape, freqs, phases)}
    if len(devices) != 1:
        raise ValueError(f"tensors on different devices: {devices}")


def gather_bilerp_field(
    latent: torch.Tensor,
    xyz: torch.Tensor,
    dirs: torch.Tensor,
    w2c: torch.Tensor,
    focal: torch.Tensor,
    c: torch.Tensor,
    image_shape: torch.Tensor,
    freqs: torch.Tensor,
    phases: torch.Tensor,
    out_dtype: torch.dtype = torch.float32,
):
    """The feature stage in one launch of kernel A's field instance: see
    :func:`gather_bilerp_field_plain` for the function and the arguments.
    CUDA tensors launch the kernel (no host copy and no host wait: every
    camera number is read on the device); CPU tensors run the plain mirror."""
    _check_field(latent, xyz, dirs, w2c, focal, c, image_shape, freqs, phases, out_dtype)
    if latent.device.type == "cpu":
        return gather_bilerp_field_plain(latent, xyz, dirs, w2c, focal, c, image_shape, freqs, phases, out_dtype)
    if latent.device.type != "cuda":
        raise ValueError(f"unsupported device {latent.device}")
    if not latent.is_contiguous() or latent.data_ptr() % 16 != 0:
        raise ValueError("latent must be contiguous and 16-byte aligned")
    xyz, dirs, w2c, freqs, phases = (t.contiguous() for t in (xyz, dirs, w2c, freqs, phases))
    n, hl, wl, ch = latent.shape
    sb, b, _ = xyz.shape
    views = n // sb
    d_x = 3 + 3 * freqs.shape[0] + 3
    out = torch.empty((n, b, ch), dtype=out_dtype, device=latent.device)
    x = torch.empty((n, b, d_x), dtype=out_dtype, device=latent.device)
    lib = _build.load("gather")
    fn = lib.gather_bilerp_field
    i64, i32, f32, ptr = ctypes.c_int64, ctypes.c_int, ctypes.c_float, ctypes.c_void_p
    fn.argtypes = ([ptr] * 5 + [i64, i64, i32] + [ptr, i64, i64, i32] + [ptr, f32, f32] + [ptr, ptr, i32]
                   + [i64, i32, i64, i32, i32, i32] + [ptr, ptr, i32, i32, ptr])
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(latent.device).cuda_stream
    with torch.cuda.device(latent.device):
        err = fn(
            latent.data_ptr(), xyz.data_ptr(), dirs.data_ptr(), w2c.data_ptr(),
            focal.data_ptr(), focal.stride(0), focal.stride(1), 1 if focal.shape[0] == n else views,
            c.data_ptr(), c.stride(0), c.stride(1), 1 if c.shape[0] == n else views,
            image_shape.data_ptr(), *_scaling(hl, wl),
            freqs.data_ptr(), phases.data_ptr(), freqs.shape[0],
            b, views, n * b, hl, wl, ch,
            out.data_ptr(), x.data_ptr(), _DTYPE_CODE[latent.dtype], _DTYPE_CODE[out_dtype], stream,
        )
    _build.check(err, "gather_bilerp_field launch")
    gather_bilerp_field.launches += 1
    return out, x


gather_bilerp_field.launches = 0
