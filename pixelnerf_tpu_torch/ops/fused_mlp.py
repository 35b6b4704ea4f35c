"""Fused ResnetFC inference: the CUDA kernel ``csrc/fused_mlp.cu`` and its
plain PyTorch version.

Counterpart of ``fused_resnetfc_infer`` and ``pack_weights``
(``pixelnerf_tpu/ops/fused_mlp.py``). The packed weight tuple holds the same
ten arrays as the JAX package's, ``(win, bin, wz, bz, w0, b0, w1, b1, wout,
bout)``, with each matrix in torch's ``(out, in)`` layout, i.e. the
transpose of the JAX tuple's ``(in, out)``, and each bias 1-D:

- ``win`` (dh, d_in_pad): lin_in, input columns zero-padded to 128
- ``wz`` (n_lin_z*dh, d_latent): the lin_z injections stacked by rows
  (any ``d_latent`` that is a multiple of 8: the kernel's z tile is
  rounded up to a multiple of 64 columns, zero-filled past ``d_latent``,
  and the tiled image pads ``wz`` with zero columns to match)
- ``w0``/``w1`` (n_blocks, dh, dh): the residual blocks' fc_0/fc_1
- ``wout`` (128, dh): lin_out, output rows zero-padded to 128

Rounding contract (``_mlp_kernel``): every product accumulates in float32,
is rounded to bf16, then the bf16 bias is added; residual adds and the
latent injections are bf16 adds. The views' mean of the multi-view mode is
:func:`mean_of_views`, ``torch.mean``'s rounding on the card.

Beside the tuple rides the kernel's own layout of the same matrices, the
*tiled image* (:func:`tile_weights`): every matrix cut into the slabs of
``slab_columns(dh)`` output columns by 64 input columns that the kernel's
tensor cores take, each slab already in the 128-byte swizzle of
shared memory, in the order the kernel walks them, so that one bulk copy
brings one slab. :func:`pack_weights` builds it once per model (the result
is cached on the module until a parameter changes) and returns a
:class:`PackedWeights`, a tuple of the ten arrays that carries the image.

With ``z_is_tz`` (the kernel's variant for baked encodings,
``models/pixelnerf.py`` ``bake_encoding``) ``z`` already holds the
injections ``z_raw @ wz.T + bz``, ``n_lin_z * dh`` wide: block ``i`` adds
``z[:, i*dh:(i+1)*dh]`` in bf16 and ``wz``/``bz`` are neither used nor asked
for (they may be None in the tuple).

With ``views`` of 2 or more (the multi-view mode, pixelNeRF's field at NS
source views with ``combine_type = "average"``) the rows of z and x are
``(SB, views, points)``, the layout ``query_features`` hands over: the
layers before ``combine_layer`` run on every row, the views' h is averaged
there (:func:`mean_of_views`), and the rest runs on the ``(SB, points)``
rows of the result. Not with ``z_is_tz``; ``combine_layer`` lies between 1
and ``n_blocks - 1``.

:func:`fused_resnetfc_infer` launches the kernel for CUDA tensors and runs
:func:`fused_resnetfc_infer_plain` for CPU tensors; it never falls back
from one to the other. ``fused_resnetfc_infer.launches`` counts launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build

LANE = 128
SMEM_LIMIT = 232448   # dynamic shared memory a Hopper block may use
KC = 64               # input columns of a weight slab: 128 bytes, one swizzle row
KERNEL_WIDTHS = (64, 128, 256, 512)   # d_hidden the kernel is built for


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def slab_columns(dh: int) -> int:
    """Output columns of one weight slab: half of ``dh`` (one consumer
    warpgroup's share), at most 128."""
    return min(dh // 2, 128)


def z_tile_width(d_z: int) -> int:
    """Columns of kernel B's z tile for a ``d_z``-wide latent: rounded up to
    a whole 64-column chunk (the fill zero-fills the columns past ``d_z``)."""
    return _round_up(d_z, KC)


def check_kernel_widths(kx: int, zw: int, dh: int) -> None:
    """Raise ValueError for widths the kernel is not built for: ``kx``
    columns of x, a ``zw``-wide injection tile (already rounded by
    :func:`z_tile_width` where the kernel rounds it), ``dh`` hidden. Whether
    they also fit the block's shared memory only the built kernel says
    (``csrc/mlp_body.cuh`` ``layout_of``; :func:`check_kernel_fits`)."""
    if dh not in KERNEL_WIDTHS:
        raise ValueError(f"the fused MLP kernel is built for d_hidden in {KERNEL_WIDTHS}, got {dh}")
    if kx % KC or zw % KC or kx < KC or zw < KC:
        raise ValueError(
            f"the fused MLP kernel takes x and latent widths in multiples of {KC}, got {kx}, {zw}")


def check_kernel_fits(lib, kx: int, zw: int, dh: int) -> int:
    """Ask the built kernel (``lib``: either library of the MLP body) for its
    block's shared memory at these widths; raises ValueError if it has none
    (the widths are not built, or exceed the block's shared memory)."""
    fn = lib.mlp_body_smem_bytes
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_size_t
    smem = fn(kx, zw, dh)
    if not smem:
        raise ValueError(f"widths ({kx}, {zw}, {dh}) do not fit the fused MLP kernel's block")
    return smem


def _tile_matrix(w: torch.Tensor) -> torch.Tensor:
    """One (dh, K) matrix as its slabs, flat: for each slab of columns of a
    warpgroup's share, for each 64-wide chunk of K, for each of the two
    warpgroups, ``slab_columns(dh)`` rows of 8 16-byte units, the unit at
    place ``u`` of row ``r`` holding the columns of unit ``u ^ (r % 8)``."""
    dh, k = w.shape
    ni = slab_columns(dh)
    v = w.reshape(2, dh // (2 * ni), ni, k // KC, 8, 8)      # wg, slab, row, chunk, unit, element
    v = v.permute(1, 3, 0, 2, 4, 5)                           # slab, chunk, wg, row, unit, element
    r = torch.arange(ni, device=w.device)
    unit = torch.arange(8, device=w.device)[None, :] ^ (r[:, None] % 8)
    return v[:, :, :, r[:, None], unit].reshape(-1)


@torch.no_grad()
def tile_weights(weights, kx: int, n_blocks: int, n_lin_z: int, with_wz: bool = True) -> torch.Tensor:
    """The kernel's image of the ten-array tuple: ``win[:, :kx]``, then per
    block its ``wz`` slice (if ``with_wz`` and the block has an injection),
    ``w0`` and ``w1``, each as :func:`_tile_matrix` lays it out, in one flat
    bf16 tensor, ``wz``'s columns zero-padded to :func:`z_tile_width`.
    ``wout`` is not in it (the kernel keeps its rows resident)."""
    win, _, wz, _, w0, _, w1, _, _, _ = weights
    dh = win.shape[0]
    parts = [_tile_matrix(win[:, :kx])]
    if with_wz:
        wz = torch.nn.functional.pad(wz, (0, z_tile_width(wz.shape[1]) - wz.shape[1]))
    for i in range(n_blocks):
        if with_wz and i < n_lin_z:
            parts.append(_tile_matrix(wz[i * dh : (i + 1) * dh]))
        parts += [_tile_matrix(w0[i]), _tile_matrix(w1[i])]
    return torch.cat(parts).contiguous()


class PackedWeights(tuple):
    """The ten-array weight tuple, carrying the kernel's tiled image of it
    (``image``) and what the image was built for (``image_key``)."""

    image: Optional[torch.Tensor] = None
    image_key: Optional[tuple] = None


def weight_image(weights, kx: int, n_blocks: int, n_lin_z: int, with_wz: bool) -> torch.Tensor:
    """The tiled image for a launch: the one ``weights`` carries if it was
    built for this launch, else built now (a plain tuple pays that on every
    launch; :func:`pack_weights` pays it once per model)."""
    key = (kx, n_blocks, n_lin_z, with_wz)
    if getattr(weights, "image_key", None) == key:
        return weights.image
    return tile_weights(weights, kx, n_blocks, n_lin_z, with_wz)


@torch.no_grad()
def pack_weights(mlp, with_wz: bool = True) -> Tuple[Optional[torch.Tensor], ...]:
    """Assemble the kernel's weight tuple from a port ``ResnetFC`` (bf16
    cast and padding), with the tiled image where the kernel takes the
    widths. Without ``with_wz`` the injection weights ``wz`` and ``bz`` are
    left None, for the ``z_is_tz`` variant. The result is kept on the module
    and reused until a parameter is changed, moved or replaced, as its
    storage, device and version counter show: a write that bypasses the
    version counter (through ``p.data``) is not seen."""
    state = tuple((p.data_ptr(), p._version, p.device) for p in mlp.parameters())
    cache = mlp.__dict__.setdefault("_packed_weights", {})
    if with_wz in cache and cache[with_wz][0] == state:
        return cache[with_wz][1]
    bf16 = torch.bfloat16
    dh = mlp.d_hidden
    dev = mlp.lin_out.weight.device
    d_in_pad = _round_up(max(mlp.d_in, 1), LANE)
    win = torch.zeros((dh, d_in_pad), dtype=bf16, device=dev)
    win[:, : mlp.d_in] = mlp.lin_in.weight.to(bf16)
    bin_ = mlp.lin_in.bias.to(bf16)
    wz = bz = None
    if with_wz:
        wz = torch.cat([lin.weight.to(bf16) for lin in mlp.lin_z], dim=0)
        bz = torch.cat([lin.bias.to(bf16) for lin in mlp.lin_z])
    w0 = torch.stack([b.fc_0.weight.to(bf16) for b in mlp.blocks])
    b0 = torch.stack([b.fc_0.bias.to(bf16) for b in mlp.blocks])
    w1 = torch.stack([b.fc_1.weight.to(bf16) for b in mlp.blocks])
    b1 = torch.stack([b.fc_1.bias.to(bf16) for b in mlp.blocks])
    wout = torch.zeros((LANE, dh), dtype=bf16, device=dev)
    wout[: mlp.d_out] = mlp.lin_out.weight.to(bf16)
    bout = torch.zeros((LANE,), dtype=bf16, device=dev)
    bout[: mlp.d_out] = mlp.lin_out.bias.to(bf16)
    packed = PackedWeights((win, bin_, wz, bz, w0, b0, w1, b1, wout, bout))
    n_lin_z = min(mlp.combine_layer, mlp.n_blocks)
    kx = _round_up(max(mlp.d_in, 1), KC)
    try:
        check_kernel_widths(kx, z_tile_width(mlp.d_latent) if with_wz else dh, dh)
    except ValueError:
        pass      # the tuple alone: the plain version takes any widths, a launch raises
    else:
        packed.image = tile_weights(packed, kx, mlp.n_blocks, n_lin_z, with_wz)
        packed.image_key = (kx, mlp.n_blocks, n_lin_z, with_wz)
    cache[with_wz] = (state, packed)
    return packed


def mean_of_views(h: torch.Tensor, views: int, points: int) -> torch.Tensor:
    """The views' mean of bf16 rows ``(SB, views, points)`` x dh, as
    ``torch.mean(dim=1)`` rounds it for a bf16 tensor on the card (ATen's
    ``MeanOps`` for reduced types): the views summed in float32 from 0 in
    view order, times the float32 factor ``1/views``, rounded once to bf16.
    (ATen's factor is ``float(M) / float(views * M)`` for M outputs: 1/views
    wherever those counts are exact in float32. On the CPU ``torch.mean``
    divides the float32 sum by ``views`` instead.)"""
    hv = h.reshape(-1, views, points, h.shape[-1])
    acc = torch.zeros(hv[:, 0].shape, dtype=torch.float32, device=h.device)
    for v in range(views):
        acc = acc + hv[:, v].float()
    scale = torch.tensor(1.0, dtype=torch.float32) / views
    return (acc * scale.to(h.device)).to(torch.bfloat16).reshape(-1, h.shape[-1])


def fused_resnetfc_infer_plain(
    z: torch.Tensor,
    x: torch.Tensor,
    weights: Tuple[torch.Tensor, ...],
    n_blocks: int,
    combine_layer: int,
    z_is_tz: bool = False,
    hidden_max: bool = False,
    views: int = 1,
    points: Optional[int] = None,
):
    """The kernel's function in plain PyTorch. z (N, d_latent), or with
    ``z_is_tz`` the injections (N, n_lin_z*dh), x (N, d_in) bf16 ->
    (N, 4) float32; with ``views`` above 1, N rows ``(SB, views, points)``
    averaged at ``combine_layer`` (:func:`mean_of_views`) -> (N / views, 4).
    With ``hidden_max`` it returns ``(out, m)``, ``m`` float32 the largest
    magnitude each output row's hidden values (h and net; of every view
    before the mean) reach: the scale of one bf16 rounding on that row
    (:func:`disagreement_with_plain`)."""
    win, bin_, wz, bz, w0, b0, w1, b1, wout, bout = weights
    bf16 = torch.bfloat16
    dh = w0.shape[-1]
    peak = [None]

    def dense(a, w, b):
        # float32 accumulation of bf16 products, rounded, then the bias add
        return torch.matmul(a.float(), w.float().t()).to(bf16) + b

    def seen(v):
        if hidden_max:
            m = v.abs().amax(dim=-1).float()
            peak[0] = m if peak[0] is None else torch.maximum(peak[0], m)
        return v

    x = x.to(bf16)
    h = seen(dense(x, win[:, : x.shape[-1]], bin_))
    n_lin_z = min(combine_layer, n_blocks)
    tz = None
    if n_lin_z > 0:
        tz = z.to(bf16) if z_is_tz else dense(z.to(bf16), wz, bz)
    for i in range(n_blocks):
        if views > 1 and i == combine_layer:
            h = mean_of_views(h, views, points)
            if hidden_max:
                peak[0] = peak[0].reshape(-1, views, points).amax(dim=1).reshape(-1)
            seen(h)
        if i < n_lin_z:
            h = seen(h + tz[:, i * dh : (i + 1) * dh])
        net = seen(dense(torch.relu(h), w0[i], b0[i]))
        h = seen(h + dense(torch.relu(net), w1[i], b1[i]))
    out = dense(torch.relu(h), wout[:4], bout[:4]).float()
    return (out, peak[0]) if hidden_max else out


# What the kernels are held to against their plain versions. Both round
# every layer's output to bf16, and their float32 sums run in other orders
# (the tensor cores' accumulation is also coarser than a float32 matmul's),
# so a sum that lies within that error of a bf16 boundary may round the
# other way: one value of that row is then one bf16 ulp off, and the later
# layers carry the difference on, amplified where their gain exceeds 1. The
# plain version held against itself with its hidden units permuted shows the
# same rare outliers (scripts/stress_fused_mlp_torch.py).
MLP_ATOL = MLP_RTOL = 5e-2    # every element, but for the outliers below
MLP_OUTLIER_SHARE = 2e-4      # of the elements may lie outside, each by no more than
MLP_OUTLIER_ULPS = 2.0        # this many bf16 ulps of its row's largest hidden magnitude


def disagreement_with_plain(out: torch.Tensor, ref: torch.Tensor, row_hidden_max: torch.Tensor) -> dict:
    """A fused MLP kernel's (N, 4) output against its plain version's, with
    the plain version's ``hidden_max``: the largest difference, how many
    elements lie outside ``MLP_ATOL + MLP_RTOL * |ref|`` and their share, and
    the worst of those in bf16 ulps of its row's largest hidden magnitude
    (a bf16 ulp of m is 2**(floor(log2 m) - 7))."""
    diff = (out - ref).abs()
    outside = diff > MLP_ATOL + MLP_RTOL * ref.abs()
    ulp = torch.exp2(torch.floor(torch.log2(row_hidden_max.clamp_min(2.0 ** -126))) - 7)
    in_ulps = (diff / ulp[:, None])[outside]
    return {
        "max_abs_err": diff.max().item(),
        "outside": int(outside.sum()),
        "outside_share": outside.float().mean().item(),
        "worst_outlier_ulps": in_ulps.max().item() if in_ulps.numel() else 0.0,
        "finite": bool(torch.isfinite(out).all()),
    }


def agrees_with_plain(d: dict) -> bool:
    """Whether a :func:`disagreement_with_plain` is within the tolerance."""
    return (d["finite"] and d["outside_share"] <= MLP_OUTLIER_SHARE
            and d["worst_outlier_ulps"] <= MLP_OUTLIER_ULPS)


def _check(z, x, weights, n_blocks, combine_layer, z_is_tz=False) -> Tuple[torch.Tensor, ...]:
    """Raise on what the kernel does not take; returns the tensors checked
    (z, x and the weights in use)."""
    if len(weights) != 10:
        raise ValueError(f"expected the 10-array weight tuple, got {len(weights)}")
    win, bin_, wz, bz, w0, b0, w1, b1, wout, bout = weights
    used = tuple(weights[:2]) + (() if z_is_tz else (wz, bz)) + tuple(weights[4:])
    tensors = (z, x) + used
    if any(not isinstance(t, torch.Tensor) for t in tensors):
        raise TypeError("z, x and every weight in use must be tensors")
    if any(t.dtype != torch.bfloat16 for t in tensors):
        raise TypeError("z, x and every weight must be bfloat16")
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on different devices: {devices}")
    if z.dim() != 2 or x.dim() != 2 or z.shape[0] != x.shape[0]:
        raise ValueError(f"z and x must be (N, d): {tuple(z.shape)}, {tuple(x.shape)}")
    dh = win.shape[0]
    n_lin_z = min(combine_layer, n_blocks)
    d_in_pad, d_z = win.shape[1], z.shape[1]
    expect = {
        "win": (win, (dh, d_in_pad)), "bin": (bin_, (dh,)),
        "w0": (w0, (n_blocks, dh, dh)), "b0": (b0, (n_blocks, dh)),
        "w1": (w1, (n_blocks, dh, dh)), "b1": (b1, (n_blocks, dh)),
        "wout": (wout, (LANE, dh)), "bout": (bout, (LANE,)),
    }
    if z_is_tz:
        if d_z != n_lin_z * dh:
            raise ValueError(f"with z_is_tz z must be n_lin_z*d_hidden = {n_lin_z * dh} wide, got {d_z}")
    else:
        expect.update({"wz": (wz, (n_lin_z * dh, d_z)), "bz": (bz, (n_lin_z * dh,))})
    for name, (t, shape) in expect.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    if n_lin_z < 1:
        raise ValueError("the kernel needs at least one latent injection")
    if x.shape[1] > d_in_pad:
        raise ValueError(f"x width {x.shape[1]} exceeds win's {d_in_pad}")
    return tensors


def _check_views(n, n_blocks, combine_layer, z_is_tz, views, points) -> None:
    """Raise on a multi-view call the kernel does not take."""
    if views == 1:
        return
    if not isinstance(views, int) or views < 1:
        raise ValueError(f"views must be a positive int, got {views!r}")
    if z_is_tz:
        raise ValueError("the multi-view mode takes the latents, not baked injections")
    if not 1 <= combine_layer < n_blocks:
        raise ValueError(f"the multi-view mode averages the views at a combine_layer in [1, {n_blocks}), "
                         f"got {combine_layer}")
    if not isinstance(points, int) or points < 1 or n % (views * points):
        raise ValueError(f"{n} rows are not (SB, {views} views, {points} points)")


def check_kernel_shapes(tensors, kx: int, zw: int, dh: int) -> None:
    """The launch-side checks shared by the fused kernels: widths the
    kernel is built for (:func:`check_kernel_widths`), contiguous tensors,
    16-byte aligned weights (``tensors[2:]``)."""
    check_kernel_widths(kx, zw, dh)
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError("the inputs and the weights must be contiguous")
    if any(t.data_ptr() % 16 for t in tensors[2:]):
        raise ValueError("the weights must be 16-byte aligned")


def kernel_weight_pointers(weights) -> Tuple[Optional[int], ...]:
    """What the kernels read of the tuple beside the image: the biases
    ``bin``, ``bz`` (None with ``z_is_tz``), ``b0``, ``b1``, and ``wout``,
    ``bout``."""
    return tuple(None if weights[i] is None else weights[i].data_ptr() for i in (1, 3, 5, 7, 8, 9))


def fused_resnetfc_infer(
    z: torch.Tensor,
    x: torch.Tensor,
    weights: Tuple[torch.Tensor, ...],
    n_blocks: int,
    combine_layer: int,
    z_is_tz: bool = False,
    views: int = 1,
    points: Optional[int] = None,
) -> torch.Tensor:
    """Run the fused MLP: z (N, d_latent), or with ``z_is_tz`` the baked
    injections (N, n_lin_z*dh), x (N, d_in) bf16 -> (N, 4) f32; with
    ``views`` above 1, rows ``(SB, views, points)`` averaged at
    ``combine_layer`` -> (N / views, 4). CUDA tensors launch the kernel; CPU
    tensors run the plain version."""
    tensors = _check(z, x, weights, n_blocks, combine_layer, z_is_tz)
    _check_views(z.shape[0], n_blocks, combine_layer, z_is_tz, views, points)
    if z.device.type == "cpu":
        return fused_resnetfc_infer_plain(z, x, weights, n_blocks, combine_layer, z_is_tz,
                                          views=views, points=points)
    if z.device.type != "cuda":
        raise ValueError(f"unsupported device {z.device}")
    dh = weights[0].shape[0]
    d_z = z.shape[1]
    kx = _round_up(x.shape[1], KC)
    zw = dh if z_is_tz else z_tile_width(d_z)
    n_lin_z = min(combine_layer, n_blocks)
    check_kernel_shapes(tensors, kx, zw, dh)
    if z.data_ptr() % 16 or d_z % 8:
        raise ValueError(f"z must be 16-byte aligned and its rows whole 16-byte units (d_z {d_z})")
    image = weight_image(weights, kx, n_blocks, n_lin_z, with_wz=not z_is_tz)
    lib = _build.load("fused_mlp")
    check_kernel_fits(lib, kx, zw, dh)
    n = z.shape[0]
    out = torch.empty((n // views, 4), dtype=torch.float32, device=z.device)
    scratch, scratch_blocks = None, 0
    if views > 1:
        # a block's saved views: views-1 tiles of 64 rows x dh bf16, for a
        # block per SM or per tile if there are fewer (the launch's grid)
        tiles = n // (views * points) * -(-points // 64)
        scratch_blocks = min(tiles, torch.cuda.get_device_properties(z.device).multi_processor_count)
        scratch = torch.empty((scratch_blocks * (views - 1) * 64 * dh,), dtype=torch.bfloat16, device=z.device)
    fn = lib.fused_resnetfc_infer
    # x, z, the image, six weight arrays, out: 10 pointers; the views, the
    # scratch
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int64] + [ctypes.c_int] * 8 + [
        ctypes.c_int64, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p
    ]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(z.device).cuda_stream
    with torch.cuda.device(z.device):
        err = fn(
            x.data_ptr(), z.data_ptr(), image.data_ptr(), *kernel_weight_pointers(weights),
            out.data_ptr(), n, x.shape[1], kx, d_z, dh, n_blocks, n_lin_z, int(z_is_tz), views,
            points or 0, None if scratch is None else scratch.data_ptr(), scratch_blocks, stream,
        )
    _build.check(err, "fused_resnetfc_infer launch")
    fused_resnetfc_infer.launches += 1
    return out


fused_resnetfc_infer.launches = 0
