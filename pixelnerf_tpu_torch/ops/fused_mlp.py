"""Fused single-view ResnetFC inference: the CUDA kernel
``csrc/fused_mlp.cu`` and its plain PyTorch version.

Counterpart of ``fused_resnetfc_infer`` and ``pack_weights``
(``pixelnerf_tpu/ops/fused_mlp.py``). The packed weight tuple holds the same
ten arrays as the JAX package's, ``(win, bin, wz, bz, w0, b0, w1, b1, wout,
bout)``, with each matrix in torch's ``(out, in)`` layout, i.e. the
transpose of the JAX tuple's ``(in, out)``, and each bias 1-D:

- ``win`` (dh, d_in_pad): lin_in, input columns zero-padded to 128
- ``wz`` (n_lin_z*dh, d_latent): the lin_z injections stacked by rows
- ``w0``/``w1`` (n_blocks, dh, dh): the residual blocks' fc_0/fc_1
- ``wout`` (128, dh): lin_out, output rows zero-padded to 128

Rounding contract (``_mlp_kernel``): every product accumulates in float32,
is rounded to bf16, then the bf16 bias is added; residual adds and the
latent injections are bf16 adds.

With ``z_is_tz`` (the kernel's variant for baked encodings,
``models/pixelnerf.py`` ``bake_encoding``) ``z`` already holds the
injections ``z_raw @ wz.T + bz``, ``n_lin_z * dh`` wide: block ``i`` adds
``z[:, i*dh:(i+1)*dh]`` in bf16 and ``wz``/``bz`` are neither used nor asked
for (they may be None in the tuple).

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


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@torch.no_grad()
def pack_weights(mlp, with_wz: bool = True) -> Tuple[Optional[torch.Tensor], ...]:
    """Assemble the kernel's weight tuple from a port ``ResnetFC`` (bf16
    cast and padding). Without ``with_wz`` the injection weights ``wz`` and
    ``bz`` are left None, for the ``z_is_tz`` variant."""
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
    return win, bin_, wz, bz, w0, b0, w1, b1, wout, bout


def fused_resnetfc_infer_plain(
    z: torch.Tensor,
    x: torch.Tensor,
    weights: Tuple[torch.Tensor, ...],
    n_blocks: int,
    combine_layer: int,
    z_is_tz: bool = False,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch. z (N, d_latent), or with
    ``z_is_tz`` the injections (N, n_lin_z*dh), x (N, d_in) bf16 ->
    (N, 4) float32."""
    win, bin_, wz, bz, w0, b0, w1, b1, wout, bout = weights
    bf16 = torch.bfloat16
    dh = w0.shape[-1]

    def dense(a, w, b):
        # float32 accumulation of bf16 products, rounded, then the bias add
        return torch.matmul(a.float(), w.float().t()).to(bf16) + b

    x = x.to(bf16)
    h = dense(x, win[:, : x.shape[-1]], bin_)
    n_lin_z = min(combine_layer, n_blocks)
    tz = None
    if n_lin_z > 0:
        tz = z.to(bf16) if z_is_tz else dense(z.to(bf16), wz, bz)
    for i in range(n_blocks):
        if i < n_lin_z:
            h = h + tz[:, i * dh : (i + 1) * dh]
        net = dense(torch.relu(h), w0[i], b0[i])
        h = h + dense(torch.relu(net), w1[i], b1[i])
    out = dense(torch.relu(h), wout[:4], bout[:4])
    return out.float()


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


def check_kernel_shapes(tensors, d_in_pad: int, d_z: int, dh: int) -> None:
    """The launch-side checks shared by the fused kernels: widths the
    tensor-core tiles take, contiguous tensors."""
    if d_in_pad % 16 or d_z % 16 or dh % 32:
        raise ValueError(
            f"kernel needs d_in_pad, d_latent multiples of 16 and d_hidden of 32, "
            f"got {d_in_pad}, {d_z}, {dh}"
        )
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError("the inputs and the weights must be contiguous")


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def fused_resnetfc_infer(
    z: torch.Tensor,
    x: torch.Tensor,
    weights: Tuple[torch.Tensor, ...],
    n_blocks: int,
    combine_layer: int,
    z_is_tz: bool = False,
) -> torch.Tensor:
    """Run the fused MLP: z (N, d_latent), or with ``z_is_tz`` the baked
    injections (N, n_lin_z*dh), x (N, d_in) bf16 -> (N, 4) f32. CUDA tensors
    launch the kernel; CPU tensors run the plain version."""
    tensors = _check(z, x, weights, n_blocks, combine_layer, z_is_tz)
    if z.device.type == "cpu":
        return fused_resnetfc_infer_plain(z, x, weights, n_blocks, combine_layer, z_is_tz)
    if z.device.type != "cuda":
        raise ValueError(f"unsupported device {z.device}")
    dh, d_in_pad = weights[0].shape
    d_z = z.shape[1]
    check_kernel_shapes(tensors, d_in_pad, d_z, dh)
    if z.data_ptr() % 16:
        raise ValueError("z must be 16-byte aligned")
    lib = _build.load("fused_mlp")
    smem_fn = lib.fused_resnetfc_smem_bytes
    smem_fn.argtypes = [ctypes.c_int] * 4
    smem_fn.restype = ctypes.c_size_t
    if smem_fn(d_in_pad, d_z, dh, int(z_is_tz)) > SMEM_LIMIT:
        raise ValueError(f"widths ({d_in_pad}, {d_z}, {dh}) exceed the block's shared memory")
    n = z.shape[0]
    out = torch.empty((n, 4), dtype=torch.float32, device=z.device)
    fn = lib.fused_resnetfc_infer
    fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int64] + [ctypes.c_int] * 7 + [
        ctypes.c_void_p
    ]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(z.device).cuda_stream
    with torch.cuda.device(z.device):
        err = fn(
            x.data_ptr(), z.data_ptr(), *(_ptr(w) for w in weights),
            out.data_ptr(), n, x.shape[1], d_in_pad, d_z, dh, n_blocks,
            min(combine_layer, n_blocks), int(z_is_tz), stream,
        )
    _build.check(err, "fused_resnetfc_infer launch")
    fused_resnetfc_infer.launches += 1
    return out


fused_resnetfc_infer.launches = 0
