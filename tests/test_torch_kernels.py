"""The CUDA kernels' wrappers: input checks before any launch and the plain
path for CPU tensors (run here), and each kernel against its plain version
on the card (marked ``cuda``; they skip without a GPU).

This file imports torch and the port only, so that it runs on a machine
with a card and no JAX: ``python -m pytest --noconftest -m cuda
tests/test_torch_kernels.py``.
"""
import numpy as np
import pytest
import torch

from pixelnerf_tpu_torch.ops import grid_sample as tgs
from pixelnerf_tpu_torch.ops.fused_mlp import fused_resnetfc_infer, fused_resnetfc_infer_plain
from pixelnerf_tpu_torch.ops.gather import gather_bilerp, gather_bilerp_plain


def _pair_inputs(hh=16, ww=16, c=128, p=300, seed=0):
    rng = np.random.default_rng(seed)
    grid = rng.uniform(-1.2, 1.2, (p, 2)).astype(np.float32)
    feats = rng.normal(size=(hh, ww, c)).astype(np.float32)
    return feats, grid


def test_gather_wrapper_on_cpu_runs_plain_without_launch():
    feats, grid = _pair_inputs(c=16, p=40)
    hh, ww, c = feats.shape
    table = torch.from_numpy(feats).reshape(hh * ww, c)
    ix = tgs._compute_source_index(torch.from_numpy(grid[:, 0]), ww, "border", True)
    iy = tgs._compute_source_index(torch.from_numpy(grid[:, 1]), hh, "border", True)
    base, w = tgs.bilinear_pair_bases(ix, iy, hh, ww)
    before = gather_bilerp.launches
    out = gather_bilerp(table, base, w, ww, torch.bfloat16)
    assert gather_bilerp.launches == before
    assert out.dtype == torch.bfloat16
    ref = tgs.grid_sample(torch.from_numpy(feats)[None], torch.from_numpy(grid)[None])[0]
    # bf16 output of the float32 lerp: half an ulp of bf16 at |x| < 4
    np.testing.assert_allclose(out.float().numpy(), ref.numpy(), atol=2e-2)


def _good_gather_args():
    table = torch.zeros((16, 8))
    base = torch.zeros((5, 2), dtype=torch.int32)
    w = torch.zeros((5, 2))
    return table, base, w


@pytest.mark.parametrize(
    "case",
    ["table_int", "base_int64", "w_f64", "base_shape", "w_rows", "width", "channels", "out_f16", "table_1d"],
)
def test_gather_wrapper_rejects_bad_inputs(case):
    table, base, w = _good_gather_args()
    width, out_dtype = 4, torch.float32
    if case == "table_int":
        table = table.to(torch.int32)
    elif case == "base_int64":
        base = base.to(torch.int64)
    elif case == "w_f64":
        w = w.double()
    elif case == "base_shape":
        base = torch.zeros((5, 3), dtype=torch.int32)
    elif case == "w_rows":
        w = torch.zeros((4, 2))
    elif case == "width":
        width = 5
    elif case == "channels":
        table = torch.zeros((16, 6))
    elif case == "out_f16":
        out_dtype = torch.float16
    elif case == "table_1d":
        table = torch.zeros(128)
    before = gather_bilerp.launches
    with pytest.raises((TypeError, ValueError)):
        gather_bilerp(table, base, w, width, out_dtype)
    assert gather_bilerp.launches == before


def _mlp_weights(dh=32, d_in=10, d_z=16, n_blocks=3, combine_layer=2, seed=0):
    g = torch.Generator().manual_seed(seed)
    bf = torch.bfloat16
    n_lin_z = min(combine_layer, n_blocks)

    def r(*shape):
        return (torch.randn(shape, generator=g) * 0.2).to(bf)

    win = torch.zeros((dh, 128), dtype=bf)
    win[:, :d_in] = r(dh, d_in)
    wout = torch.zeros((128, dh), dtype=bf)
    wout[:4] = r(4, dh)
    bout = torch.zeros(128, dtype=bf)
    bout[:4] = r(4)
    return (win, r(dh), r(n_lin_z * dh, d_z), r(n_lin_z * dh), r(n_blocks, dh, dh),
            r(n_blocks, dh), r(n_blocks, dh, dh), r(n_blocks, dh), wout, bout)


@pytest.mark.parametrize(
    "case", ["z_f32", "x_f32", "weight_f32", "wz_shape", "rows", "x_too_wide", "nine_weights"]
)
def test_fused_mlp_wrapper_rejects_bad_inputs(case):
    weights = list(_mlp_weights())
    z = torch.zeros((7, 16), dtype=torch.bfloat16)
    x = torch.zeros((7, 10), dtype=torch.bfloat16)
    if case == "z_f32":
        z = z.float()
    elif case == "x_f32":
        x = x.float()
    elif case == "weight_f32":
        weights[4] = weights[4].float()
    elif case == "wz_shape":
        weights[2] = weights[2][:, :8]
    elif case == "rows":
        x = x[:6]
    elif case == "x_too_wide":
        x = torch.zeros((7, 130), dtype=torch.bfloat16)
    elif case == "nine_weights":
        weights = weights[:9]
    before = fused_resnetfc_infer.launches
    with pytest.raises((TypeError, ValueError)):
        fused_resnetfc_infer(z, x, tuple(weights), 3, 2)
    assert fused_resnetfc_infer.launches == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("table_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_gather_kernel_matches_plain_cuda(cuda_device, table_dtype, out_dtype):
    g = torch.Generator().manual_seed(0)
    hh = ww = 16
    c = 512
    table = torch.randn((2 * hh * ww, c), generator=g).to(table_dtype)
    ix = torch.rand(1000, generator=g) * (ww - 1)
    iy = torch.rand(1000, generator=g) * (hh - 1)
    base, w = tgs.bilinear_pair_bases(ix, iy, hh, ww)
    base[500:] += hh * ww   # second view
    args = [a.to(cuda_device) for a in (table, base, w)]
    out = gather_bilerp(*args, ww, out_dtype)
    torch.cuda.synchronize()
    ref = gather_bilerp_plain(*args, ww, out_dtype)
    # no contracted multiply-adds in the kernel: bit-equal
    torch.testing.assert_close(out, ref, atol=0, rtol=0)


@pytest.mark.cuda
def test_fused_mlp_kernel_matches_plain_cuda(cuda_device):
    weights = tuple(w.to(cuda_device) for w in _mlp_weights(dh=64, d_in=42, d_z=64, n_blocks=5, combine_layer=3))
    g = torch.Generator().manual_seed(1)
    z = torch.randn((300, 64), generator=g).to(torch.bfloat16).to(cuda_device)
    x = torch.randn((300, 42), generator=g).to(torch.bfloat16).to(cuda_device)
    out = fused_resnetfc_infer(z, x, weights, 5, 3)
    torch.cuda.synchronize()
    ref = fused_resnetfc_infer_plain(z, x, weights, 5, 3)
    # both accumulate bf16 products in float32, in other orders; a rounding
    # flip of one bf16 intermediate moves an output by a few bf16 ulps
    torch.testing.assert_close(out, ref, atol=5e-2, rtol=5e-2)
