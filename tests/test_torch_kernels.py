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
from pixelnerf_tpu_torch.ops.fused_field import (
    fused_gather_resnetfc_infer,
    fused_gather_resnetfc_infer_plain,
    gather_prologue_probe,
)
from pixelnerf_tpu_torch.ops.fused_mlp import fused_resnetfc_infer, fused_resnetfc_infer_plain
from pixelnerf_tpu_torch.ops.gather import gather_bilerp, gather_bilerp_plain
from pixelnerf_tpu_torch.ops.gather_rows import (
    GatherRowsLerp,
    gather_rows_lerp,
    gather_rows_lerp_bwd,
    gather_rows_lerp_bwd_plain,
    gather_rows_lerp_plain,
)
from pixelnerf_tpu_torch.ops.gather_study import FORMULATIONS, gather_study, gather_study_plain


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


def _rows_inputs(rows=64, c=16, n=50, seed=0, table_dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    table = torch.randn((rows, c), generator=g).to(table_dtype)
    idx = torch.randint(0, rows, (n, 4), generator=g, dtype=torch.int32)
    w = torch.rand((n, 4), generator=g)
    return table, idx, w


def test_gather_rows_wrappers_on_cpu_run_plain_without_launch():
    table, idx, w = _rows_inputs()
    before = (gather_rows_lerp.launches, gather_rows_lerp_bwd.launches)
    out = gather_rows_lerp(table, idx, w, torch.bfloat16)
    assert out.dtype == torch.bfloat16
    rows = table[idx.long()]                                          # (N, 4, C)
    ref = (w[:, :, None] * rows).sum(1)
    np.testing.assert_allclose(out.float().numpy(), ref.numpy(), atol=3e-2)
    grad_out = torch.randn(out.shape)
    gt, gw = gather_rows_lerp_bwd(table, idx, w, grad_out)
    # the transposes written out: each tap's weighted grad_out scattered
    # into its row, and each tap's row dotted with grad_out
    ref_t = torch.zeros_like(table)
    for n in range(idx.shape[0]):
        for k in range(4):
            ref_t[idx[n, k]] += w[n, k] * grad_out[n]
    np.testing.assert_allclose(gt.numpy(), ref_t.numpy(), atol=1e-5)
    np.testing.assert_allclose(gw.numpy(), (rows * grad_out[:, None]).sum(-1).numpy(), atol=1e-5)
    assert (gather_rows_lerp.launches, gather_rows_lerp_bwd.launches) == before


@pytest.mark.parametrize(
    "case", ["table_int", "idx_int64", "w_f64", "idx_shape", "w_rows", "channels", "out_f16", "grad_shape"]
)
def test_gather_rows_wrappers_reject_bad_inputs(case):
    table, idx, w = _rows_inputs(c=8, n=5)
    out_dtype = torch.float32
    grad_out = torch.zeros((5, 8))
    if case == "table_int":
        table = table.to(torch.int32)
    elif case == "idx_int64":
        idx = idx.long()
    elif case == "w_f64":
        w = w.double()
    elif case == "idx_shape":
        idx = idx[:, :2]
    elif case == "w_rows":
        w = w[:4]
    elif case == "channels":
        table = torch.zeros((64, 6))
        grad_out = torch.zeros((5, 6))
    elif case == "out_f16":
        out_dtype = torch.float16
        grad_out = torch.zeros((5, 8), dtype=torch.float16)
    elif case == "grad_shape":
        grad_out = torch.zeros((5, 16))
    before = (gather_rows_lerp.launches, gather_rows_lerp_bwd.launches)
    with pytest.raises((TypeError, ValueError)):
        if case == "grad_shape":
            gather_rows_lerp_bwd(table, idx, w, grad_out)
        else:
            gather_rows_lerp(table, idx, w, out_dtype)
            gather_rows_lerp_bwd(table, idx, w, grad_out)
    assert (gather_rows_lerp.launches, gather_rows_lerp_bwd.launches) == before


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


@pytest.mark.cuda
@pytest.mark.parametrize("table_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_gather_rows_kernel_matches_plain_cuda(cuda_device, table_dtype, out_dtype):
    table, idx, w = _rows_inputs(rows=2 * 16 * 16, c=512, n=1000, table_dtype=table_dtype)
    args = [a.to(cuda_device) for a in (table, idx, w)]
    out = gather_rows_lerp(*args, out_dtype)
    torch.cuda.synchronize()
    ref = gather_rows_lerp_plain(*args, out_dtype)
    # no contracted multiply-adds in the kernel: bit-equal
    torch.testing.assert_close(out, ref, atol=0, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("table_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_gather_rows_bwd_kernel_matches_plain_cuda(cuda_device, table_dtype, out_dtype):
    # few rows, many points: every row takes many atomic adds
    table, idx, w = _rows_inputs(rows=64, c=512, n=4000, table_dtype=table_dtype)
    grad_out = torch.randn((4000, 512), generator=torch.Generator().manual_seed(3)).to(out_dtype)
    args = [a.to(cuda_device) for a in (table, idx, w, grad_out)]
    gt, gw = gather_rows_lerp_bwd(*args)
    torch.cuda.synchronize()
    rt, rw = gather_rows_lerp_bwd_plain(*args)
    # float32 sums in another order (atomics; a warp's shuffle tree): a few
    # float32 ulps of the largest entry, plus half a bf16 ulp where the
    # table gradient is stored in bf16
    tol_t = (1e-5 if table_dtype == torch.float32 else 8e-3) * rt.float().abs().max().item()
    assert (gt.float() - rt.float()).abs().max().item() <= tol_t
    assert (gw - rw).abs().max().item() <= 1e-5 * rw.abs().max().item()
    # one output alone
    gt_only, none = gather_rows_lerp_bwd(*args, want_w=False)
    assert none is None and (gt_only.float() - rt.float()).abs().max().item() <= tol_t


@pytest.mark.cuda
def test_gather_rows_autograd_launches_both_kernels_cuda(cuda_device):
    table, idx, w = _rows_inputs(rows=256, c=64, n=300)
    table = table.to(cuda_device).requires_grad_()
    w = w.to(cuda_device).requires_grad_()
    idx = idx.to(cuda_device)
    before = (gather_rows_lerp.launches, gather_rows_lerp_bwd.launches)
    out = GatherRowsLerp.apply(table, idx, w, torch.float32, True)
    gt, gw = torch.autograd.grad(out.square().sum(), (table, w))
    assert (gather_rows_lerp.launches, gather_rows_lerp_bwd.launches) == (before[0] + 1, before[1] + 1)
    out_p = GatherRowsLerp.apply(table, idx, w, torch.float32, False)
    pt, pw = torch.autograd.grad(out_p.square().sum(), (table, w))
    torch.testing.assert_close(out, out_p, atol=0, rtol=0)
    torch.testing.assert_close(gt, pt, atol=1e-5 * pt.abs().max().item(), rtol=0)
    torch.testing.assert_close(gw, pw, atol=1e-5 * pw.abs().max().item(), rtol=0)


@pytest.mark.cuda
def test_gather_kernel_wide_rows_cuda(cuda_device):
    """Kernel A on rows as wide as a baked injection map (3 x 512)."""
    g = torch.Generator().manual_seed(0)
    hh = ww = 16
    table = torch.randn((hh * ww, 1536), generator=g).to(torch.bfloat16)
    ix = torch.rand(1000, generator=g) * (ww - 1)
    iy = torch.rand(1000, generator=g) * (hh - 1)
    ix[:50], iy[25:75] = ww - 1, hh - 1        # the right and bottom borders
    base, w = tgs.bilinear_pair_bases(ix, iy, hh, ww)
    args = [a.to(cuda_device) for a in (table, base, w)]
    out = gather_bilerp(*args, ww, torch.bfloat16)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, gather_bilerp_plain(*args, ww, torch.bfloat16), atol=0, rtol=0)


@pytest.mark.cuda
def test_fused_mlp_tz_kernel_matches_plain_cuda(cuda_device):
    weights = _mlp_weights(dh=64, d_in=42, d_z=64, n_blocks=5, combine_layer=3)
    weights = tuple(w.to(cuda_device) for w in weights[:2]) + (None, None) + tuple(
        w.to(cuda_device) for w in weights[4:])
    g = torch.Generator().manual_seed(1)
    tz = torch.randn((300, 3 * 64), generator=g).to(torch.bfloat16).to(cuda_device)
    x = torch.randn((300, 42), generator=g).to(torch.bfloat16).to(cuda_device)
    before = fused_resnetfc_infer.launches
    out = fused_resnetfc_infer(tz, x, weights, 5, 3, z_is_tz=True)
    torch.cuda.synchronize()
    assert fused_resnetfc_infer.launches == before + 1
    ref = fused_resnetfc_infer_plain(tz, x, weights, 5, 3, z_is_tz=True)
    # as the unbaked kernel: float32 sums in other orders may flip a bf16 rounding
    torch.testing.assert_close(out, ref, atol=5e-2, rtol=5e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [64, 256, 700])
def test_fused_field_kernel_matches_composition_and_plain_cuda(cuda_device, n):
    """Kernel D equals kernel B fed by kernel A bit for bit, and its plain
    version within kernel B's tolerance; points on the right and bottom
    borders and exact corners included."""
    g = torch.Generator().manual_seed(2)
    hh = ww = 9
    c = 128
    weights = tuple(w.to(cuda_device) for w in _mlp_weights(dh=64, d_in=42, d_z=c, n_blocks=5, combine_layer=3))
    table = torch.randn((hh * ww, c), generator=g).to(torch.bfloat16)
    ix = torch.rand(n, generator=g) * (ww - 1)
    iy = torch.rand(n, generator=g) * (hh - 1)
    ix[:10], iy[5:15] = ww - 1, hh - 1
    ix[15:20], iy[15:20] = torch.arange(5.0), torch.arange(5.0)
    base, wg = tgs.bilinear_pair_bases(ix, iy, hh, ww)
    x = torch.randn((n, 42), generator=g).to(torch.bfloat16)
    table, base, wg, x = (a.to(cuda_device) for a in (table, base, wg, x))
    before = fused_gather_resnetfc_infer.launches
    out = fused_gather_resnetfc_infer(table, base, wg, x, weights, 5, 3, ww)
    torch.cuda.synchronize()
    assert fused_gather_resnetfc_infer.launches == before + 1
    z = gather_bilerp(table, base, wg, ww, torch.bfloat16)
    torch.testing.assert_close(out, fused_resnetfc_infer(z, x, weights, 5, 3), atol=0, rtol=0)
    ref = fused_gather_resnetfc_infer_plain(table, base, wg, x, weights, 5, 3, ww)
    torch.testing.assert_close(out, ref, atol=5e-2, rtol=5e-2)
    # the prologue alone leaves the gathered latents' first channels
    probe = gather_prologue_probe(table, base, wg, x, weights, 5, 3, ww)
    torch.testing.assert_close(probe, z[:, :4].float(), atol=0, rtol=0)
    assert fused_gather_resnetfc_infer.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("table_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("formulation", sorted(FORMULATIONS))
def test_gather_study_kernels_match_plain_cuda(cuda_device, formulation, table_dtype):
    # 1000 points: off every tile size
    table, idx, w = _rows_inputs(rows=256, c=512, n=1000, table_dtype=table_dtype)
    args = [a.to(cuda_device) for a in (table, idx, w)]
    before = gather_study.launches[formulation]
    out = gather_study(*args, formulation, tile=128)
    torch.cuda.synchronize()
    assert gather_study.launches[formulation] == before + 1
    # no contracted multiply-adds in the kernels: bit-equal
    torch.testing.assert_close(out, gather_study_plain(*args), atol=0, rtol=0)
