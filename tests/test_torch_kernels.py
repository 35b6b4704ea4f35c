"""The CUDA kernels' wrappers: input checks before any launch and the plain
path for CPU tensors (run here), and each kernel against its plain version
on the card (marked ``cuda``; they skip without a GPU).

This file imports torch and the port only, so that it runs on a machine
with a card and no JAX: ``python -m pytest --noconftest -m cuda
tests/test_torch_kernels.py``.
"""
import functools
import math
import os

import numpy as np
import pytest
import torch

from pixelnerf_tpu_torch.ops import grid_sample as tgs
from pixelnerf_tpu_torch.ops.fused_field import (
    fused_gather_resnetfc_infer,
    fused_gather_resnetfc_infer_plain,
)
from pixelnerf_tpu_torch.ops import fused_mlp as fm
from pixelnerf_tpu_torch.ops.fused_mlp import fused_resnetfc_infer, fused_resnetfc_infer_plain
from pixelnerf_tpu_torch.ops.gather import gather_bilerp, gather_bilerp_plain
from pixelnerf_tpu_torch.ops.gather_rows import (
    GatherRowsLerp,
    gather_rows_lerp,
    gather_rows_lerp_bwd,
    gather_rows_lerp_bwd_plain,
    gather_rows_lerp_plain,
    row_owner_bwd_plain,
    row_owner_plan,
    row_owner_plan_plain,
)
from pixelnerf_tpu_torch.ops.gather_study import (
    FORMULATIONS,
    block_stage_plan,
    block_stage_plan_plain,
    gather_study,
    gather_study_plain,
)


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


def _mlp_weights(dh=32, d_in=10, d_z=16, n_blocks=3, combine_layer=2, seed=0, scale=0.2):
    g = torch.Generator().manual_seed(seed)
    bf = torch.bfloat16
    n_lin_z = min(combine_layer, n_blocks)

    def r(*shape):
        return (torch.randn(shape, generator=g) * scale).to(bf)

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


def _untiled_offsets(dh, k):
    """Where element (n, kk) of a (dh, k) matrix lies in its tiled image,
    written out from the kernel's walk: a warpgroup owns half the columns,
    in slabs of at most 128; the slabs follow each other by (slab, 64-wide
    chunk of K, warpgroup); a slab row is 64 elements, its 8-element units
    XOR-ed with the row."""
    n, kk = np.meshgrid(np.arange(dh), np.arange(k), indexing="ij")
    ni = min(dh // 2, 128)
    wg, slab, row = n // (dh // 2), (n % (dh // 2)) // ni, n % ni
    chunk, unit, elem = kk // 64, (kk % 64) // 8, kk % 8
    return (((slab * (k // 64) + chunk) * 2 + wg) * ni + row) * 64 + ((unit ^ (row % 8)) * 8) + elem


@pytest.mark.parametrize("dh,d_z,with_wz", [(512, 512, True), (512, 512, False), (64, 64, True),
                                            (64, 128, True), (128, 64, True), (256, 192, False)])
def test_tiled_image_untiles_to_every_matrix(dh, d_z, with_wz):
    """The kernel's image of the weights, read back through an index
    formula of its own, is every matrix of the ten-array tuple exactly, at
    the SRN widths and at the tests' widths; the tuple is what it was."""
    n_blocks, n_lin_z, kx = 5, 3, 64
    weights = _mlp_weights(dh=dh, d_in=42, d_z=d_z, n_blocks=n_blocks, combine_layer=n_lin_z, seed=3)
    image = fm.tile_weights(weights, kx, n_blocks, n_lin_z, with_wz).view(torch.int16).numpy()
    win, _, wz, _, w0, _, w1, _, _, _ = (w.view(torch.int16).numpy() for w in weights)
    mats = [win[:, :kx]]
    for i in range(n_blocks):
        if with_wz and i < n_lin_z:
            mats.append(wz[i * dh:(i + 1) * dh])
        mats += [w0[i], w1[i]]
    assert image.size == sum(m.size for m in mats)
    start = 0
    for m in mats:
        np.testing.assert_array_equal(image[start + _untiled_offsets(*m.shape)], m)
        start += m.size


def test_pack_weights_keeps_the_tuple_and_carries_the_image():
    from pixelnerf_tpu_torch.models.resnetfc import ResnetFC

    mlp = ResnetFC(d_in=42, d_latent=64, d_hidden=64, n_blocks=5, combine_layer=3, dtype=torch.bfloat16)
    with torch.no_grad():
        for p in mlp.parameters():
            p.copy_(torch.randn(p.shape, generator=torch.Generator().manual_seed(p.numel())) * 0.1)
    packed = fm.pack_weights(mlp)
    assert isinstance(packed, tuple) and len(packed) == 10
    win, bin_, wz, bz, w0, b0, w1, b1, wout, bout = packed
    bf = torch.bfloat16
    assert win.shape == (64, 128) and wout.shape == (128, 64) and bout.shape == (128,)
    assert torch.equal(win[:, :42], mlp.lin_in.weight.to(bf)) and not win[:, 42:].any()
    assert torch.equal(wz, torch.cat([l.weight.to(bf) for l in mlp.lin_z]))
    assert torch.equal(w1[4], mlp.blocks[4].fc_1.weight.to(bf)) and torch.equal(b0[2], mlp.blocks[2].fc_0.bias.to(bf))
    assert torch.equal(wout[:4], mlp.lin_out.weight.to(bf)) and not wout[4:].any()
    assert packed.image_key == (64, 5, 3, True)
    assert torch.equal(packed.image, fm.tile_weights(tuple(packed), 64, 5, 3, True))
    assert fm.weight_image(packed, 64, 5, 3, True) is packed.image
    # built once per model, and again when a parameter changes
    assert fm.pack_weights(mlp) is packed
    baked = fm.pack_weights(mlp, with_wz=False)
    assert baked[2] is None and baked[3] is None and baked.image.numel() < packed.image.numel()
    with torch.no_grad():
        mlp.lin_in.bias.add_(1.0)
    again = fm.pack_weights(mlp)
    assert again is not packed and torch.equal(again[1], mlp.lin_in.bias.to(bf))
    # widths the kernel is not built for: the tuple alone
    odd = fm.pack_weights(ResnetFC(d_in=10, d_latent=16, d_hidden=32, n_blocks=3, combine_layer=2,
                                   dtype=torch.bfloat16))
    assert len(odd) == 10 and odd.image is None


def test_kernel_widths_at_the_srn_and_test_widths():
    for kx, zw, dh in [(64, 512, 512), (64, 64, 64), (64, 128, 64), (128, 256, 256), (64, 192, 128)]:
        fm.check_kernel_widths(kx, zw, dh)
    # a warpgroup's half of the columns, in slabs of at most 128
    assert [fm.slab_columns(dh) for dh in fm.KERNEL_WIDTHS] == [32, 64, 128, 128]


@pytest.mark.parametrize("kx,zw,dh", [(64, 512, 96), (64, 64, 32), (64, 48, 64), (48, 64, 64),
                                      (64, 512, 384), (64, 512, 1024), (0, 64, 64)])
def test_kernel_refuses_widths_it_is_not_built_for(kx, zw, dh):
    with pytest.raises(ValueError, match="fused MLP kernel"):
        fm.check_kernel_widths(kx, zw, dh)
    tensors = (torch.zeros(4, 8), torch.zeros(4, 8), torch.zeros(16, 8))
    with pytest.raises(ValueError, match="fused MLP kernel"):
        fm.check_kernel_shapes(tensors, kx, zw, dh)


@pytest.mark.parametrize("case", ["tz", "combine_last", "combine_0", "points", "rows", "views_0"])
def test_fused_mlp_wrapper_rejects_bad_views(case):
    """The multi-view mode's checks, before any launch: baked injections,
    a combine layer it cannot average at, rows that are not (SB, views,
    points)."""
    weights = good = _mlp_weights(dh=32, d_in=10, d_z=16, n_blocks=3, combine_layer=2)
    z = good_z = torch.zeros((2 * 3 * 5, 16), dtype=torch.bfloat16)
    x = torch.zeros((30, 10), dtype=torch.bfloat16)
    kw = dict(views=3, points=5)
    n_blocks, combine = 3, 2
    if case == "tz":
        weights = weights[:2] + (None, None) + weights[4:]
        z = torch.zeros((30, 64), dtype=torch.bfloat16)
        kw["z_is_tz"] = True
    elif case == "combine_last":
        combine = 3
    elif case == "combine_0":
        combine = 0
    elif case == "points":
        kw["points"] = None
    elif case == "rows":
        kw["points"] = 4
    elif case == "views_0":
        kw["views"] = 0
    before = fused_resnetfc_infer.launches
    with pytest.raises(ValueError):
        fused_resnetfc_infer(z, x, weights, n_blocks, combine, **kw)
    assert fused_resnetfc_infer.launches == before
    assert fused_resnetfc_infer(good_z, x, good, 3, 2, views=3, points=5).shape == (10, 4)


def test_resnetfc_gate_has_no_width_term():
    """Widths the kernel is not built for pass the gate like any other (on
    the CPU the plain version takes them; on the card the wrapper raises):
    ``fast=True`` never gives way to the dense chain for a width."""
    from pixelnerf_tpu_torch.models.resnetfc import ResnetFC

    mlp = ResnetFC(d_in=10, d_latent=48, d_hidden=96, n_blocks=3, combine_layer=2, dtype=torch.bfloat16)
    assert mlp._can_use_kernel(single_view=True)
    with pytest.raises(ValueError):
        fm.check_kernel_widths(64, 48, 96)
    g = torch.Generator().manual_seed(0)
    z, x = torch.randn((20, 48), generator=g), torch.randn((20, 10), generator=g)
    before = fused_resnetfc_infer.launches
    with torch.no_grad():
        out = mlp((z, x), fast=True)
        ref = fused_resnetfc_infer_plain(z.to(torch.bfloat16), x.to(torch.bfloat16), fm.pack_weights(mlp), 3, 2)
    assert torch.equal(out, ref) and fused_resnetfc_infer.launches == before


def test_check_kernel_shapes_wants_contiguous_aligned_weights():
    ok = (torch.zeros(4, 8), torch.zeros(4, 8), torch.zeros(64, 64, dtype=torch.bfloat16))
    fm.check_kernel_shapes(ok, 64, 64, 64)
    with pytest.raises(ValueError, match="contiguous"):
        fm.check_kernel_shapes(ok[:2] + (ok[2].t(),), 64, 64, 64)
    with pytest.raises(ValueError, match="aligned"):
        fm.check_kernel_shapes(ok[:2] + (ok[2].reshape(-1)[1:65],), 64, 64, 64)


@pytest.mark.parametrize("mode", ["b", "tz", "d", "mv"])
def test_stress_script_cases_on_cpu(mode):
    """The cases of ``scripts/stress_fused_mlp_torch.py`` are well-formed
    inputs of the wrappers: on the CPU each runs its plain version (the
    multi-view case: 33 points of 3 views)."""
    stress = _stress_module()
    run, plain, args = stress.make_case(mode, 64, 100, torch.device("cpu"), torch.Generator().manual_seed(0))
    out = run(*args)
    assert out.shape == (33 if mode == "mv" else 100, 4) and torch.isfinite(out).all() and out.std() > 0
    assert torch.equal(out, plain(*args))
    if mode == "mv":
        first = run(*args)
        kernel, reordered, _ = stress.against_plain(mode, args, first, chunk=30)
        assert kernel["outside"] == 0 and kernel["max_abs_err"] == 0.0
        assert reordered["finite"] and reordered["max_abs_err"] < 5e-2


def _stress_module():
    import os
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts"))
    import stress_fused_mlp_torch as stress

    return stress


@pytest.mark.parametrize("mode", ["b", "tz", "d"])
def test_reordered_plain_is_the_same_function(mode):
    """The stress script's yardstick for rounding flips: the plain version
    with its hidden units permuted computes the same function (in float64
    to float32 rounding; in bf16 within the kernels' own tolerance)."""
    stress = _stress_module()
    run, _, args = stress.make_case(mode, 64, 500, torch.device("cpu"), torch.Generator().manual_seed(0))
    z, x, weights, tz = stress.mlp_inputs(mode, args)
    perm = torch.randperm(64, generator=torch.Generator().manual_seed(1))
    w_perm, z_perm = stress.reordered(z, weights, tz, perm)
    assert all((a is None) == (b is None) and (a is None or a.shape == b.shape) for a, b in zip(weights, w_perm))
    assert not torch.equal(w_perm[4], weights[4])
    ref, peak = fused_resnetfc_infer_plain(z, x, weights, 5, 3, tz, hidden_max=True)
    assert torch.equal(ref, run(*args))
    other = fused_resnetfc_infer_plain(z_perm, x, w_perm, 5, 3, tz)
    assert fm.agrees_with_plain(fm.disagreement_with_plain(other, ref, peak))
    np.testing.assert_allclose(other.numpy(), ref.numpy(), atol=5e-2, rtol=5e-2)


def test_plain_hidden_max_is_the_rows_largest_hidden_magnitude():
    weights = _mlp_weights(dh=64, d_in=42, d_z=64, n_blocks=5, combine_layer=3)
    g = torch.Generator().manual_seed(1)
    z = torch.randn((50, 64), generator=g).to(torch.bfloat16)
    x = torch.randn((50, 42), generator=g).to(torch.bfloat16)
    out, peak = fused_resnetfc_infer_plain(z, x, weights, 5, 3, hidden_max=True)
    assert torch.equal(out, fused_resnetfc_infer_plain(z, x, weights, 5, 3))
    assert peak.shape == (50,) and peak.dtype == torch.float32
    # the chain written out once more, keeping every hidden value
    win, bin_, wz, bz, w0, b0, w1, b1, _, _ = weights
    bf = torch.bfloat16
    dense = lambda a, w, b: (a.float() @ w.float().t()).to(bf) + b
    h = dense(x, win[:, :42], bin_)
    tz = dense(z, wz, bz)
    hidden = [h]
    for i in range(5):
        if i < 3:
            h = h + tz[:, i * 64:(i + 1) * 64]
            hidden.append(h)
        net = dense(torch.relu(h), w0[i], b0[i])
        h = h + dense(torch.relu(net), w1[i], b1[i])
        hidden += [net, h]
    assert torch.equal(peak, torch.stack(hidden).abs().amax(dim=(0, 2)).float())


def test_disagreement_with_plain_counts_outliers_in_hidden_ulps():
    ref = torch.zeros((10000, 4))
    peak = torch.full((10000,), 100.0)          # a bf16 ulp at 100 is 0.5
    out = ref.clone()
    out[0, 0], out[1, 1], out[2, 2] = 0.04, 0.25, -0.5
    d = fm.disagreement_with_plain(out, ref, peak)
    assert d["outside"] == 2 and d["max_abs_err"] == 0.5 and d["worst_outlier_ulps"] == 1.0 and d["finite"]
    assert fm.agrees_with_plain(d)
    peak[2] = 30.0                               # an ulp of 0.125: the same difference is four
    assert not fm.agrees_with_plain(fm.disagreement_with_plain(out, ref, peak))
    peak[2] = 100.0
    out[3:12, 3] = 0.2                           # 11 of 40,000 outside: more than the share allows
    d = fm.disagreement_with_plain(out, ref, peak)
    assert d["outside"] == 11 and d["worst_outlier_ulps"] == 1.0 and not fm.agrees_with_plain(d)
    out = ref.clone()
    out[5, 0] = float("nan")
    assert not fm.agrees_with_plain(fm.disagreement_with_plain(out, ref, peak))
    exact = fm.disagreement_with_plain(ref, ref, peak)
    assert exact["outside"] == 0 and exact["worst_outlier_ulps"] == 0.0 and fm.agrees_with_plain(exact)


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


def _row_owner_case(case, chunk, c=16):
    """(table, idx, w, grad_out, want_table, want_w) of one case of the
    row-owner backward, from a seeded numpy generator."""
    rng = np.random.default_rng(7)
    rows, n = 64, 700
    want_table = want_w = True
    if case in ("n1", "n7"):
        n = int(case[1:])
    elif case == "empty_rows":
        rows, n = 256, 20          # most rows take no entry
    elif case == "many_rows":
        rows, n = 140 * 1024 + 5, 3000   # the scan's blocks take two tiles each
    if case == "count_t":
        # row 0 takes exactly `chunk` entries, row 1 `chunk + 1`
        flat = np.concatenate([np.zeros(chunk), np.ones(chunk + 1), rng.integers(2, rows, 4 * n - 2 * chunk - 1)])
        idx = rng.permutation(flat).reshape(n, 4)
    elif case == "one_row_most":
        idx = np.where(rng.uniform(size=(n, 4)) < 0.9, 3, rng.integers(0, rows, (n, 4)))
    elif case == "border":
        # points on the right and bottom borders: bilinear_corners clamps
        # their second taps onto the first
        hh = ww = 8
        rows = hh * ww
        ix = np.where(rng.uniform(size=n) < 0.5, ww - 1.0, rng.uniform(0, ww - 1, n)).astype(np.float32)
        iy = np.where(rng.uniform(size=n) < 0.5, hh - 1.0, rng.uniform(0, hh - 1, n)).astype(np.float32)
        idx, w = tgs.bilinear_corners(torch.from_numpy(ix), torch.from_numpy(iy), hh, ww)
        idx, w = idx.numpy(), w.numpy()
        assert (idx[:, 0] == idx[:, 1]).any() and (idx[:, 0] == idx[:, 2]).any()
    else:
        idx = rng.integers(0, rows, (n, 4))
    if case != "border":
        w = rng.uniform(size=(n, 4))
    if case == "table_only":
        want_w = False
    elif case == "w_only":
        want_table = False
    table = torch.from_numpy(rng.normal(size=(rows, c)).astype(np.float32))
    if case == "bf16":
        table = table.to(torch.bfloat16)
    grad_out = torch.from_numpy(rng.normal(size=(n, c)).astype(np.float32))
    return (table, torch.from_numpy(idx.astype(np.int32)), torch.from_numpy(w.astype(np.float32)), grad_out,
            want_table, want_w)


ROW_OWNER_CASES = ["n1", "n7", "n700", "empty_rows", "many_rows", "count_t", "one_row_most", "border", "table_only",
                   "w_only", "bf16"]


@pytest.mark.parametrize("chunk", [4, 64])
@pytest.mark.parametrize("case", ROW_OWNER_CASES)
def test_row_owner_mirror_matches_plain(case, chunk):
    table, idx, w, grad_out, want_table, want_w = _row_owner_case(case, chunk)
    gt, gw = row_owner_bwd_plain(table, idx, w, grad_out, chunk, want_table, want_w)
    rt, rw = gather_rows_lerp_bwd_plain(table, idx, w, grad_out, want_table, want_w)
    assert (gt is None) == (rt is None) and (gw is None) == (rw is None)
    if rt is not None:
        assert gt.dtype == table.dtype and gt.shape == table.shape
        # float32 sums in another order: a few float32 ulps of the largest
        # entry, plus one bf16 rounding that may fall the other way (2^-8
        # of the entry) where the table is bf16
        tol = (8e-3 if table.dtype == torch.bfloat16 else 1e-5) * rt.float().abs().max().item()
        assert (gt.float() - rt.float()).abs().max().item() <= tol
    if rw is not None:
        torch.testing.assert_close(gw, rw, atol=1e-5 * rw.abs().max().item(), rtol=0)


@pytest.mark.parametrize("chunk", [4, 64])
@pytest.mark.parametrize("case", ["n7", "empty_rows", "count_t", "one_row_most"])
def test_row_owner_plan_covers_each_entry_once(case, chunk):
    table, idx, *_ = _row_owner_case(case, chunk)
    rows = table.shape[0]
    plan = {k: v.long() for k, v in row_owner_plan_plain(idx, rows, chunk).items()}
    e_rows = idx.reshape(-1).long()
    assert plan["counts"].tolist() == torch.bincount(e_rows, minlength=rows).tolist()
    assert plan["offsets"][-1] == e_rows.numel() and (plan["offsets"][1:] - plan["offsets"][:-1] == plan["counts"]).all()
    # the entries grouped by row, each once
    assert sorted(plan["perm"].tolist()) == list(range(e_rows.numel()))
    assert (torch.diff(e_rows[plan["perm"]]) >= 0).all()
    # every row has at least one chunk; chunks tile its entries in order
    n_chunks = plan["chunk_start"][1:] - plan["chunk_start"][:-1]
    assert (n_chunks == torch.clamp((plan["counts"] + chunk - 1) // chunk, min=1)).all()
    assert plan["chunk_row"].shape[0] == plan["chunk_start"][-1]
    for q, (r, f) in enumerate(zip(plan["chunk_row"].tolist(), plan["chunk_first"].tolist())):
        assert f == plan["offsets"][r] + (q - plan["chunk_start"][r]) * chunk <= plan["offsets"][r + 1]
    # partial slots only for rows of several chunks, at most 2E/chunk
    multi = plan["multi_start"][1:] - plan["multi_start"][:-1]
    assert (multi == torch.where(n_chunks >= 2, n_chunks, 0)).all()
    assert plan["multi_start"][-1] <= 2 * -(-e_rows.numel() // chunk)
    # the rows the sort launch takes, at most floor(E/(chunk+1)) of them
    assert plan["multi_rows"].tolist() == torch.nonzero(n_chunks >= 2).flatten().tolist()
    assert plan["multi_rows"].numel() <= e_rows.numel() // (chunk + 1)


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


# rows of the fused kernels' tests: a ragged last tile (300, 700) and more
# tiles than the card has SMs, so that a persistent block walks several
MANY_TILES = 64 * 132 * 2 + 700
# d_hidden: every width the kernel is built for below the SRN's 512 (which
# test_fused_mlp_kernel_srn_widths_packed_cuda holds); at 128 and 256 the
# weight ring has 8 stages, at 64 as many as the MLP has slabs
WIDTHS = [64, 128, 256]


def _weight_scale(dh):
    """0.2 at d_hidden 64: a gain of 1.6 a layer, the hidden values reach
    ~100, where one bf16 ulp is 0.5, and the chain carries one flipped
    rounding on, amplified. At 128 and 256 a gain of 1 (``dh ** -0.5``): at
    1.6 two right implementations differ beyond the tolerance in 2 of 1,200
    elements already (the plain version against itself reordered shows the
    same), which holds no kernel to anything."""
    return 0.2 if dh == 64 else dh ** -0.5


def _assert_agrees_with_plain(out, ref, peak):
    """``ops.fused_mlp.disagreement_with_plain``: within atol = rtol = 5e-2,
    but for at most 2e-4 of the elements (none below 5,000 elements), each
    off by no more than two bf16 ulps of its row's largest hidden value."""
    d = fm.disagreement_with_plain(out, ref, peak)
    assert fm.agrees_with_plain(d), d
    if out.numel() < 5000:
        torch.testing.assert_close(out, ref, atol=5e-2, rtol=5e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("dh", WIDTHS)
@pytest.mark.parametrize("n", [300, 700, MANY_TILES])
def test_fused_mlp_kernel_matches_plain_cuda(cuda_device, n, dh):
    weights = tuple(w.to(cuda_device) for w in _mlp_weights(dh=dh, d_in=42, d_z=64, n_blocks=5, combine_layer=3,
                                                            scale=_weight_scale(dh)))
    g = torch.Generator().manual_seed(1)
    z = torch.randn((n, 64), generator=g).to(torch.bfloat16).to(cuda_device)
    x = torch.randn((n, 42), generator=g).to(torch.bfloat16).to(cuda_device)
    out = fused_resnetfc_infer(z, x, weights, 5, 3)
    torch.cuda.synchronize()
    ref, peak = fused_resnetfc_infer_plain(z, x, weights, 5, 3, hidden_max=True)
    # both accumulate bf16 products in float32, in other orders; a rounding
    # flip of one bf16 intermediate moves an output by a few bf16 ulps
    _assert_agrees_with_plain(out, ref, peak)


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
    # few rows, many points: ~250 taps a row, four chunks of ROW_CHUNK, so
    # every row goes through the partials and the combine launch
    table, idx, w = _rows_inputs(rows=64, c=512, n=4000, table_dtype=table_dtype)
    grad_out = torch.randn((4000, 512), generator=torch.Generator().manual_seed(3)).to(out_dtype)
    args = [a.to(cuda_device) for a in (table, idx, w, grad_out)]
    _assert_bwd_matches_plain(args, table_dtype)


def _assert_bwd_matches_plain(args, table_dtype):
    gt, gw = gather_rows_lerp_bwd(*args)
    torch.cuda.synchronize()
    rt, rw = gather_rows_lerp_bwd_plain(*args)
    assert gt.dtype == table_dtype
    # float32 sums in another order (the index's order within a row, which
    # the fill's atomics set; a warp's shuffle tree): a few float32 ulps of
    # the largest entry, plus half a bf16 ulp where the table gradient is
    # stored in bf16
    tol_t = (1e-5 if table_dtype == torch.float32 else 8e-3) * rt.float().abs().max().item()
    assert (gt.float() - rt.float()).abs().max().item() <= tol_t
    assert (gw - rw).abs().max().item() <= 1e-5 * rw.abs().max().item()
    # one output alone: the table's through the index, the weights' through
    # the point-major kernel
    gt_only, none = gather_rows_lerp_bwd(*args, want_w=False)
    assert none is None and (gt_only.float() - rt.float()).abs().max().item() <= tol_t
    none, gw_only = gather_rows_lerp_bwd(*args, want_table=False)
    assert none is None and (gw_only - rw).abs().max().item() <= 1e-5 * rw.abs().max().item()


def _skewed_rows_inputs(c=512, seed=0):
    """A quarter of 4000 points in one cell of a 32x32 map: four rows take
    1,000 taps each (16 chunks), the others a few."""
    g = torch.Generator().manual_seed(seed)
    hh = ww = 32
    ix, iy = torch.rand(4000, generator=g) * (ww - 1), torch.rand(4000, generator=g) * (hh - 1)
    ix[:1000] = 7 + torch.rand(1000, generator=g) * 0.999
    iy[:1000] = 11 + torch.rand(1000, generator=g) * 0.999
    idx, w = tgs.bilinear_corners(ix, iy, hh, ww)
    return torch.randn((hh * ww, c), generator=g), idx, w


@pytest.mark.cuda
@pytest.mark.parametrize("table_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", ["skewed", "n1", "n7", "n700", "empty_rows", "many_rows", "c1536"])
def test_gather_rows_bwd_kernel_cases_cuda(cuda_device, case, table_dtype):
    if case == "skewed":
        table, idx, w = _skewed_rows_inputs()
    elif case == "c1536":
        # wider than the 1024 channels a warp holds: two blocks of channels
        table, idx, w = _rows_inputs(rows=64, c=1536, n=700)
    else:
        table, idx, w, *_ = _row_owner_case(case, 64, c=512)
    grad_out = torch.randn((idx.shape[0], table.shape[1]), generator=torch.Generator().manual_seed(3))
    args = [a.to(cuda_device) for a in (table.to(table_dtype), idx, w, grad_out.to(torch.bfloat16))]
    _assert_bwd_matches_plain(args, table_dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [4, 64])
@pytest.mark.parametrize("case", ["skewed", "n1", "n700", "empty_rows", "many_rows", "count_t", "border"])
def test_row_owner_plan_matches_mirror_cuda(cuda_device, case, chunk):
    if case == "skewed":
        table, idx, _ = _skewed_rows_inputs(c=8)
    else:
        table, idx, *_ = _row_owner_case(case, chunk)
    rows = table.shape[0]
    got = row_owner_plan(idx.to(cuda_device), rows, chunk)
    want = row_owner_plan_plain(idx, rows, chunk)
    for key in ("counts", "offsets", "chunk_start", "multi_start", "chunk_row", "chunk_first", "multi_rows"):
        assert got[key].cpu().tolist() == want[key].tolist(), key
    # a row of several chunks comes out sorted; within the others the
    # entries fall in the order of the fill's atomics (the owner sorts
    # those): sorted within each row, they are the mirror's
    perm = got["perm"].cpu().long()
    row_of_place = torch.repeat_interleave(torch.arange(rows), want["counts"].long())
    in_row_order = perm[torch.argsort(row_of_place * perm.numel() + perm)]
    assert torch.equal(in_row_order, want["perm"].long())
    sorted_place = torch.isin(row_of_place, want["multi_rows"].long())
    assert torch.equal(perm[sorted_place], want["perm"].long()[sorted_place])


def _bench_rows_bwd():
    import os
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts"))
    import bench_gather_rows_bwd_torch as bench

    return bench


@pytest.mark.cuda
@pytest.mark.parametrize("table_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kind", ["uniform", "fine", "skewed", "one_cell"])
def test_gather_rows_bwd_kernel_is_deterministic_cuda(cuda_device, kind, table_dtype):
    """Two launches give the same bits, and grad_table is the mirror's (each
    row's taps ascending, chunks in order) bit for bit: on the bench
    script's training-path inputs, where the skewed one's hot rows take
    16,384 taps (one tile of the sort) and ``one_cell``'s take 65,536 (four
    tiles and two merge passes)."""
    bench = _bench_rows_bwd()
    if kind == "one_cell":
        table, idx, w, grad_out = bench.make_inputs(cuda_device, torch.Generator().manual_seed(1), "skewed")
        # every point of every view into the same cell of view 0
        hot = idx[: idx.shape[0] // 4]
        idx = hot.repeat(4, 1).contiguous()
        w = w[: w.shape[0] // 4].repeat(4, 1).contiguous()
    else:
        table, idx, w, grad_out = bench.make_inputs(cuda_device, torch.Generator().manual_seed(1), kind)
    table = table.to(table_dtype)
    gt, gw = gather_rows_lerp_bwd(table, idx, w, grad_out)
    gt2, gw2 = gather_rows_lerp_bwd(table, idx, w, grad_out)
    torch.cuda.synchronize()
    assert torch.equal(gt.view(torch.int16 if table_dtype == torch.bfloat16 else torch.int32),
                       gt2.view(torch.int16 if table_dtype == torch.bfloat16 else torch.int32))
    assert torch.equal(gw.view(torch.int32), gw2.view(torch.int32))
    mt, mw = row_owner_bwd_plain(table, idx, w, grad_out)
    assert torch.equal(gt.float(), mt.float())
    assert (gw - mw).abs().max().item() <= 1e-5 * mw.abs().max().item()


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
@pytest.mark.parametrize("dh", WIDTHS)
@pytest.mark.parametrize("n", [300, 700, MANY_TILES])
def test_fused_mlp_tz_kernel_matches_plain_cuda(cuda_device, n, dh):
    weights = _mlp_weights(dh=dh, d_in=42, d_z=64, n_blocks=5, combine_layer=3, scale=_weight_scale(dh))
    weights = tuple(w.to(cuda_device) for w in weights[:2]) + (None, None) + tuple(
        w.to(cuda_device) for w in weights[4:])
    g = torch.Generator().manual_seed(1)
    tz = torch.randn((n, 3 * dh), generator=g).to(torch.bfloat16).to(cuda_device)
    x = torch.randn((n, 42), generator=g).to(torch.bfloat16).to(cuda_device)
    before = fused_resnetfc_infer.launches
    out = fused_resnetfc_infer(tz, x, weights, 5, 3, z_is_tz=True)
    torch.cuda.synchronize()
    assert fused_resnetfc_infer.launches == before + 1
    ref, peak = fused_resnetfc_infer_plain(tz, x, weights, 5, 3, z_is_tz=True, hidden_max=True)
    # as the unbaked kernel: float32 sums in other orders may flip a bf16 rounding
    _assert_agrees_with_plain(out, ref, peak)


@pytest.mark.cuda
@pytest.mark.parametrize("dh", WIDTHS)
@pytest.mark.parametrize("n", [64, 256, 700, MANY_TILES])
def test_fused_field_kernel_matches_composition_and_plain_cuda(cuda_device, n, dh):
    """Kernel D equals kernel B fed by kernel A bit for bit, and its plain
    version within kernel B's tolerance; points on the right and bottom
    borders and exact corners included."""
    g = torch.Generator().manual_seed(2)
    hh = ww = 9
    c = 128
    weights = tuple(w.to(cuda_device) for w in _mlp_weights(dh=dh, d_in=42, d_z=c, n_blocks=5, combine_layer=3,
                                                            scale=_weight_scale(dh)))
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
    # kernel D's plain version is A's plain version feeding B's
    ref_b, peak = fused_resnetfc_infer_plain(gather_bilerp_plain(table, base, wg, ww, torch.bfloat16), x,
                                             weights, 5, 3, hidden_max=True)
    assert torch.equal(ref, ref_b)
    _assert_agrees_with_plain(out, ref, peak)
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


@pytest.mark.cuda
@pytest.mark.parametrize("c", [1032, 2056, 8192])
@pytest.mark.parametrize("formulation", ["thread_global_idx", "thread_smem_idx"])
def test_gather_study_thread_kernels_over_one_block_of_groups_cuda(cuda_device, formulation, c):
    # more 8-channel groups than a block's 128 threads: a thread takes
    # groups x, x + 128, ... (2056: 257 groups, a third pass for one thread)
    for table_dtype in (torch.float32, torch.bfloat16):
        table, idx, w = _rows_inputs(rows=64, c=c, n=300, table_dtype=table_dtype)
        args = [a.to(cuda_device) for a in (table, idx, w)]
        out = gather_study(*args, formulation, tile=128)
        torch.cuda.synchronize()
        torch.testing.assert_close(out, gather_study_plain(*args), atol=0, rtol=0)


def _bilinear_rows(hh, ww, c, n, table_dtype, seed=0):
    """A (hh*ww, c) table and the bilinear taps of n points drawn over
    [-1.1, 1.1]^2 of it, as the study's bench makes them."""
    rng = np.random.default_rng(seed)
    grid = torch.from_numpy(rng.uniform(-1.1, 1.1, (n, 2)).astype(np.float32))
    table = torch.from_numpy(rng.normal(size=(hh * ww, c)).astype(np.float32)).to(table_dtype)
    ix = tgs._compute_source_index(grid[:, 0], ww, "border", True)
    iy = tgs._compute_source_index(grid[:, 1], hh, "border", True)
    idx, w = tgs.bilinear_corners(ix, iy, hh, ww)
    return table, idx.contiguous(), w.contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("table_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("formulation", sorted(FORMULATIONS))
def test_gather_study_kernels_match_plain_on_bilinear_rows_cuda(cuda_device, formulation, table_dtype):
    # a 64x64x512 map (block_stage serves every point from its slab);
    # 100,003 points, off every tile, segment and block share
    args = [a.to(cuda_device) for a in _bilinear_rows(64, 64, 512, 100_003, table_dtype)]
    for tile in (128, 512):
        out = gather_study(*args, formulation, tile=tile)
        torch.cuda.synchronize()
        torch.testing.assert_close(out, gather_study_plain(*args), atol=0, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("table_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rows", ["bilinear", "random"])
def test_block_stage_plan_matches_its_mirror_cuda(cuda_device, rows, table_dtype):
    """The four binning passes give the plain mirror's step, offsets and
    permutation (stable within a bin), at 393,216 bilinear points of a
    64x64 map and at 100,003 random rows of a 4096-row table."""
    if rows == "bilinear":
        table, idx, _ = _bilinear_rows(64, 64, 512, 393_216, table_dtype)
    else:
        table, idx, _ = _rows_inputs(rows=4096, c=512, n=100_003, table_dtype=table_dtype)
    ref = block_stage_plan_plain(idx, table.shape[0], 512, table.element_size())
    before = block_stage_plan.launches
    plan = block_stage_plan(table.to(cuda_device), idx.to(cuda_device))
    assert block_stage_plan.launches == before + 1
    assert plan.step == ref.step
    assert torch.equal(plan.offsets.cpu(), ref.offsets)
    assert torch.equal(plan.perm.cpu(), ref.perm)


@pytest.mark.cuda
@pytest.mark.parametrize("z_is_tz", [False, True])
def test_fused_mlp_kernel_srn_widths_packed_cuda(cuda_device, z_is_tz):
    """At the SRN widths, through ``pack_weights`` (the image built once per
    model), a ragged 700 rows: the kernel against its plain version."""
    from pixelnerf_tpu_torch.models.resnetfc import ResnetFC

    mlp = ResnetFC(d_in=42, d_latent=512, d_hidden=512, n_blocks=5, combine_layer=3, dtype=torch.bfloat16)
    g = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for blk in mlp.blocks:
            blk.fc_1.weight.copy_(torch.randn(blk.fc_1.weight.shape, generator=g) * 0.02)
    mlp = mlp.to(cuda_device)
    weights = fm.pack_weights(mlp, with_wz=not z_is_tz)
    assert weights.image is not None and fm.pack_weights(mlp, with_wz=not z_is_tz) is weights
    z = torch.randn((700, 3 * 512 if z_is_tz else 512), generator=g).to(torch.bfloat16).to(cuda_device)
    x = torch.randn((700, 42), generator=g).to(torch.bfloat16).to(cuda_device)
    out = fused_resnetfc_infer(z, x, weights, 5, 3, z_is_tz)
    torch.cuda.synchronize()
    ref = fused_resnetfc_infer_plain(z, x, weights, 5, 3, z_is_tz)
    torch.testing.assert_close(out, ref, atol=5e-2, rtol=5e-2)


# the multi-view mode's cases: two scenes of a ragged number of points, and
# enough of them that a persistent block walks several tiles
VIEW_POINTS = [700, 64 * 132 + 30]


def _views_inputs(ns, sb, b, dh, dev, seed=1, scale=None):
    """Inputs of the multi-view cases, by default a gain of 1 a layer at
    every width (``dh ** -0.5``). At d_hidden 64 and ``_weight_scale``'s gain
    of 1.6 the single-view kernel itself, unchanged, breaks the contract on
    some seeds: the function, not a kernel, is then what the contract would
    test, and the mode is held there to the single-view kernel instead
    (``test_fused_mlp_views_kernel_no_worse_than_single_view_cuda``)."""
    scale = dh ** -0.5 if scale is None else scale
    weights = tuple(w.to(dev) for w in _mlp_weights(dh=dh, d_in=42, d_z=64, n_blocks=5, combine_layer=3,
                                                    seed=seed, scale=scale))
    g = torch.Generator().manual_seed(seed)
    z = torch.randn((sb * ns * b, 64), generator=g).to(torch.bfloat16).to(dev)
    x = torch.randn((sb * ns * b, 42), generator=g).to(torch.bfloat16).to(dev)
    return z, x, weights


@pytest.mark.cuda
@pytest.mark.parametrize("b", VIEW_POINTS)
@pytest.mark.parametrize("dh", WIDTHS + [512])
@pytest.mark.parametrize("ns", [1, 2, 3, 4])
def test_fused_mlp_views_kernel_matches_plain_cuda(cuda_device, ns, dh, b):
    """Kernel B's multi-view mode (ns views averaged at combine_layer 3; at
    ns 1 the single-view kernel) on two scenes, against its plain version
    within the MLP contract."""
    z, x, weights = _views_inputs(ns, 2, b, dh, cuda_device)
    before = fused_resnetfc_infer.launches
    out = fused_resnetfc_infer(z, x, weights, 5, 3, views=ns, points=b)
    torch.cuda.synchronize()
    assert fused_resnetfc_infer.launches == before + 1 and out.shape == (2 * b, 4)
    ref, peak = fused_resnetfc_infer_plain(z, x, weights, 5, 3, hidden_max=True, views=ns, points=b)
    _assert_agrees_with_plain(out, ref, peak)


@pytest.mark.cuda
def test_fused_mlp_views_kernel_no_worse_than_single_view_cuda(cuda_device):
    """At d_hidden 64 and ``_weight_scale``'s gain of 1.6 a layer the
    single-view kernel's roundings flip against the plain version's and the
    chain amplifies the flips past the MLP contract on some seeds. There the
    multi-view mode (two scenes x 3 views x 700 points) is held to the
    single-view kernel on the same seeds' rows: over 12 seeds it breaks the
    contract on no more of them, its share of elements outside the
    tolerance is no larger, and its worst outlier stays within the
    contract's bf16 ulps of its row's largest hidden value (both kernels'
    worst lie near 1.5 of them)."""
    multi, single = [], []
    for seed in range(12):
        z, x, weights = _views_inputs(3, 2, 700, 64, cuda_device, seed=seed, scale=_weight_scale(64))
        out = fused_resnetfc_infer(z, x, weights, 5, 3, views=3, points=700)
        ref, peak = fused_resnetfc_infer_plain(z, x, weights, 5, 3, hidden_max=True, views=3, points=700)
        multi.append(fm.disagreement_with_plain(out, ref, peak))
        out = fused_resnetfc_infer(z, x, weights, 5, 3)
        ref, peak = fused_resnetfc_infer_plain(z, x, weights, 5, 3, hidden_max=True)
        single.append(fm.disagreement_with_plain(out, ref, peak))
    torch.cuda.synchronize()

    def broken(ds):
        return sum(not fm.agrees_with_plain(d) for d in ds)

    def share(ds):
        return sum(d["outside_share"] for d in ds) / len(ds)

    report = {"multi": multi, "single": single}
    assert all(d["finite"] for d in multi), report
    assert broken(multi) <= broken(single), report
    assert share(multi) <= share(single), report
    assert max(d["worst_outlier_ulps"] for d in multi) <= fm.MLP_OUTLIER_ULPS, report


@pytest.mark.cuda
@pytest.mark.parametrize("dh", WIDTHS + [512])
def test_fused_mlp_views_of_one_view_equal_the_single_view_kernel_cuda(cuda_device, dh):
    """Three identical views average to the view itself (a float32 sum of
    three equal bf16 values times 1/3 rounds back to the value), and a row's
    result does not depend on the other rows of its tile: the multi-view
    mode on copies of one view equals the single-view kernel on that view,
    bit for bit, and repeated launches are bit-equal."""
    b = 64 * 132 + 30
    z1, x1, weights = _views_inputs(1, 2, b, dh, cuda_device)
    z = z1.reshape(2, 1, b, -1).expand(2, 3, b, -1).reshape(-1, z1.shape[1]).contiguous()
    x = x1.reshape(2, 1, b, -1).expand(2, 3, b, -1).reshape(-1, x1.shape[1]).contiguous()
    single = fused_resnetfc_infer(z1, x1, weights, 5, 3)
    multi = fused_resnetfc_infer(z, x, weights, 5, 3, views=3, points=b)
    again = fused_resnetfc_infer(z, x, weights, 5, 3, views=3, points=b)
    torch.cuda.synchronize()
    torch.testing.assert_close(multi, single, atol=0, rtol=0)
    torch.testing.assert_close(again, multi, atol=0, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("views", [2, 3, 4])
def test_mean_of_views_is_torch_mean_on_the_card_cuda(cuda_device, views):
    """The multi-view mode's rounding of the views' mean is the dense
    chain's: ``torch.mean`` of a bf16 tensor on the card, bit for bit."""
    g = torch.Generator().manual_seed(5)
    h = (torch.randn((2 * views * 1000, 512), generator=g) * 4).to(torch.bfloat16).to(cuda_device)
    want = torch.mean(h.reshape(2, views, 1000, 512), dim=1).reshape(-1, 512)
    torch.testing.assert_close(fm.mean_of_views(h, views, 1000), want, atol=0, rtol=0)


@pytest.mark.cuda
def test_fused_mlp_views_kernel_at_the_dtu_widths_packed_cuda(cuda_device):
    """At the DTU model's widths (latent 512, d_hidden 512, three source
    views averaged at block 3), through ``pack_weights`` and
    ``ResnetFC(fast=True)``: one launch of the multi-view mode, against its
    plain version, and the dense bf16 chain within the same contract."""
    from pixelnerf_tpu_torch.models.resnetfc import ResnetFC

    mlp = ResnetFC(d_in=42, d_latent=512, d_hidden=512, n_blocks=5, combine_layer=3, dtype=torch.bfloat16)
    g = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for blk in mlp.blocks:
            blk.fc_1.weight.copy_(torch.randn(blk.fc_1.weight.shape, generator=g) * 0.02)
    mlp = mlp.to(cuda_device)
    b = 64 * 40 + 17
    z = torch.randn((3 * b, 512), generator=g).to(torch.bfloat16).to(cuda_device)
    x = torch.randn((3 * b, 42), generator=g).to(torch.bfloat16).to(cuda_device)
    before = fused_resnetfc_infer.launches
    with torch.no_grad():
        out = mlp((z, x), combine_inner_dims=(3, b), fast=True)
        dense = mlp((z, x), combine_inner_dims=(3, b))
    torch.cuda.synchronize()
    assert fused_resnetfc_infer.launches == before + 1 and out.shape == (1, b, 4)
    ref, peak = fused_resnetfc_infer_plain(z, x, fm.pack_weights(mlp), 5, 3, hidden_max=True, views=3, points=b)
    _assert_agrees_with_plain(out.reshape(-1, 4), ref, peak)
    _assert_agrees_with_plain(dense.reshape(-1, 4).float(), ref, peak)


@pytest.mark.cuda
def test_resnetfc_fast_raises_on_the_card_for_widths_not_built_cuda(cuda_device):
    """On the card ``fast=True`` launches the kernel or raises: a width the
    kernel is not built for does not fall back to the dense chain."""
    from pixelnerf_tpu_torch.models.resnetfc import ResnetFC

    mlp = ResnetFC(d_in=10, d_latent=48, d_hidden=96, n_blocks=3, combine_layer=2,
                   dtype=torch.bfloat16).to(cuda_device)
    z, x = torch.randn((20, 48), device=cuda_device), torch.randn((20, 10), device=cuda_device)
    before = fused_resnetfc_infer.launches
    with torch.no_grad(), pytest.raises(ValueError, match="fused MLP kernel"):
        mlp((z, x), fast=True)
    assert fused_resnetfc_infer.launches == before
    with torch.no_grad():
        assert mlp((z, x), fast=False).shape == (20, 4)


@pytest.mark.cuda
@pytest.mark.parametrize("source", ["fused_mlp", "fused_field"])
def test_kernel_reports_its_blocks_shared_memory_cuda(cuda_device, source):
    from pixelnerf_tpu_torch.ops import _build

    lib = _build.load(source)
    # activations 64 KB, z 64 KB, x 8 KB, Wout 8 KB, barriers and slack, 5 slabs of 16 KB
    assert fm.check_kernel_fits(lib, 64, 512, 512) == 2 * 65536 + 2 * 8192 + 1280 + 5 * 16384
    for kx, zw, dh in [(64, 64, 64), (64, 128, 64), (128, 256, 256), (64, 128, 128)]:
        assert 0 < fm.check_kernel_fits(lib, kx, zw, dh) <= fm.SMEM_LIMIT
    # too wide for the block, and widths the body is not built for
    for kx, zw, dh in [(64, 4096, 512), (64, 2048, 512), (64, 48, 64), (64, 512, 96), (48, 64, 64)]:
        with pytest.raises(ValueError, match="do not fit"):
            fm.check_kernel_fits(lib, kx, zw, dh)


# --- the model variants' latent widths (a global encoder's vector before the
# spatial latent, the custom conv encoder's 128 channels) ---

def test_z_tile_rounds_the_latent_to_whole_chunks():
    """Kernel B's z tile takes d_z rounded up to 64 columns: 144 (a global
    latent of 16 before 128 spatial channels) and 640 (128 before 512) are
    widths it is built for, padded to 192 and 640."""
    assert [fm.z_tile_width(d) for d in (128, 144, 512, 640, 1000)] == [128, 192, 512, 640, 1024]
    for zw in (fm.z_tile_width(144), fm.z_tile_width(640)):
        fm.check_kernel_widths(64, zw, 512)
    weights = _mlp_weights(dh=64, d_in=42, d_z=144, n_blocks=5, combine_layer=3, seed=5)
    padded = list(weights)
    padded[2] = torch.cat([weights[2], torch.zeros((3 * 64, 48), dtype=torch.bfloat16)], dim=1)
    assert torch.equal(fm.tile_weights(weights, 64, 5, 3), fm.tile_weights(tuple(padded), 64, 5, 3))


@pytest.mark.cuda
@pytest.mark.parametrize("d_z", [144, 640, 128])
@pytest.mark.parametrize("n", [700, MANY_TILES])
def test_fused_mlp_kernel_at_variant_latent_widths_cuda(cuda_device, n, d_z):
    """Kernel B at d_hidden 512 with the variants' latents: 144 (z tile
    zero-filled to 192 columns), 640 (the SRN model with a 128-wide global
    latent: 4 ring stages) and 128 (the custom conv encoder)."""
    weights = tuple(w.to(cuda_device) for w in _mlp_weights(dh=512, d_in=42, d_z=d_z, n_blocks=5, combine_layer=3,
                                                            scale=_weight_scale(512)))
    g = torch.Generator().manual_seed(2)
    z = torch.randn((n, d_z), generator=g).to(torch.bfloat16).to(cuda_device)
    x = torch.randn((n, 42), generator=g).to(torch.bfloat16).to(cuda_device)
    out = fused_resnetfc_infer(z, x, weights, 5, 3)
    torch.cuda.synchronize()
    ref, peak = fused_resnetfc_infer_plain(z, x, weights, 5, 3, hidden_max=True)
    _assert_agrees_with_plain(out, ref, peak)


@pytest.mark.cuda
def test_fused_mlp_ring_stages_at_variant_latent_widths_cuda(cuda_device):
    """The weight ring's stages the built kernel B holds at d_hidden 512
    (x 64 wide): 5 at z 512, 4 at 640 (a 128-wide global latent), 8 (the
    most) at 128, none at 1024."""
    import ctypes

    from pixelnerf_tpu_torch.ops import _build

    fn = _build.load("fused_mlp").mlp_body_ring_stages
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_int
    assert [fn(64, zw, 512) for zw in (512, 640, 128, 1024)] == [5, 4, 8, 0]


@pytest.mark.cuda
def test_fused_mlp_kernel_raises_for_a_latent_that_does_not_fit_cuda(cuda_device):
    """A global latent of 512 (no fc) before 512 spatial channels: a
    1024-wide z tile leaves room for one ring stage at d_hidden 512, and the
    wrapper raises rather than fall back."""
    weights = tuple(w.to(cuda_device) for w in _mlp_weights(dh=512, d_in=42, d_z=1024, n_blocks=5,
                                                            combine_layer=3))
    z = torch.zeros((64, 1024), dtype=torch.bfloat16, device=cuda_device)
    x = torch.zeros((64, 42), dtype=torch.bfloat16, device=cuda_device)
    before = fused_resnetfc_infer.launches
    with pytest.raises(ValueError, match="do not fit"):
        fused_resnetfc_infer(z, x, weights, 5, 3)
    assert fused_resnetfc_infer.launches == before


@pytest.mark.cuda
def test_gather_kernel_on_a_128_channel_map_cuda(cuda_device):
    """Kernel A on the custom conv encoder's 128x128x128 map (bf16, two
    views), bit-equal to its plain version."""
    g = torch.Generator().manual_seed(3)
    hh = ww = 128
    table = torch.randn((2 * hh * ww, 128), generator=g).to(torch.bfloat16)
    ix = torch.rand(20000, generator=g) * (ww - 1)
    iy = torch.rand(20000, generator=g) * (hh - 1)
    base, w = tgs.bilinear_pair_bases(ix, iy, hh, ww)
    base[10000:] += hh * ww
    args = [a.to(cuda_device) for a in (table, base, w)]
    out = gather_bilerp(*args, ww, torch.bfloat16)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, gather_bilerp_plain(*args, ww, torch.bfloat16), atol=0, rtol=0)


# --- kernel A at every width: L lanes a point, 32 / L points side by side ---

# one lane a point (8 bf16 channels) up to a lane walking its row (1032 bf16
# channels: 129 pieces, one lane takes a fifth; 1536: the baked rows)
A_WIDTHS = [8, 24, 64, 128, 256, 512, 1032, 1536]
A_PAIRS = [(torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32),
           (torch.float32, torch.bfloat16), (torch.float32, torch.float32)]
A_PAIR_IDS = ["bf16-bf16", "bf16-f32", "f32-bf16", "f32-f32"]


def _bench_a_module():
    import os
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts"))
    import bench_gather_a_torch as bench

    return bench


def test_bench_request_points_sample_the_map_as_grid_sample():
    """The kernel A bench's request-shaped points (16,384 rays x 64 samples
    at the SRN geometry, ray-major): their bases and weights, through A's
    plain version, give ``grid_sample`` at their grid coordinates; most fall
    inside the map, and neighbours on a ray often share a corner."""
    bench = _bench_a_module()
    hh = ww = 16
    base, w, grid = bench.request_points(hh, ww, torch.device("cpu"))
    assert base.shape == (bench.RAYS * bench.SAMPLES, 2) and base.dtype == torch.int32
    assert 0 <= base.min() and base.max() < hh * ww
    assert (grid.abs() <= 1).all(-1).float().mean() > 0.5
    assert (base[1:, 0] == base[:-1, 0]).float().mean() > 0.5
    feats = torch.randn((1, hh, ww, 8), generator=torch.Generator().manual_seed(0))
    out = gather_bilerp_plain(feats.reshape(hh * ww, 8), base, w, ww)
    ref = tgs.grid_sample(feats, grid[None])[0]
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=1e-5)


def _points_on_two_views(n, hh, ww, seed):
    """n points over two hh x ww views (every other point on the second),
    the right and bottom borders and exact corners included."""
    g = torch.Generator().manual_seed(seed)
    ix = torch.rand(n, generator=g) * (ww - 1)
    iy = torch.rand(n, generator=g) * (hh - 1)
    ix[: n // 8] = ww - 1
    iy[n // 16: n // 4] = hh - 1
    k = min(n, 5)
    ix[-k:], iy[-k:] = torch.arange(k, dtype=torch.float32) % ww, torch.arange(k, dtype=torch.float32) % hh
    base, w = tgs.bilinear_pair_bases(ix, iy, hh, ww)
    base[1::2] += hh * ww
    return base, w


def _assert_a_equals_plain(table, base, w, ww, out_dtype, piece=131072):
    before = gather_bilerp.launches
    out = gather_bilerp(table, base, w, ww, out_dtype)
    torch.cuda.synchronize()
    assert gather_bilerp.launches == before + 1
    assert out.shape == (base.shape[0], table.shape[1]) and out.dtype == out_dtype
    for s in range(0, base.shape[0], piece):
        ref = gather_bilerp_plain(table, base[s:s + piece], w[s:s + piece], ww, out_dtype)
        torch.testing.assert_close(out[s:s + piece], ref, atol=0, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("pair", A_PAIRS, ids=A_PAIR_IDS)
@pytest.mark.parametrize("c", A_WIDTHS)
@pytest.mark.parametrize("n", [1, 31, 33, 100_003])
def test_gather_kernel_at_every_width_cuda(cuda_device, n, c, pair):
    """Kernel A bit-equal to its plain version at every lane count, dtype
    pair and a ragged last chunk (31, 33, 100,003 points) on a two-view
    table of 9 x 7 maps."""
    table_dtype, out_dtype = pair
    hh, ww = 9, 7
    table = torch.randn((2 * hh * ww, c), generator=torch.Generator().manual_seed(c)).to(table_dtype)
    base, w = _points_on_two_views(n, hh, ww, seed=n)
    _assert_a_equals_plain(*(a.to(cuda_device) for a in (table, base, w)), ww, out_dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("pair", [A_PAIRS[0], A_PAIRS[3]], ids=[A_PAIR_IDS[0], A_PAIR_IDS[3]])
@pytest.mark.parametrize("c", [64, 128, 512, 1536])
def test_gather_kernel_walks_many_chunks_cuda(cuda_device, c, pair):
    """2^20 - 3 points: 4,096 chunks of 256, more than the persistent
    grid's blocks (SMs x resident blocks), so each block walks several
    chunks, and the last group is ragged at every lane count."""
    table_dtype, out_dtype = pair
    hh = ww = 64
    table = torch.randn((2 * hh * ww, c), generator=torch.Generator().manual_seed(c)).to(table_dtype)
    base, w = _points_on_two_views(2 ** 20 - 3, hh, ww, seed=c)
    _assert_a_equals_plain(*(a.to(cuda_device) for a in (table, base, w)), ww, out_dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("pair", [A_PAIRS[0], A_PAIRS[3]], ids=[A_PAIR_IDS[0], A_PAIR_IDS[3]])
@pytest.mark.parametrize("c", [64, 128, 256, 512])
def test_gather_kernel_on_request_points_cuda(cuda_device, c, pair):
    """Kernel A on one request's coarse points (the bench's ray-major
    points, many of them border-clamped), bit-equal to its plain version."""
    bench = _bench_a_module()
    table_dtype, out_dtype = pair
    hh, ww = bench.MAPS[c]
    table = torch.randn((hh * ww, c), generator=torch.Generator().manual_seed(c)).to(table_dtype).to(cuda_device)
    base, w, _ = bench.request_points(hh, ww, cuda_device)
    _assert_a_equals_plain(table, base, w, ww, out_dtype)


@pytest.mark.cuda
def test_fused_field_kernel_equals_b_fed_by_a_at_the_srn_widths_cuda(cuda_device):
    """Kernel D at the SRN widths (512-channel latent, d_hidden 512) on
    request-shaped points, a ragged count, bit-equal to kernel B fed by
    kernel A: D's gather (gather_common.cuh) and A's own lerp agree."""
    from pixelnerf_tpu_torch.models.resnetfc import ResnetFC

    bench = _bench_a_module()
    mlp = ResnetFC(d_in=42, d_latent=512, d_hidden=512, n_blocks=5, combine_layer=3, dtype=torch.bfloat16)
    g = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for blk in mlp.blocks:
            blk.fc_1.weight.copy_(torch.randn(blk.fc_1.weight.shape, generator=g) * 0.02)
    weights = fm.pack_weights(mlp.to(cuda_device))
    hh, ww = bench.MAPS[512]
    table = torch.randn((hh * ww, 512), generator=g).to(torch.bfloat16).to(cuda_device)
    base, wg, _ = bench.request_points(hh, ww, cuda_device)
    n = 70_001
    base, wg = base[:n].contiguous(), wg[:n].contiguous()
    x = torch.randn((n, 42), generator=g).to(torch.bfloat16).to(cuda_device)
    out = fused_gather_resnetfc_infer(table, base, wg, x, weights, 5, 3, ww)
    z = gather_bilerp(table, base, wg, ww, torch.bfloat16)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, fused_resnetfc_infer(z, x, weights, 5, 3), atol=0, rtol=0)


WAITS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize", "cudaMemcpy")


@functools.lru_cache(maxsize=1)
def _srn_view_setup(device: str):
    """The ``srn.render`` cell's request at the published widths, weights
    from a seed: ResNet34 latent 512, ResnetFC 512 x 5, bf16, 64 + 16 + 16
    samples on white, one 128x128 source view encoded with device-tensor
    intrinsics; ``FullRenderer(fast=True)``, staged, 50,000-ray chunks."""
    from pixelnerf_tpu_torch.config import load_config
    from pixelnerf_tpu_torch.eval import FullRenderer
    from pixelnerf_tpu_torch.models import make_model
    from pixelnerf_tpu_torch.render import RenderConfig
    from pixelnerf_tpu_torch.utils import geometry

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    conf = load_config(os.path.join(repo, "conf", "exp", "srn.conf"))
    conf["model"]["dtype"] = "bfloat16"
    net = make_model(conf["model"], device=device, generator=torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(6)
    with torch.no_grad():
        for mlp in (net.mlp_coarse, net.mlp_fine):
            mlp.lin_out.bias[3] += 3.0        # density, so that the view is no blank white
            for blk in mlp.blocks:
                blk.fc_1.weight.copy_(torch.randn(blk.fc_1.weight.shape, generator=g).to(device) * 0.02)
    cfg = RenderConfig.from_conf(conf["renderer"])
    assert (cfg.n_coarse, cfg.n_fine, cfg.n_fine_depth, cfg.white_bkgd) == (64, 32, 16, True)
    images = (torch.rand((1, 1, 128, 128, 3), generator=g) * 2 - 1).to(device)
    poses = torch.from_numpy(geometry.look_at((0.0, 0.4, 1.3), (0.0, 0.0, 0.0)))[None, None].to(device)
    target = torch.from_numpy(geometry.look_at((0.9, 0.3, 1.0), (0.0, 0.0, 0.0)))[None].to(device)
    return net, FullRenderer(net, cfg, ray_chunk=50000, fast=True), images, poses, target


def _srn_view(renderer, enc, target, seed, focal=(131.25, 131.25), c=(64.0, 64.0)):
    from pixelnerf_tpu_torch.utils import geometry

    gen = torch.Generator(device=target.device).manual_seed(seed)
    rays = geometry.gen_rays(target, 128, 128, focal, 0.8, 1.8, c=c, device=target.device)[0]
    return renderer.render_image(enc, rays, generator=gen)


@pytest.mark.cuda
def test_srn_view_makes_no_host_wait_and_no_new_segment_cuda(cuda_device):
    """After one warm-up (an encode and a view), the same again
    under ``torch.profiler``: an ``srn``-shaped encode and view (16,384
    rays, one chunk) with no wait of the host on the device and no
    ``cudaMalloc`` from its start to its end, and no segment more in the
    caching allocator."""
    net, renderer, images, poses, target = _srn_view_setup(str(cuda_device))
    focal_t = torch.tensor([[131.25, 131.25]], device=cuda_device)
    c_t = torch.tensor([[64.0, 64.0]], device=cuda_device)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.inference_mode():
        enc = net.encode(images, poses, focal_t, c_t)
        rgb, depth = _srn_view(renderer, enc, target, 1)
        torch.cuda.synchronize()
        del enc, rgb, depth
        before = torch.cuda.memory_stats(cuda_device)
        with torch.profiler.profile(activities=acts) as prof:
            with torch.profiler.record_function("srn_view_window"):
                enc = net.encode(images, poses, focal_t, c_t)
                rgb, depth = _srn_view(renderer, enc, target, 2)
            torch.cuda.synchronize()
        after = torch.cuda.memory_stats(cuda_device)
    assert rgb.shape == (128, 128, 3) and torch.isfinite(rgb).all() and torch.isfinite(depth).all()
    events = prof.events()
    cpu = torch.autograd.DeviceType.CPU
    (window,) = [e for e in events if e.name == "srn_view_window" and e.device_type == cpu]
    inside = [e.name for e in events if window.time_range.start <= e.time_range.start <= window.time_range.end]
    assert inside.count("cudaLaunchKernel") > 50
    assert [n for n in inside if n in WAITS or n == "cudaMalloc"] == []
    for key in ("segment.all.allocated", "num_alloc_retries"):
        assert after[key] == before[key], key


@pytest.mark.cuda
def test_srn_view_is_bit_equal_to_the_request_built_the_old_way_cuda(cuda_device, monkeypatch):
    """The same view with the code's tables turned into tensors in every
    call and every vector of host numbers copied (``old_way``), the
    intrinsics as host tensors: rgb and depth bit for bit. And ``gen_rays``
    with focal and principal point as numbers, numpy arrays, host tensors
    and device tensors gives the old way's rays bit for bit (a CUDA division
    by a Python number would not)."""
    from pixelnerf_tpu_torch.utils import geometry
    from test_torch_request_waits import FORMS, old_intrinsics, old_way

    net, renderer, images, poses, target = _srn_view_setup(str(cuda_device))
    forms = dict(FORMS, device=tuple(torch.as_tensor(v, device=cuda_device) for v in FORMS["host_tensors"]))
    with torch.inference_mode():
        enc = net.encode(images, poses, torch.tensor([[131.25, 131.25]], device=cuda_device),
                         torch.tensor([[64.0, 64.0]], device=cuda_device))
        rgb, depth = _srn_view(renderer, enc, target, 3)
        rays = {k: geometry.gen_rays(target, 20, 16, f, 0.8, 1.8, c=c, device=cuda_device)
                for k, (f, c) in forms.items()}
        with monkeypatch.context() as m:
            old_way(m)
            enc_o = net.encode(images, poses, torch.tensor([[131.25, 131.25]]), torch.tensor([[64.0, 64.0]]))
            rgb_o, depth_o = _srn_view(renderer, enc_o, target, 3, torch.tensor([131.25, 131.25]),
                                       torch.tensor([64.0, 64.0]))
            want = {}
            for k in forms:
                f, c = old_intrinsics("host_tensors" if k == "device" else k, 20, 16)
                want[k] = geometry.gen_rays(target, 20, 16, f, 0.8, 1.8, c=c, device=cuda_device)
    torch.cuda.synchronize()
    assert torch.isfinite(rgb).all() and rgb.std() > 0
    assert torch.equal(rgb, rgb_o) and torch.equal(depth, depth_o)
    for k in forms:
        assert torch.equal(rays[k], want[k]), k


# --- kernel A's field instance: the feature stage in one launch ---

# the geometry of a case: scenes, views a scene, the encoded image (W, H),
# the latent map (hl, wl), focal (fx, fy), principal point, the cameras'
# radius and the points' half extent
FIELD_GEOMETRY = {
    "srn": (1, 1, (128, 128), (64, 64), (131.25, 131.25), (64.0, 64.0), 1.3, 0.5),
    "dtu": (1, 3, (400, 300), (150, 200), (720.0, 718.0), (212.0, 141.0), 2.4, 1.0),
}
FIELD_CASES = ["srn", "dtu", "sb2", "ragged", "outside", "edge", "mixed"]
FIELD_DTYPES = [torch.bfloat16, torch.float32]


def _field_case(case, out_dtype, channels, device):
    """The feature stage's inputs of one case: a ``SceneEncoding`` of random
    latent maps on cameras looking at the origin, world points and unit
    view directions (SB, B, 3). ``srn``: 128x128 images, a 64x64 latent,
    4,096 points; ``dtu``: three 400x300 views a scene with a focal of its
    own each, a 150x200 latent; ``sb2``: two SRN scenes; ``ragged``: 1,001
    points; ``outside``: points whose uv falls far outside the image, so
    border clamping applies; ``edge``: points unprojected from whole pixels
    of the latent, so the floor is taken at a pixel edge; ``mixed``: the
    table in the other dtype than the output."""
    from pixelnerf_tpu_torch.models.pixelnerf import SceneEncoding
    from pixelnerf_tpu_torch.utils import geometry

    g = torch.Generator().manual_seed(FIELD_CASES.index(case))
    sb, ns, (w, h), (hl, wl), (fx, fy), (cx, cy), radius, extent = FIELD_GEOMETRY["dtu" if case == "dtu" else "srn"]
    sb = 2 if case == "sb2" else sb
    b = 1001 if case == "ragged" else 4096
    n = sb * ns
    angles = torch.rand((n, 2), generator=g, dtype=torch.float64)
    eyes = [(radius * math.cos(6.0 * a) * math.cos(0.5 * e), radius * math.sin(0.5 * e), radius * math.sin(6.0 * a) *
             math.cos(0.5 * e)) for a, e in angles.tolist()]
    c2w = torch.stack([torch.from_numpy(geometry.look_at(e, (0.0, 0.0, 0.0))) for e in eyes])
    w2c = geometry.invert_pose(c2w)
    if case == "dtu":
        focal = torch.tensor([[fx + 3.0 * v, -(fy + 3.0 * v)] for v in range(n)])      # a focal a view
    else:
        focal = torch.tensor([[fx, -fy]]).expand(sb, 2).contiguous()
    c = torch.tensor([cx, cy]).expand(sb, 2)        # as encode's default: a row a scene, stride 0
    xyz = (torch.rand((sb, b, 3), generator=g) * 2 - 1) * (6.0 * extent if case == "outside" else extent)
    if case == "edge":
        # whole latent pixels (ix, iy) of each scene's first view, back to
        # the world at a depth near the camera's radius, in float64
        ix = torch.randint(0, wl, (sb, b), generator=g).double()
        iy = torch.randint(0, hl, (sb, b), generator=g).double()
        u, v = ix * w / wl, iy * h / hl
        zc = -(radius + (torch.rand((sb, b), generator=g, dtype=torch.float64) - 0.5) * extent)
        cam = torch.stack([-(u - cx) * zc / fx, -(v - cy) * zc / -fy, zc], dim=-1)
        first = w2c[::ns].double()
        xyz = torch.einsum("sji,sbj->sbi", first[:, :, :3], cam - first[:, None, :, 3]).float()
    dirs = torch.nn.functional.normalize(torch.randn((sb, b, 3), generator=g), dim=-1)
    table_dtype = out_dtype
    if case == "mixed":
        table_dtype = torch.float32 if out_dtype == torch.bfloat16 else torch.bfloat16
    latent = torch.randn((n, hl, wl, channels), generator=g).to(table_dtype)
    image_shape = torch.tensor([float(w), float(h)])
    enc = SceneEncoding(latent.to(device), w2c.to(device), focal.to(device), c.to(device), image_shape.to(device), ns)
    return enc, xyz.to(device), dirs.to(device)


@functools.lru_cache(maxsize=4)
def _field_net(out_dtype, device):
    """A small SRN-conf model (the published flags: use_xyz, normalize_z, the
    code on xyz, view directions; a 64-channel encoder and ResnetFC of 32)
    whose MLPs compute in ``out_dtype``: the separate stage's owner."""
    from pixelnerf_tpu_torch.config import load_config
    from pixelnerf_tpu_torch.models import make_model

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    conf = load_config(os.path.join(repo, "conf", "exp", "srn.conf"))
    conf["model"]["encoder"]["num_layers"] = 1
    for mlp in ("mlp_coarse", "mlp_fine"):
        conf["model"][mlp]["d_hidden"] = 32
    conf["model"]["dtype"] = "bfloat16" if out_dtype == torch.bfloat16 else "float32"
    return make_model(conf["model"], device=device, generator=torch.Generator().manual_seed(0))


def _field_mirror(net, enc, xyz, dirs):
    from pixelnerf_tpu_torch.ops.gather import gather_bilerp_field_plain

    freqs, phases = net.code.device_tables(xyz.device, torch.float32)
    return gather_bilerp_field_plain(enc.latent, xyz, dirs, enc.poses, enc.focal, enc.c, enc.image_shape, freqs,
                                     phases, net.mlp_coarse.dtype)


def _ulp(a, b, dtype):
    """One ulp of ``dtype`` (bf16: 8 significant bits, float32: 24) at the
    larger magnitude of ``a`` and ``b``, elementwise."""
    _, e = torch.frexp(torch.maximum(a.abs(), b.abs()))
    return torch.ldexp(torch.ones_like(a), e - (8 if dtype == torch.bfloat16 else 24))


def _assert_field_close_to_separate(out, sep, enc, freqs):
    """The field instance's (latent, x) against the separate stage's. Their
    camera rotations sum in other orders, a few float32 ulps apart: the x
    rows within 1 ulp of their dtype plus 4 float32 ulps of the largest
    rotated coordinate through the code's highest frequency (a sine's
    argument moves by that much, and a value near 0 keeps no relative
    precision); the latent rows, their source index moved by 4 float32
    ulps of the map's side, within 1 ulp plus that move times the largest
    step between neighbouring map values."""
    (lat, x), (lat0, x0) = out, sep
    assert lat.shape == lat0.shape and x.shape == x0.shape and lat.dtype == lat0.dtype and x.dtype == x0.dtype
    eps = torch.finfo(torch.float32).eps
    x, x0 = x.float(), x0.float()
    moved = 4 * eps * x0[..., :3].abs().max() * freqs.max()
    assert ((x - x0).abs() <= _ulp(x, x0, out[1].dtype) + moved).all(), (x - x0).abs().max()
    table = enc.latent
    moved = 4 * eps * max(table.shape[1:3]) * 2 * table.abs().max().float()
    lat, lat0 = lat.float(), lat0.float()
    assert ((lat - lat0).abs() <= _ulp(lat, lat0, out[0].dtype) + moved).all(), (lat - lat0).abs().max()


@pytest.mark.parametrize("out_dtype", FIELD_DTYPES, ids=["bf16", "f32"])
@pytest.mark.parametrize("case", FIELD_CASES)
def test_field_mirror_agrees_with_the_separate_stage(case, out_dtype):
    """On the CPU: the field instance's plain mirror against today's
    composition of the stage (``_point_inputs``, ``index_latent``, the
    casts), at 64 channels."""
    from pixelnerf_tpu_torch.ops.gather import gather_bilerp_field

    net = _field_net(out_dtype, "cpu")
    enc, xyz, dirs = _field_case(case, out_dtype, 64, "cpu")
    freqs, phases = net.code.device_tables("cpu", torch.float32)
    before = gather_bilerp_field.launches
    with torch.no_grad():
        out = _field_mirror(net, enc, xyz, dirs)
        wrapped = gather_bilerp_field(enc.latent, xyz, dirs, enc.poses, enc.focal, enc.c, enc.image_shape, freqs,
                                      phases, out_dtype)
        sep = net._separate_features(enc, xyz, dirs, use_kernels=True, differentiable=False, coarse=True)
    # the wrapper runs the mirror for CPU tensors, with no launch
    assert gather_bilerp_field.launches == before
    assert torch.equal(wrapped[0], out[0]) and torch.equal(wrapped[1], out[1])
    _assert_field_close_to_separate(out, sep, enc, freqs)
    if case == "outside":
        assert (out[1][..., :3].float().abs() > 1.0).any()


@pytest.mark.parametrize("case", ["table_int", "table_3d", "xyz_f64", "xyz_shape", "dirs_shape", "views",
                                  "w2c_shape", "focal_shape", "image_shape", "tables", "out_f16", "channels"])
def test_field_wrapper_rejects_bad_inputs(case):
    """``gather_bilerp_field`` checks its inputs before any launch."""
    from pixelnerf_tpu_torch.ops.gather import gather_bilerp_field

    n, b = 2, 5
    args = {"latent": torch.zeros((n, 3, 4, 8)), "xyz": torch.zeros((1, b, 3)), "dirs": torch.zeros((1, b, 3)),
            "w2c": torch.zeros((n, 3, 4)), "focal": torch.ones((1, 2)), "c": torch.ones((1, 2)),
            "image_shape": torch.ones(2), "freqs": torch.ones(12), "phases": torch.ones(12),
            "out_dtype": torch.bfloat16}
    change = {
        "table_int": ("latent", torch.zeros((n, 3, 4, 8), dtype=torch.int32)),
        "table_3d": ("latent", torch.zeros((n, 12, 8))),
        "xyz_f64": ("xyz", torch.zeros((1, b, 3), dtype=torch.float64)),
        "xyz_shape": ("xyz", torch.zeros((1, b, 2))),
        "dirs_shape": ("dirs", torch.zeros((1, b + 1, 3))),
        "views": ("xyz", torch.zeros((3, b, 3))),
        "w2c_shape": ("w2c", torch.zeros((n, 4, 4))),
        "focal_shape": ("focal", torch.ones((3, 2))),
        "image_shape": ("image_shape", torch.ones(3)),
        "tables": ("phases", torch.ones(11)),
        "out_f16": ("out_dtype", torch.float16),
        "channels": ("latent", torch.zeros((n, 3, 4, 6))),
    }[case]
    args[change[0]] = change[1]
    before = gather_bilerp_field.launches
    with pytest.raises((TypeError, ValueError)):
        gather_bilerp_field(**args)
    assert gather_bilerp_field.launches == before


@functools.lru_cache(maxsize=4)
def _published_net(name):
    """The published model of ``name`` on the CPU: ``srn`` and ``dtu`` in bf16
    (the benchmark's cells), ``srn_f32`` as the float32 apps build it."""
    from pixelnerf_tpu_torch.config import load_config
    from pixelnerf_tpu_torch.models import make_model

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    conf = load_config(os.path.join(repo, "conf", "exp", "dtu.conf" if name == "dtu" else "srn.conf"))
    if name != "srn_f32":
        conf["model"]["dtype"] = "bfloat16"
    return make_model(conf["model"], device="cpu", generator=torch.Generator().manual_seed(0))


FIELD_GATE = {
    # case: (model, expected); each old-path case changes one thing of srn on the card
    "srn": ("srn", True), "dtu": ("dtu", True), "srn_f32": ("srn_f32", True),
    "cpu": ("srn", False), "differentiable": ("srn", False), "autograd": ("srn", False),
    "baked": ("srn", False), "quad": ("srn", False), "use_code_viewdirs": ("srn", False),
    "normalize_z_off": ("srn", False), "use_xyz_off": ("srn", False), "no_viewdirs": ("srn", False),
    "code_without_input": ("srn", False), "narrow_latent": ("srn", False),
}


@pytest.mark.parametrize("case", sorted(FIELD_GATE))
def test_field_gate_chooses_by_what_it_can_observe(case):
    """``PixelNeRFNet.fuses_inputs``, the one predicate of the feature
    stage's path, over the model, the encoding and the call: the field
    instance for the published SRN and DTU models and the float32 apps' on
    a CUDA device; the separate stage on the CPU, for training
    (``differentiable`` or autograd on), for a baked encoding or a quad
    table, for inputs the instance does not compute and for a latent that
    A serves narrower than a warp a point."""
    import copy
    import dataclasses

    from pixelnerf_tpu_torch.models.pixelnerf import SceneEncoding

    name, want = FIELD_GATE[case]
    net = copy.copy(_published_net(name))
    views = 3 if name == "dtu" else 1
    latent = torch.zeros((views, 2, 2, net.encoder.latent_size), dtype=net.latent_dtype)
    enc = SceneEncoding(latent, torch.zeros((views, 3, 4)), torch.ones((1, 2)), torch.ones((1, 2)),
                        torch.tensor([4.0, 4.0]), views)
    device, viewdirs_given, differentiable, grad = "cuda", True, False, False
    if case == "cpu":
        device = "cpu"
    elif case == "differentiable":
        differentiable = True
    elif case == "autograd":
        grad = True
    elif case == "baked":
        enc.tz_coarse = enc.tz_fine = torch.zeros((views, 2, 2, 1536), dtype=net.latent_dtype)
    elif case == "quad":
        enc.latent_quad = torch.zeros((views, 2, 2, 4 * net.encoder.latent_size), dtype=net.latent_dtype)
    elif case == "use_code_viewdirs":
        net.use_code_viewdirs = True
    elif case == "normalize_z_off":
        net.normalize_z = False
    elif case == "use_xyz_off":
        net.use_xyz = False
    elif case == "no_viewdirs":
        viewdirs_given = False
    elif case == "code_without_input":
        net.code = dataclasses.replace(net.code, include_input=False)
    elif case == "narrow_latent":
        enc.latent = torch.zeros((views, 2, 2, 128), dtype=net.latent_dtype)
    with torch.set_grad_enabled(grad):
        assert net.fuses_inputs(enc, torch.device(device), viewdirs_given, differentiable) is want


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", FIELD_DTYPES, ids=["bf16", "f32"])
@pytest.mark.parametrize("case", FIELD_CASES)
def test_field_kernel_matches_its_mirror_and_the_separate_stage_cuda(cuda_device, case, out_dtype):
    """Kernel A's field instance at 512 channels, through
    ``query_features`` on the card: one launch (``gather_bilerp_field``,
    none of ``gather_bilerp``) and ``field.features`` counting
    ``inputs_fused``; its latent and x rows bit-equal to the plain mirror
    (``use_kernels=False``), and close to the separate stage (kernel A fed
    by the PyTorch composition) as the CPU test holds the mirror."""
    from pixelnerf_tpu_torch.ops.gather import gather_bilerp_field
    from pixelnerf_tpu_torch.utils import profiling

    net = _field_net(out_dtype, str(cuda_device))
    enc, xyz, dirs = _field_case(case, out_dtype, 512, cuda_device)
    before, before_a = gather_bilerp_field.launches, gather_bilerp.launches
    with torch.inference_mode():
        profiling.enable()
        try:
            out = net.query_features(enc, xyz, dirs)
            torch.cuda.synchronize()
        finally:
            profiling.disable()
        records = [r for r in profiling.take() if r.name == "field.features"]
        assert gather_bilerp_field.launches == before + 1 and gather_bilerp.launches == before_a
        mirror = net.query_features(enc, xyz, dirs, use_kernels=False)
        sep = net._separate_features(enc, xyz, dirs, use_kernels=True, differentiable=False, coarse=True)
    assert [r.counts.get("inputs_fused") for r in records] == [1]
    assert torch.equal(out[0], mirror[0]) and torch.equal(out[1], mirror[1])
    _assert_field_close_to_separate(out, sep, enc, net.code.device_tables(cuda_device, torch.float32)[0])
