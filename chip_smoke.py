#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one NVIDIA GPU and check them.

Five paths at the full width and depth of the SRN model
(``conf/exp/srn.conf``: ResNet34 to a 512-channel latent, ResnetFC 512 x 5
blocks, 64 coarse + 32 fine samples), weights random from a seed:

- inference, in bf16: ``make_model`` -> ``encode`` of one 128^2 source
  view -> ``FullRenderer(fast=True).render_image`` of three 128x128 novel
  views (three requests), staged: kernel A's gather, kernel B's MLP;
- the fused field path: ``pack_encoding`` -> the unstaged renderer on
  ``PixelNeRFNet.query_fused`` (kernel D: gather and MLP in one launch),
  three requests;
- the baked field path: ``bake_encoding`` -> ``FullRenderer(fast=True)``,
  which renders a baked encoding unstaged (kernel A on the 1536-wide
  injection maps, kernel B with ``z_is_tz``), three requests;
- training: ``make_train_step`` steps on batches of the port's synthetic
  scenes at SRN geometry (128^2, focal 131.25, near 0.8, far 1.8), at the
  reference config (f32, 4 objects x 128 rays, unchunked, 20 steps on one
  batch) and at the chip-filling config (bf16 compute, f32 parameters and
  Adam, 4 objects x 2048 rays, 256-ray chunks, ``remat="features"``,
  5 steps); and the training app itself for a few steps;
- the SRN evaluation workflow, f32, through the apps a user calls:
  ``apps.train -F srn`` -> ``apps.eval`` (and its resume) ->
  ``apps.eval_approx`` on an SRN-layout fixture.

Phases, one JSON line each:

1. device: ``nvidia-smi`` name and power limit, torch and CUDA versions
2. build: the five CUDA sources of ``pixelnerf_tpu_torch/csrc`` for
   sm_90a, one nvcc each, in parallel
3. kernel A (gather) and 4. kernel B (fused MLP) against their plain
   PyTorch versions at the inference path's shapes, with times, the bound
   and a library call's time; A also on the baked path's 1536-wide rows
5. main_path: the inference path, with A's and B's launch counts read
   around it
6. kernel_vs_plain_e2e: a 2048-ray crop rendered through the kernels and
   through their plain versions, on the same noise
7. kernel_c and 8. kernel_c_bwd: kernel C (weighted 4-row gather) and its
   backward against their plain versions at the training path's shapes
   (the backward also at the fine gather's and at a skewed input)
9. train: both training configs, with C's and C-bwd's launch counts read
   around each
10. train_app: ``apps.train.main`` for 2 x 2 batches (f32, 4 x 128 rays),
    eval and checkpoints included, with the launch counts read around it
11. train_kernel_vs_plain: one step of the reference config (a) at its
    full shape through the kernels and through their plain versions, from
    one state, batch and noise
12. kernel_b_tz: kernel B's ``z_is_tz`` variant and 13. kernel_d: the fused
    gather+MLP kernel, against their plain versions (D also against kernel
    B fed by kernel A, bit for bit), with the time of D's gather alone.
    B, B-tz and D are also held to their plain versions and timed at the
    fine pass's 1,572,864 rows and held to them at a ragged 700 rows, and
    report the bytes a launch moves through L2 and device memory as
    reckoned from the kernel's design
14. kernel_f and 15. kernel_e: the four formulations of the gather study
    through ``scripts/probe_gather_kernels_torch.py`` (small shapes,
    registers and spills) and ``scripts/bench_gather_torch.py`` (full
    scale, timed), float32 and bf16 tables
16. fused_path and 17. baked_path, with the launch counts of A, B and D
    read around each
18. fused_vs_staged_e2e: the 2048-ray crop through the fused, staged,
    plain and baked renders on the same noise
19. srn_workflow (run after 11): an SRN-layout fixture (2 objects x 251
    views at 128^2, train/val/test, written by the port's PNG writer),
    ``apps.train -F srn`` for 2 batches (C, C-bwd; its eval and visual
    through A), ``apps.eval`` of 8 target views per object with depth and
    comparison images (A), ``apps.eval`` again (resumed, nothing
    rendered), ``apps.eval_approx`` with both objects in one batch (A on a
    two-scene table); launch counts against the chunking, the eval render
    through A bit-equal to its plain version, ``finish.txt``'s PSNR
    against the written PNGs, seconds per step, ms per view and PNG
    decode ms

then the ``kernels`` line, the card's name and power limit, and
``{"ok": true, ...}`` as the last line. Any failure raises and exits
non-zero; without a GPU it exits non-zero before printing anything.

Usage: ``python3 chip_smoke.py`` from the root of the repository.
"""
import copy
import json
import math
import os
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.abspath(__file__))

# published H100 SXM peaks (NVIDIA data sheet): dense bf16 tensor-core rate,
# float32 rate off the tensor cores and HBM3 bandwidth
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

# SRN geometry (the SRN dataset's cameras, conf/exp/srn.conf renderer)
IMAGE = 128
FOCAL = 131.25
NEAR, FAR = 0.8, 1.8
RAY_CHUNK = IMAGE * IMAGE   # one image per chunk

# training configs (bench.py's reference and chip-filling train configs)
TRAIN_SB = 4
TRAIN_CONFIGS = {
    "a": {"dtype": None, "rays": 128, "ray_chunk": None, "remat": False, "steps": 20, "fixed_batch": True},
    "b": {"dtype": "bfloat16", "rays": 2048, "ray_chunk": 256, "remat": "features", "steps": 5,
          "fixed_batch": False},
}
TRAIN_LR = 1e-4


def emit(obj):
    print(json.dumps(obj), flush=True)


def time_ms(fn, reps, warmup=2):
    """Mean device time of ``fn`` over ``reps`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def bound(bytes_moved, flops, peak_flops):
    t_bytes = bytes_moved / PEAK_BYTES * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_kernel_a(dev, g):
    """Kernel A at one image's coarse gather: a 64x64x512 bf16 latent table,
    16384 rays x 64 samples, bf16 output (the MLP's input dtype)."""
    import torch.nn.functional as F

    from pixelnerf_tpu_torch.ops.gather import gather_bilerp, gather_bilerp_plain
    from pixelnerf_tpu_torch.ops.grid_sample import bilinear_pair_bases

    hl = wl = 64
    c = 512
    n = RAY_CHUNK * 64
    table = torch.randn((hl * wl, c), generator=g).to(torch.bfloat16).to(dev)
    ix = (torch.rand(n, generator=g) * (wl - 1)).to(dev)
    iy = (torch.rand(n, generator=g) * (hl - 1)).to(dev)
    base, w = bilinear_pair_bases(ix, iy, hl, wl)
    out = gather_bilerp(table, base, w, wl, torch.bfloat16)
    torch.cuda.synchronize()
    ref = gather_bilerp_plain(table, base, w, wl, torch.bfloat16)
    err = (out.float() - ref.float()).abs().max().item()
    # bit-equal by design (no contracted multiply-adds); 0 is expected
    tol = 0.0
    if not err <= tol:
        raise AssertionError(f"kernel A disagrees with its plain version: {err} > {tol}")
    ms = time_ms(lambda: gather_bilerp(table, base, w, wl, torch.bfloat16), reps=20)
    plain_ms = time_ms(lambda: gather_bilerp_plain(table, base, w, wl, torch.bfloat16), reps=5)
    # yardstick: F.grid_sample on the NCHW map, same points, same modes
    fmap = table.reshape(1, hl, wl, c).permute(0, 3, 1, 2).contiguous()
    grid = torch.stack([ix / (wl - 1) * 2 - 1, iy / (hl - 1) * 2 - 1], dim=-1).reshape(1, 1, n, 2)
    grid = grid.to(torch.bfloat16)
    library_ms = time_ms(
        lambda: F.grid_sample(fmap, grid, mode="bilinear", padding_mode="border", align_corners=True),
        reps=10,
    )
    bytes_moved = n * c * 2 + n * (8 + 8) + table.numel() * 2
    bound_ms, bound_by = bound(bytes_moved, 6 * n * c, PEAK_F32_FLOPS)
    res = {
        "name": "gather_bilerp", "route": "cuda",
        "source": "pixelnerf_tpu_torch/csrc/gather.cu",
        "replaces": "pixelnerf_tpu/ops/gather_pallas.py:110",
        "shape": {"table": [hl * wl, c], "points": n, "out_dtype": "bfloat16"},
        "max_abs_err": err, "tolerance": tol,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms, "library_call": "F.grid_sample(NCHW bf16, bilinear, border)",
    }
    # the baked path's shape: rows of a 1536-wide injection map. The plain
    # version holds several float32 copies of its output, so it is compared
    # on the first 131,072 points; the kernel is timed on all of them
    wide = torch.randn((hl * wl, 1536), generator=g).to(torch.bfloat16).to(dev)
    m = 131072
    out_w = gather_bilerp(wide, base, w, wl, torch.bfloat16)
    torch.cuda.synchronize()
    err_w = (out_w[:m].float() - gather_bilerp_plain(wide, base[:m], w[:m], wl, torch.bfloat16).float()).abs().max().item()
    del out_w
    if not err_w <= tol:
        raise AssertionError(f"kernel A disagrees with its plain version on 1536-wide rows: {err_w} > {tol}")
    bound_w, _ = bound(n * 1536 * 2 + n * (8 + 8) + wide.numel() * 2, 6 * n * 1536, PEAK_F32_FLOPS)
    res["wide_rows"] = {
        "table": [hl * wl, 1536], "points": n, "max_abs_err": err_w, "points_compared": m,
        "ms": time_ms(lambda: gather_bilerp(wide, base, w, wl, torch.bfloat16), reps=10), "bound_ms": bound_w,
    }
    emit({"phase": "kernel_a", **res})
    return res


def check_kernel_b(dev, g, mlp):
    """Kernel B at the coarse pass's shape: one image's 16384 x 64 samples
    through the SRN fine MLP's weights (512 wide, 5 blocks, 3 injections)."""
    from pixelnerf_tpu_torch.ops.fused_mlp import (
        fused_resnetfc_infer, fused_resnetfc_infer_plain, pack_weights,
    )

    n = RAY_CHUNK * 64
    z = torch.randn((n, mlp.d_latent), generator=g).to(torch.bfloat16).to(dev)
    x = torch.randn((n, mlp.d_in), generator=g).to(torch.bfloat16).to(dev)
    weights = pack_weights(mlp)
    out = fused_resnetfc_infer(z, x, weights, mlp.n_blocks, mlp.combine_layer)
    torch.cuda.synchronize()
    ref = fused_resnetfc_infer_plain(z, x, weights, mlp.n_blocks, mlp.combine_layer)
    err, tol, close = assert_mlp_close(out, ref, "kernel B")
    ms = time_ms(lambda: fused_resnetfc_infer(z, x, weights, mlp.n_blocks, mlp.combine_layer), reps=5)
    plain_ms = time_ms(
        lambda: fused_resnetfc_infer_plain(z, x, weights, mlp.n_blocks, mlp.combine_layer), reps=2, warmup=1
    )
    # yardstick: the same chain as bf16 torch.matmul calls (cuBLAS), the
    # dense path of ResnetFC outside the kernel's gate
    library_ms = time_ms(lambda: mlp((z, x), combine_inner_dims=(1, n), fast=False), reps=3, warmup=1)
    dh, n_lin_z = mlp.d_hidden, mlp.n_lin_z
    flops = mlp_flops(n, weights, mlp)
    bytes_moved = n * (mlp.d_in + mlp.d_latent) * 2 + n * 4 * 4 + sum(w.numel() * 2 for w in weights)
    bound_ms, bound_by = bound(bytes_moved, flops, PEAK_BF16_FLOPS)
    res = {
        "name": "fused_resnetfc_infer", "route": "cuda",
        "source": "pixelnerf_tpu_torch/csrc/fused_mlp.cu",
        "replaces": "pixelnerf_tpu/ops/fused_mlp.py:68",
        "shape": {"rows": n, "d_hidden": dh, "d_latent": mlp.d_latent, "d_in": mlp.d_in,
                  "n_blocks": mlp.n_blocks, "n_lin_z": n_lin_z},
        "max_abs_err": err, "tolerance": tol, "frac_within_1e-2": close,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms, "library_call": "bf16 torch.matmul chain (ResnetFC fast=False)",
        "tflops": flops / ms / 1e9, **mlp_traffic(n, ms, weights, mlp.d_latent * 2, bytes_moved),
    }

    def other_shape(m):
        zm = torch.randn((m, mlp.d_latent), generator=g).to(torch.bfloat16).to(dev)
        xm = torch.randn((m, mlp.d_in), generator=g).to(torch.bfloat16).to(dev)
        return (zm, xm, weights, mlp.n_blocks, mlp.combine_layer)

    res.update(mlp_other_shapes(fused_resnetfc_infer, fused_resnetfc_infer_plain, other_shape, "kernel B",
                                lambda m: mlp_flops(m, weights, mlp)))
    emit({"phase": "kernel_b", **res})
    return res


FINE_ROWS = RAY_CHUNK * 96     # the fine pass's launch: 64 coarse + 32 fine samples per ray
RAGGED_ROWS = 700              # a last tile of 60 rows


def mlp_other_shapes(run, plain, make_args, what, flops_of):
    """A fused MLP kernel at the fine pass's 1,572,864 rows (the launch the
    paths really make: held to its plain version and timed) and at a ragged
    700 rows (held to its plain version)."""
    args = make_args(FINE_ROWS)
    out = run(*args)
    torch.cuda.synchronize()
    err, _, close = assert_mlp_close(out, plain(*args), f"{what} at {FINE_ROWS} rows")
    del out
    ms = time_ms(lambda: run(*args), reps=5)
    del args
    args = make_args(RAGGED_ROWS)
    out = run(*args)
    torch.cuda.synchronize()
    err_r, _, _ = assert_mlp_close(out, plain(*args), f"{what} at {RAGGED_ROWS} rows")
    return {"fine_shape": {"rows": FINE_ROWS, "ms": ms, "tflops": flops_of(FINE_ROWS) / ms / 1e9,
                           "max_abs_err": err, "frac_within_1e-2": close},
            "ragged_shape": {"rows": RAGGED_ROWS, "max_abs_err": err_r}}


def mlp_traffic(n, ms, weights, l2_row_bytes, hbm_bytes):
    """Bytes a launch of the fused MLP body moves, reckoned from its design
    (csrc/mlp_body.cuh), and the rates they make at ``ms``. Through L2:
    every 64-row tile streams the tiled weight image, and ``l2_row_bytes``
    per row for the z tile (the latents once per tile; the baked
    injections, a slice per injection; kernel D's gather, four map rows per
    point). Through device memory: ``hbm_bytes``, each input read once and
    each output written once, as the bound counts them."""
    l2 = -(-n // 64) * weights.image.numel() * 2 + n * l2_row_bytes
    return {"l2_gb_per_launch": l2 / 1e9, "l2_tb_per_s": l2 / ms / 1e9,
            "hbm_gb_per_launch": hbm_bytes / 1e9, "hbm_tb_per_s": hbm_bytes / ms / 1e9}


def mlp_flops(n, weights, mlp, with_wz=True):
    """Operations of the fused MLP on n rows, padded as
    pixelnerf_tpu/ops/fused_mlp.py:130-134 counts them."""
    dh, d_in_pad = weights[0].shape
    n_lin_z = min(mlp.combine_layer, mlp.n_blocks) if with_wz else 0
    return 2 * n * dh * (d_in_pad + n_lin_z * dh + 2 * mlp.n_blocks * dh + 128)


def assert_mlp_close(out, ref, what):
    """Kernel B's tolerance: both sides accumulate bf16 products in float32,
    in other orders; one flipped bf16 rounding is carried by the later
    layers (the tolerance of tests/test_fused_mlp.py), and nearly all
    entries agree closely. Returns (max abs err, tolerance, share < 1e-2)."""
    diff = (out - ref).abs()
    err = diff.max().item()
    atol = rtol = 5e-2
    bad = (diff > atol + rtol * ref.abs()).sum().item()
    close = (diff < 1e-2).float().mean().item()
    if bad or close < 0.95 or not torch.isfinite(out).all():
        raise AssertionError(f"{what} disagrees with its plain version: max {err}, {bad} outside, {close} close")
    return err, {"atol": atol, "rtol": rtol}, close


def check_kernel_b_tz(dev, g, mlp):
    """Kernel B with z_is_tz at the baked path's coarse shape: 16384 x 64
    samples, the injections 3 x 512 wide, the SRN fine MLP's weights."""
    from pixelnerf_tpu_torch.ops.fused_mlp import (
        fused_resnetfc_infer, fused_resnetfc_infer_plain, pack_weights,
    )

    n = RAY_CHUNK * 64
    d_tz = mlp.n_lin_z * mlp.d_hidden
    tz = torch.randn((n, d_tz), generator=g).to(torch.bfloat16).to(dev)
    x = torch.randn((n, mlp.d_in), generator=g).to(torch.bfloat16).to(dev)
    weights = pack_weights(mlp, with_wz=False)
    args = (tz, x, weights, mlp.n_blocks, mlp.combine_layer, True)
    out = fused_resnetfc_infer(*args)
    torch.cuda.synchronize()
    err, tol, close = assert_mlp_close(out, fused_resnetfc_infer_plain(*args), "kernel B (z_is_tz)")
    ms = time_ms(lambda: fused_resnetfc_infer(*args), reps=5)
    plain_ms = time_ms(lambda: fused_resnetfc_infer_plain(*args), reps=2, warmup=1)
    # yardstick: the bf16 torch.matmul chain without the wz product
    library_ms = time_ms(
        lambda: mlp((tz, x), combine_inner_dims=(1, n), fast=False, z_pretransformed=True), reps=3, warmup=1)
    flops = mlp_flops(n, weights, mlp, with_wz=False)
    bytes_moved = n * (mlp.d_in + d_tz) * 2 + n * 4 * 4 + sum(w.numel() * 2 for w in weights if w is not None)
    bound_ms, bound_by = bound(bytes_moved, flops, PEAK_BF16_FLOPS)
    res = {
        "name": "fused_resnetfc_infer[z_is_tz]", "route": "cuda",
        "source": "pixelnerf_tpu_torch/csrc/fused_mlp.cu",
        "replaces": "pixelnerf_tpu/ops/fused_mlp.py:68 (z_is_tz, :52)",
        "shape": {"rows": n, "d_hidden": mlp.d_hidden, "d_tz": d_tz, "d_in": mlp.d_in, "n_blocks": mlp.n_blocks},
        "max_abs_err": err, "tolerance": tol, "frac_within_1e-2": close,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms,
        "library_call": "bf16 torch.matmul chain without the wz product (ResnetFC fast=False, z_pretransformed)",
        "tflops": flops / ms / 1e9, **mlp_traffic(n, ms, weights, d_tz * 2, bytes_moved),
    }
    del tz, x, out, args

    def other_shape(m):
        tzm = torch.randn((m, d_tz), generator=g).to(torch.bfloat16).to(dev)
        xm = torch.randn((m, mlp.d_in), generator=g).to(torch.bfloat16).to(dev)
        return (tzm, xm, weights, mlp.n_blocks, mlp.combine_layer, True)

    res.update(mlp_other_shapes(fused_resnetfc_infer, fused_resnetfc_infer_plain, other_shape, "kernel B (z_is_tz)",
                                lambda m: mlp_flops(m, weights, mlp, with_wz=False)))
    emit({"phase": "kernel_b_tz", **res})
    return res


def check_kernel_d(dev, g, mlp):
    """Kernel D at the fused path's coarse shape: 16384 x 64 points gathered
    from a 64x64x512 bf16 map inside the SRN fine MLP's kernel."""
    import torch.nn.functional as F

    from pixelnerf_tpu_torch.ops.fused_field import (
        fused_gather_resnetfc_infer, fused_gather_resnetfc_infer_plain, gather_prologue_probe,
    )
    from pixelnerf_tpu_torch.ops.fused_mlp import fused_resnetfc_infer, pack_weights
    from pixelnerf_tpu_torch.ops.gather import gather_bilerp
    from pixelnerf_tpu_torch.ops.grid_sample import bilinear_pair_bases

    hl = wl = 64
    c = mlp.d_latent
    n = RAY_CHUNK * 64
    table = torch.randn((hl * wl, c), generator=g).to(torch.bfloat16).to(dev)
    ix = (torch.rand(n, generator=g) * (wl - 1)).to(dev)
    iy = (torch.rand(n, generator=g) * (hl - 1)).to(dev)
    ix[:1000], iy[500:1500] = wl - 1, hl - 1       # the right and bottom borders, the last pixel
    base, wg = bilinear_pair_bases(ix, iy, hl, wl)
    x = torch.randn((n, mlp.d_in), generator=g).to(torch.bfloat16).to(dev)
    weights = pack_weights(mlp)
    args = (table, base, wg, x, weights, mlp.n_blocks, mlp.combine_layer, wl)

    def composition():
        z = gather_bilerp(table, base, wg, wl, torch.bfloat16)
        return fused_resnetfc_infer(z, x, weights, mlp.n_blocks, mlp.combine_layer)

    out = fused_gather_resnetfc_infer(*args)
    torch.cuda.synchronize()
    # one lerp and one MLP chain shared by the three kernels: bit-equal
    err_comp = (out - composition()).abs().max().item()
    if err_comp != 0.0:
        raise AssertionError(f"kernel D differs from kernel B fed by kernel A: {err_comp}")
    err, tol, close = assert_mlp_close(out, fused_gather_resnetfc_infer_plain(*args), "kernel D")
    ms = time_ms(lambda: fused_gather_resnetfc_infer(*args), reps=5)
    composition_ms = time_ms(composition, reps=5)
    prologue_ms = time_ms(lambda: gather_prologue_probe(*args), reps=10)
    plain_ms = time_ms(lambda: fused_gather_resnetfc_infer_plain(*args), reps=2, warmup=1)
    # yardstick: F.grid_sample on the NCHW map, then the bf16 torch.matmul chain
    fmap = table.reshape(1, hl, wl, c).permute(0, 3, 1, 2).contiguous()
    grid = torch.stack([ix / (wl - 1) * 2 - 1, iy / (hl - 1) * 2 - 1], dim=-1).reshape(1, 1, n, 2)
    grid = grid.to(torch.bfloat16)

    def library():
        z = F.grid_sample(fmap, grid, mode="bilinear", padding_mode="border", align_corners=True)
        return mlp((z[0, :, 0].t(), x), combine_inner_dims=(1, n), fast=False)

    library_ms = time_ms(library, reps=3, warmup=1)
    flops = mlp_flops(n, weights, mlp)
    bytes_moved = n * (8 + 8 + mlp.d_in * 2) + n * 4 * 4 + table.numel() * 2 + sum(w.numel() * 2 for w in weights)
    bound_ms, bound_by = bound(bytes_moved, flops, PEAK_BF16_FLOPS)
    res = {
        "name": "fused_gather_resnetfc_infer", "route": "cuda",
        "source": "pixelnerf_tpu_torch/csrc/fused_field.cu",
        "replaces": "pixelnerf_tpu/ops/fused_field.py:131",
        "shape": {"table": [hl * wl, c], "points": n, "d_hidden": mlp.d_hidden, "d_in": mlp.d_in,
                  "n_blocks": mlp.n_blocks, "n_lin_z": mlp.n_lin_z},
        "max_abs_err": err, "tolerance": tol, "frac_within_1e-2": close,
        "max_abs_err_vs_b_fed_by_a": err_comp,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms, "library_call": "F.grid_sample(NCHW bf16) + bf16 torch.matmul chain",
        "b_fed_by_a_ms": composition_ms, "gather_prologue_ms": prologue_ms,
        "gather_prologue_share": prologue_ms / ms, "tflops": flops / ms / 1e9,
        **mlp_traffic(n, ms, weights, 4 * c * 2, bytes_moved),
    }
    del base, wg, x, out, args

    def other_shape(m):
        ixm = (torch.rand(m, generator=g) * (wl - 1)).to(dev)
        iym = (torch.rand(m, generator=g) * (hl - 1)).to(dev)
        ixm[:50], iym[25:75] = wl - 1, hl - 1
        bm, wm = bilinear_pair_bases(ixm, iym, hl, wl)
        xm = torch.randn((m, mlp.d_in), generator=g).to(torch.bfloat16).to(dev)
        return (table, bm, wm, xm, weights, mlp.n_blocks, mlp.combine_layer, wl)

    res.update(mlp_other_shapes(fused_gather_resnetfc_infer, fused_gather_resnetfc_infer_plain, other_shape,
                                "kernel D", lambda m: mlp_flops(m, weights, mlp)))
    emit({"phase": "kernel_d", **res})
    return res


def check_gather_study(dev):
    """Kernels E and F: the four formulations through the two study
    scripts. The probe (small shapes; registers and spills) must pass for
    every formulation; the bench (full scale) must be bit-equal to the
    plain version on the same table, and its launches are the count of the
    study's path. Returns one kernels-line entry per formulation, timed
    from the bf16 table, the dtype the port's latents have."""
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import bench_gather_torch as bench
    import probe_gather_kernels_torch as probe

    from pixelnerf_tpu_torch.ops.gather_study import FORMULATIONS, gather_study

    probed = probe.run(dev)
    emit({"phase": "kernel_f", "shape": {"table": [probe.R, probe.C], "points": probe.N, "tile": probe.TILE},
          "probes": probed})
    failed = [r for r in probed if not r["ok"]]
    if failed:
        raise AssertionError(f"gather study probe failed: {failed}")
    for name in gather_study.launches:
        gather_study.launches[name] = 0
    timed = bench.run(dev)
    launches = dict(gather_study.launches)
    n, c = bench.P, bench.C
    by = {(r["name"], r["table"]): r for r in timed}
    bounds = {}
    for dtn, size in (("f32", 4), ("bf16", 2)):
        bounds[dtn] = bound(n * (32 + c * 4) + bench.H * bench.W * c * size, 7 * n * c, PEAK_F32_FLOPS)
    emit({"phase": "kernel_e", "shape": {"table": [bench.H * bench.W, c], "points": n, "tile": bench.TILE,
                                         "out_dtype": "float32"},
          "bound_ms": {k: v[0] for k, v in bounds.items()}, "bound_by": bounds["bf16"][1],
          "launches": launches, "timings": timed})
    # the kernels are bit-equal to the plain version (no contracted
    # multiply-adds); a library call sums in its own order, within float32
    # rounding of a 4-term sum
    failed = [r for r in timed if "error" in r
              or r.get("max_abs_err", 0.0) > (1e-5 if r["name"].startswith("F.") else 0.0)]
    if failed:
        raise AssertionError(f"gather study bench failed or is not bit-equal to its plain version: {failed}")
    entries = []
    for name in FORMULATIONS:
        if launches[name] == 0:
            raise AssertionError(f"the gather study's bench did not launch {name}")
        r = by[(name, "bf16")]
        e_kernel = name == "block_stage"
        entries.append({
            "name": f"gather_study[{name}]", "route": "cuda",
            "source": "pixelnerf_tpu_torch/csrc/gather_study.cu",
            "replaces": "scripts/bench_gather_pallas.py:48" if e_kernel else "scripts/probe_gather_kernels.py:25",
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "ms_f32_table": by[(name, "f32")]["ms"],
            "plain_ms": by[("plain version", "bf16")]["ms"],
            "bound_ms": bounds["bf16"][0], "bound_by": bounds["bf16"][1],
            "library_ms": by[("F.grid_sample (NCHW)", "bf16")]["ms"],
            "library_call": "F.grid_sample(NCHW bf16, bilinear, border)",
            "launches": launches[name],
        })
    return entries


def make_srn_model(dev, g):
    """The SRN model (conf/exp/srn.conf) in bf16 on ``dev``, weights from
    the generator ``g``. Returns (net, RenderConfig)."""
    from pixelnerf_tpu_torch.config import load_config
    from pixelnerf_tpu_torch.models import make_model
    from pixelnerf_tpu_torch.render import RenderConfig

    conf = load_config(os.path.join(REPO, "conf", "exp", "srn.conf"))
    conf["model"]["dtype"] = "bfloat16"
    net = make_model(conf["model"], device=dev, generator=g)
    with torch.no_grad():
        # seeded weights off the init: fc_1 starts at zero (identity blocks),
        # and a density bias makes the random field opaque, so the render
        # has depth in [near, far] and rgb that varies across the image
        for mlp in (net.mlp_coarse, net.mlp_fine):
            for blk in mlp.blocks:
                blk.fc_1.weight.copy_(torch.randn(blk.fc_1.weight.shape, generator=g).to(dev) * 0.02)
                blk.fc_1.bias.copy_(torch.randn(blk.fc_1.bias.shape, generator=g).to(dev) * 0.02)
            mlp.lin_out.bias[3] = 10.0
            mlp.lin_out.weight[:3] *= 0.1
            mlp.lin_out.weight[3] *= 0.01
    return net, RenderConfig.from_conf(conf["renderer"])


def source_view(g, dev):
    """A 128^2 synthetic source image in [-1, 1] (smooth colour fields plus
    noise from the generator), (1, 1, H, W, 3), and its c2w pose (1, 1, 4, 4)."""
    from pixelnerf_tpu_torch.utils import geometry

    yy, xx = torch.meshgrid(torch.linspace(-1, 1, IMAGE), torch.linspace(-1, 1, IMAGE), indexing="ij")
    img = torch.stack([torch.sin(3 * xx), torch.cos(2 * yy), xx * yy], dim=-1)
    img = 0.8 * img + 0.2 * torch.rand((IMAGE, IMAGE, 3), generator=g)
    pose = torch.from_numpy(geometry.look_at([0.0, 0.5, 1.2], [0.0, 0.0, 0.0]))
    return img.clamp(-1, 1)[None, None].to(dev), pose[None, None].to(dev)


def target_poses():
    """Camera-to-world poses of the novel views, one per request."""
    from pixelnerf_tpu_torch.utils import geometry

    return [geometry.look_at([1.3 * math.sin(a), 0.3, 1.3 * math.cos(a)], [0.0, 0.0, 0.0])
            for a in (0.6, 1.8, 3.0)]


def train_launches_per_step():
    """C's (and C-bwd's) launches per train step of each config: two
    gathers per ray chunk (the coarse samples, the new fine samples)."""
    return {k: 2 * (1 if tc["ray_chunk"] is None else tc["rays"] // tc["ray_chunk"])
            for k, tc in TRAIN_CONFIGS.items()}


def kernel_c_inputs(dev, g):
    """Kernel C at the chip-filling train config's coarse gather of one
    256-ray chunk: SB=4 latents of 64x64x512 bf16 folded into one
    16384-row table, 4 x 256 x 64 = 65,536 points (16,384 per view), bf16
    output. Also the same points as an NCHW map and a grid for
    ``F.grid_sample``."""
    from pixelnerf_tpu_torch.ops.grid_sample import bilinear_corners

    views, hl, wl, c = TRAIN_SB, 64, 64, 512
    per_view = 256 * 64
    table = torch.randn((views * hl * wl, c), generator=g).to(torch.bfloat16).to(dev)
    ix = (torch.rand((views, per_view), generator=g) * (wl - 1)).to(dev)
    iy = (torch.rand((views, per_view), generator=g) * (hl - 1)).to(dev)
    idx, w = bilinear_corners(ix, iy, hl, wl)
    idx = idx + (torch.arange(views, device=dev, dtype=torch.int32) * (hl * wl))[:, None, None]
    fmap = table.reshape(views, hl, wl, c).permute(0, 3, 1, 2).contiguous()
    grid = torch.stack([ix / (wl - 1) * 2 - 1, iy / (hl - 1) * 2 - 1], dim=-1)[:, None]
    return table, idx.reshape(-1, 4).contiguous(), w.reshape(-1, 4).contiguous(), fmap, grid.to(torch.bfloat16)


def check_kernel_c(dev, inputs):
    import torch.nn.functional as F

    from pixelnerf_tpu_torch.ops.gather_rows import gather_rows_lerp, gather_rows_lerp_plain

    table, idx, w, fmap, grid = inputs
    n, c = idx.shape[0], table.shape[1]
    out = gather_rows_lerp(table, idx, w, torch.bfloat16)
    torch.cuda.synchronize()
    ref = gather_rows_lerp_plain(table, idx, w, torch.bfloat16)
    err = (out.float() - ref.float()).abs().max().item()
    # bit-equal by design (no contracted multiply-adds); 0 is expected
    tol = 0.0
    if not err <= tol:
        raise AssertionError(f"kernel C disagrees with its plain version: {err} > {tol}")
    ms = time_ms(lambda: gather_rows_lerp(table, idx, w, torch.bfloat16), reps=50)
    plain_ms = time_ms(lambda: gather_rows_lerp_plain(table, idx, w, torch.bfloat16), reps=10)
    library_ms = time_ms(
        lambda: F.grid_sample(fmap, grid, mode="bilinear", padding_mode="border", align_corners=True),
        reps=20,
    )
    bytes_moved = n * c * 2 + n * (16 + 16) + table.numel() * 2
    bound_ms, bound_by = bound(bytes_moved, 7 * n * c, PEAK_F32_FLOPS)
    res = {
        "name": "gather_rows_lerp", "route": "cuda",
        "source": "pixelnerf_tpu_torch/csrc/gather_rows.cu",
        "replaces": "pixelnerf_tpu/ops/gather_pallas.py:172",
        "shape": {"table": list(table.shape), "points": n, "out_dtype": "bfloat16"},
        "max_abs_err": err, "tolerance": tol,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms, "library_call": "F.grid_sample(NCHW bf16, bilinear, border)",
        "launches_per_train_step": train_launches_per_step(),
    }
    emit({"phase": "kernel_c", **res})
    return res


def c_bwd_against_plain(table, idx, w, grad_out):
    """C-bwd on one input against its plain version, timed; raises if the
    two disagree."""
    from pixelnerf_tpu_torch.ops.gather_rows import gather_rows_lerp_bwd, gather_rows_lerp_bwd_plain

    n, c = idx.shape[0], table.shape[1]
    gt, gw = gather_rows_lerp_bwd(table, idx, w, grad_out)
    torch.cuda.synchronize()
    rt, rw = gather_rows_lerp_bwd_plain(table, idx, w, grad_out)
    err_t = (gt.float() - rt.float()).abs().max().item()
    err_w = (gw - rw).abs().max().item()
    # float32 sums in another order (the index's order within a row, set by
    # the fill's atomics; a warp's shuffle tree): a few float32 ulps of the
    # largest entry, plus one bf16 rounding of the table gradient that may
    # fall the other way (2^-8 of the entry)
    tol_t = 8e-3 * rt.float().abs().max().item()
    tol_w = 1e-5 * rw.abs().max().item()
    if not (err_t <= tol_t and err_w <= tol_w):
        raise AssertionError(f"kernel C-bwd disagrees with its plain version: {err_t} > {tol_t} or {err_w} > {tol_w}")
    bytes_moved = n * c * 2 + table.numel() * 2 + n * 32 + table.numel() * 2 + n * 16
    bound_ms, bound_by = bound(bytes_moved, 16 * n * c, PEAK_F32_FLOPS)
    return {
        "points": n, "max_abs_err": max(err_t, err_w), "max_abs_err_by_output": {"grad_table": err_t, "grad_w": err_w},
        "tolerance": {"grad_table": tol_t, "grad_w": tol_w},
        "ms": time_ms(lambda: gather_rows_lerp_bwd(table, idx, w, grad_out), reps=20),
        "plain_ms": time_ms(lambda: gather_rows_lerp_bwd_plain(table, idx, w, grad_out), reps=5),
        "bound_ms": bound_ms, "bound_by": bound_by,
    }


def check_kernel_c_bwd(dev, g, inputs):
    """C-bwd at the coarse gather's shape (the kernels line's numbers), the
    fine gather's 32,768 points and a skewed input (a quarter of the points
    in one cell; ``scripts/bench_gather_rows_bwd_torch.py`` makes both),
    each against its plain version; the library call at the coarse shape."""
    import torch.nn.functional as F

    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import bench_gather_rows_bwd_torch as bench

    table, idx, w, fmap, grid = inputs
    n, c = idx.shape[0], table.shape[1]
    grad_out = torch.randn((n, c), generator=g).to(torch.bfloat16).to(dev)
    by_input = {"uniform": c_bwd_against_plain(table, idx, w, grad_out)}
    g_more = torch.Generator().manual_seed(6)
    for kind in ("fine", "skewed"):
        by_input[kind] = c_bwd_against_plain(*bench.make_inputs(dev, g_more, kind))
    # yardstick: torch's grid-sampler backward for the same points, both
    # gradients (map and grid), timed on a retained graph
    fmap_g = fmap.detach().requires_grad_()
    grid_g = grid.detach().requires_grad_()
    out = F.grid_sample(fmap_g, grid_g, mode="bilinear", padding_mode="border", align_corners=True)
    gout = grad_out.reshape(TRAIN_SB, -1, c).permute(0, 2, 1)[:, :, None].contiguous()
    library_ms = time_ms(
        lambda: torch.autograd.grad(out, (fmap_g, grid_g), gout, retain_graph=True), reps=10
    )
    res = {
        "name": "gather_rows_lerp_bwd", "route": "cuda",
        "source": "pixelnerf_tpu_torch/csrc/gather_rows.cu",
        "replaces": "XLA gather transpose (pixelnerf_tpu/ops/grid_sample.py:126-133); no Pallas counterpart",
        "shape": {"table": list(table.shape), "points": n, "grad_out_dtype": "bfloat16"},
        **{k: v for k, v in by_input["uniform"].items() if k != "points"},
        "library_ms": library_ms,
        "library_call": "torch.autograd.grad through F.grid_sample (NCHW bf16 map and grid)",
        "inputs": by_input,
        "launches_per_train_step": train_launches_per_step(),
    }
    emit({"phase": "kernel_c_bwd", **res})
    return res


def train_setup(dev, key, seed=0):
    """The SRN model for training config ``key`` (weights from ``seed``),
    its Adam, the train step and the config's batches from the port's
    synthetic scenes at SRN geometry."""
    from pixelnerf_tpu_torch.config import load_config
    from pixelnerf_tpu_torch.data import RayBatchPipeline, SyntheticSphereDataset
    from pixelnerf_tpu_torch.models import make_model
    from pixelnerf_tpu_torch.render import RenderConfig

    tc = TRAIN_CONFIGS[key]
    conf = load_config(os.path.join(REPO, "conf", "exp", "srn.conf"))
    if tc["dtype"]:
        conf["model"]["dtype"] = tc["dtype"]
    net = make_model(conf["model"], device=dev, generator=torch.Generator().manual_seed(seed))
    cfg = RenderConfig.from_conf(conf["renderer"])
    ds = SyntheticSphereDataset(num_objects=TRAIN_SB, num_views=12, image_size=(IMAGE, IMAGE), radius=1.3)
    ds.focal, ds.z_near, ds.z_far = FOCAL, NEAR, FAR
    pipe = iter(RayBatchPipeline(ds, batch_size=TRAIN_SB, rays_per_object=tc["rays"], seed=seed,
                                 prefetch=0, workers=1))
    n_batches = 1 if tc["fixed_batch"] else tc["steps"]
    batches = [{k: torch.as_tensor(v).to(dev) for k, v in next(pipe).items() if k != "step"}
               for _ in range(n_batches)]
    return net, cfg, conf, batches


def run_train(dev, key):
    """Train config ``key`` on the card: per-step host time around work
    ending in a synchronize, the loss and gradient norm of every step,
    peak memory, and the launch counts of C and C-bwd (reset just before
    the steps, read just after)."""
    from pixelnerf_tpu_torch.ops.fused_mlp import fused_resnetfc_infer
    from pixelnerf_tpu_torch.ops.gather import gather_bilerp
    from pixelnerf_tpu_torch.ops.gather_rows import gather_rows_lerp, gather_rows_lerp_bwd
    from pixelnerf_tpu_torch.train import make_render_loss, make_train_step

    tc = TRAIN_CONFIGS[key]
    net, cfg, conf, batches = train_setup(dev, key)
    opt = torch.optim.Adam(net.parameters(), lr=TRAIN_LR, betas=(0.9, 0.999), eps=1e-8)
    step = make_train_step(net, cfg, opt, make_render_loss(conf["loss"]),
                           ray_chunk=tc["ray_chunk"], remat=tc["remat"])
    gen = torch.Generator(device=dev).manual_seed(3)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in (gather_rows_lerp, gather_rows_lerp_bwd, gather_bilerp, fused_resnetfc_infer):
        fn.launches = 0
    step_s, losses, gnorms = [], [], []
    for i in range(tc["steps"]):
        t0 = time.time()
        m = step(batches[i % len(batches)], generator=gen)
        torch.cuda.synchronize()
        step_s.append(time.time() - t0)
        losses.append(m["t"].item())
        gnorms.append(m["gnorm"].item())
    launches = {"gather_rows_lerp": gather_rows_lerp.launches,
                "gather_rows_lerp_bwd": gather_rows_lerp_bwd.launches,
                "gather_bilerp": gather_bilerp.launches,
                "fused_resnetfc_infer": fused_resnetfc_infer.launches}
    # the prediction: each chunk gathers twice (the coarse samples, the new
    # fine samples; the fine MLP reuses the coarse features), and each
    # gather has one backward; "features" remat recomputes only the MLPs,
    # so no gather runs again. No inference kernel runs.
    per_step = train_launches_per_step()[key]
    expect = {"gather_rows_lerp": per_step * tc["steps"], "gather_rows_lerp_bwd": per_step * tc["steps"],
              "gather_bilerp": 0, "fused_resnetfc_infer": 0}
    if launches != expect:
        raise AssertionError(f"train {key}: launch counts {launches} != expected {expect}")
    if not (all(math.isfinite(v) for v in losses) and all(math.isfinite(v) for v in gnorms)):
        raise AssertionError(f"train {key}: non-finite loss or gnorm: {losses}, {gnorms}")
    if tc["fixed_batch"] and not losses[-1] < losses[0]:
        raise AssertionError(f"train {key}: the loss did not fall on one batch: {losses}")
    steady = step_s[1:]
    steps_per_s = len(steady) / sum(steady)
    res = {
        "config": key, "model": f"conf/exp/srn.conf, {tc['dtype'] or 'float32'}",
        "objects": TRAIN_SB, "rays_per_object": tc["rays"], "ray_chunk": tc["ray_chunk"],
        "remat": tc["remat"], "steps": tc["steps"],
        "first_step_s": step_s[0], "step_s": step_s, "steps_per_s_steady": steps_per_s,
        "train_rays_per_s_steady": steps_per_s * TRAIN_SB * tc["rays"],
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "loss": losses, "gnorm": gnorms,
        "launches": launches, "launches_per_step": {"gather_rows_lerp": per_step, "gather_rows_lerp_bwd": per_step},
    }
    emit({"phase": "train", **res})
    return res


def run_app(module, argv):
    """``module.main(argv)`` with its printed lines captured; returns
    (result, lines, seconds, launches of every kernel counter, reset to 0
    just before)."""
    import contextlib
    import io

    counters = {**inference_kernels(), **train_kernels()}
    for fn in counters.values():
        fn.launches = 0
    out = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.time()
    with contextlib.redirect_stdout(out):
        result = module.main(argv)
    torch.cuda.synchronize()
    seconds = time.time() - t0
    return result, out.getvalue().splitlines(), seconds, {k: fn.launches for k, fn in counters.items()}


def train_kernels():
    from pixelnerf_tpu_torch.ops.gather_rows import gather_rows_lerp, gather_rows_lerp_bwd

    return {"gather_rows_lerp": gather_rows_lerp, "gather_rows_lerp_bwd": gather_rows_lerp_bwd}


def vis_chunks():
    """Ray chunks of the train app's visual: one IMAGE x IMAGE view in
    chunks of ``VIS_RAY_CHUNK`` rays."""
    from pixelnerf_tpu_torch.apps.train import VIS_RAY_CHUNK

    return -(-IMAGE * IMAGE // VIS_RAY_CHUNK)


def run_train_app(dev):
    """The user's entry point, ``python -m pixelnerf_tpu_torch.apps.train``,
    on the card: the SRN model in f32, 4 objects x 128 rays of the
    synthetic scenes (128^2, cameras at radius 1.3), 2 epochs x 2 batches,
    with the trainer's eval (kernel A's gather) and checkpoints, written to
    a temporary directory. Its printed metrics are captured, not echoed."""
    import tempfile

    from pixelnerf_tpu_torch.apps import train as train_app
    from pixelnerf_tpu_torch.train import load_variables

    os.environ["PIXELNERF_NO_TB"] = "1"
    epochs, batches = 2, 2
    with tempfile.TemporaryDirectory() as tmp:
        argv = [
            "-n", "chip_smoke", "-c", os.path.join(REPO, "conf", "exp", "srn.conf"), "-F", "synthetic",
            "--epochs", str(epochs), "--epoch_batches", str(batches), "--device", str(dev), "--workers", "1",
            "--checkpoints_path", os.path.join(tmp, "ck"), "--logs_path", os.path.join(tmp, "logs"),
            "--visual_path", os.path.join(tmp, "vis"),
            "--override", f"data.image_size=[{IMAGE}, {IMAGE}]", "--override", f"data.num_objects={TRAIN_SB}",
            "--override", "data.radius=1.3",
        ]
        trainer, lines, seconds, launches = run_app(train_app, argv)
        saved = load_variables(os.path.join(tmp, "ck", "chip_smoke"))
        visuals = sorted(os.listdir(os.path.join(tmp, "vis", "chip_smoke")))
    losses = [float(l.split(" t:")[1].split()[0]) for l in lines if l.startswith("E")]
    evals = [l for l in lines if l.startswith("*** eval:")]
    steps = epochs * batches
    # unchunked train steps: 2 gathers and 2 backwards each; at batch 1 of
    # each epoch the trainer's eval renders through kernel A (2 launches)
    # and so does its visual, one full view in chunks of VIS_RAY_CHUNK rays
    expect = {"gather_rows_lerp": 2 * steps, "gather_rows_lerp_bwd": 2 * steps,
              "gather_bilerp": (2 + 2 * vis_chunks()) * epochs, "fused_resnetfc_infer": 0,
              "fused_gather_resnetfc_infer": 0}
    res = {"phase": "train_app", "argv": argv[2:], "seconds": seconds, "steps": trainer.step,
           "printed_losses": losses, "evals": len(evals), "checkpoint_step": saved and saved["step"],
           "visuals": visuals, "launches": launches, "expected_launches": expect}
    emit(res)
    if launches != expect:
        raise AssertionError(f"train app: launch counts {launches} != expected {expect}")
    if trainer.step != steps or not saved or saved["step"] != steps or len(evals) != epochs:
        raise AssertionError(f"train app: steps {trainer.step}, checkpoint {saved and saved['step']}, "
                             f"evals {len(evals)}")
    if len(visuals) != epochs:
        raise AssertionError(f"train app: visuals {visuals}")
    if not losses or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"train app: printed losses {losses}")
    return res


def train_kernel_vs_plain(dev):
    """One step of the reference config (f32, SB=4, 128 rays per object,
    unchunked: kernel C and C-bwd on an f32 table at 32,768 coarse points),
    from one state, batch and noise, through kernel C and its backward and
    through their plain versions."""
    from pixelnerf_tpu_torch.render import draw_noise
    from pixelnerf_tpu_torch.train import make_render_loss, make_train_step

    rays = TRAIN_CONFIGS["a"]["rays"]
    net, cfg, conf, batches = train_setup(dev, "a", seed=5)
    batch = batches[0]
    noise = [draw_noise(batch["rays"], cfg, torch.Generator(device=dev).manual_seed(4), train=True)]
    runs = {}
    for use_kernels in (True, False):
        model = copy.deepcopy(net)
        opt = torch.optim.Adam(model.parameters(), lr=TRAIN_LR, betas=(0.9, 0.999), eps=1e-8)
        step = make_train_step(model, cfg, opt, make_render_loss(conf["loss"]), use_kernels=use_kernels)
        m = step(batch, noise=noise)
        # the step leaves this step's gradients in .grad
        runs[use_kernels] = (
            m["t"].item(),
            {k: p.grad for k, p in model.named_parameters() if p.grad is not None},
            {k: p.detach() for k, p in model.named_parameters()},
        )
    (loss_k, grads_k, params_k), (loss_p, grads_p, params_p) = runs[True], runs[False]
    # the forward is bit-equal (kernel C is); only the backward's float32
    # sums differ in order (atomics, shuffle tree), so every gradient
    # agrees to float32 rounding of its largest entry
    loss_err = abs(loss_k - loss_p)
    grad_err = max(((grads_k[k] - grads_p[k]).abs().max() / grads_p[k].abs().max().clamp_min(1e-30)).item()
                   for k in grads_p)
    # Adam's first move is ~lr * sign(g): equal where the sign is clear,
    # at most 2 lr apart where a gradient entry is ~0
    clear_err, any_err = 0.0, 0.0
    for k in params_p:
        d = (params_k[k] - params_p[k]).abs()
        clear = grads_p[k].abs() > max(1e-3 * grads_p[k].abs().max().item(), 1e-5)
        clear_err = max(clear_err, torch.where(clear, d, torch.zeros((), device=dev)).max().item())
        any_err = max(any_err, d.max().item())
    # the loss is expected bit-equal; a float32 ulp of slack
    tol = {"loss": 1e-6 * abs(loss_p), "grad_rel": 1e-4, "param_clear_sign": 1e-6,
           "param_any": 2 * TRAIN_LR + 1e-6}
    res = {"phase": "train_kernel_vs_plain", "config": "a", "rays_per_object": rays,
           "loss": {"kernels": loss_k, "plain": loss_p}, "max_abs_err": {
               "loss": loss_err, "grad_rel": grad_err, "param_clear_sign": clear_err, "param_any": any_err},
           "tolerance": tol, "gradients": len(grads_p)}
    emit(res)
    if len(grads_k) != len(grads_p) or len(grads_p) != len(list(net.parameters())):
        raise AssertionError("a parameter got no gradient")
    if not (loss_err <= tol["loss"] and grad_err <= tol["grad_rel"] and clear_err <= tol["param_clear_sign"]
            and any_err <= tol["param_any"]):
        raise AssertionError(f"train step through the kernels disagrees with the plain step: {res['max_abs_err']}")
    return res


# the SRN evaluation workflow: SRN cars' test split has 251 views of each
# object and its train split 50; 2 objects, 8 target views each, source
# view 64 as in the reference's evaluation
SRN_OBJECTS = 2
SRN_VIEWS = {"train": 50, "val": 50, "test": 251}
SRN_SOURCE = 64
SRN_TARGETS = (0, 31, 63, 95, 127, 159, 191, 250)


def write_srn_fixture(root):
    """An SRN-layout ``cars`` dataset with train, val and test splits of
    SRN_OBJECTS objects, SRN_VIEWS[split] views each at IMAGE^2, rendered by
    the port's synthetic scenes (cameras at radius 1.3) and written by the
    port's PNG writer with the five row filters in turn, so that reading
    them takes the reader's wavefront path, as adaptively filtered files
    (Pillow's) do; poses stored before the reader's coordinate flip, as SRN
    stores them. Returns the dataset path (``-D``)."""
    import numpy as np

    from pixelnerf_tpu_torch.data import SyntheticSphereDataset
    from pixelnerf_tpu_torch.utils import png

    flip = np.diag([1.0, -1.0, -1.0, 1.0]).astype(np.float32)
    for stage in ("train", "val", "test"):
        ds = SyntheticSphereDataset(num_objects=SRN_OBJECTS, num_views=SRN_VIEWS[stage],
                                    image_size=(IMAGE, IMAGE), radius=1.3, stage=stage, cache_cap=0)
        for i in range(len(ds)):
            d = ds[i]
            obj = os.path.join(root, f"cars_{stage}", f"{stage}_{i:02d}")
            os.makedirs(os.path.join(obj, "rgb"))
            os.makedirs(os.path.join(obj, "pose"))
            with open(os.path.join(obj, "intrinsics.txt"), "w") as f:
                f.write(f"{d['focal']} {d['c'][0]} {d['c'][1]} 0.\n0. 0. 0.\n1.\n{IMAGE} {IMAGE}\n")
            for v in range(SRN_VIEWS[stage]):
                png.imwrite(os.path.join(obj, "rgb", f"{v:06d}.png"),
                            ((d["images"][v] * 0.5 + 0.5) * 255).astype(np.uint8), filters=np.arange(IMAGE) % 5)
                np.savetxt(os.path.join(obj, "pose", f"{v:06d}.txt"), (d["poses"][v] @ flip).reshape(1, 16))
    return os.path.join(root, "cars")


def png_decode_ms(paths, data):
    """Host ms per image of reading the fixture's IMAGE^2 RGB files (five
    row filters): 50 of them one at a time (``png.imread``) and all of one
    object's views in one call (``png.imread_many``, as the SRN reader
    reads them); and host ms of the SRN reader's ``__getitem__`` (decode,
    poses, masks, bboxes) for the first object of each split. Both reads
    must give the same pixels."""
    import numpy as np

    from pixelnerf_tpu_torch.data import get_split_dataset
    from pixelnerf_tpu_torch.utils import png

    t0 = time.perf_counter()
    one = [png.imread(p) for p in paths[:50]]
    single_ms = (time.perf_counter() - t0) * 1e3 / len(one)
    t0 = time.perf_counter()
    many = png.imread_many(paths)
    many_ms = (time.perf_counter() - t0) * 1e3 / len(paths)
    if not all(np.array_equal(a, b) for a, b in zip(one, many)):
        raise AssertionError("png: imread_many differs from imread")
    res = {"imread_rgb": single_ms, "imread_many_rgb": many_ms, "images": len(paths)}
    for stage in ("train", "test"):
        ds = get_split_dataset("srn", data, stage, image_size=(IMAGE, IMAGE))
        t0 = time.perf_counter()
        ds[0]
        res[f"srn_item_ms_{stage}_{SRN_VIEWS[stage]}_views"] = (time.perf_counter() - t0) * 1e3
    return res


def psnr_interval_from_png(pred_u8, gt):
    """The PSNR of a float render whose ``(x * 255).astype(uint8)`` is
    ``pred_u8``, bounded from the written image: the float differs from
    ``pred_u8 / 255`` by [0, 1/255) per value, so its MSE lies within
    2 sqrt(mse) / 255 + 1/255^2 of the image's."""
    import numpy as np

    e = pred_u8.astype(np.float64) / 255.0 - np.asarray(gt, np.float64)
    mse = float(np.mean(e * e))
    d = 2.0 * math.sqrt(mse) / 255.0 + 1.0 / 255.0 ** 2
    lo_mse, hi_mse = max(mse - d, 1e-30), mse + d
    return -10.0 * math.log10(hi_mse), -10.0 * math.log10(lo_mse)


def run_srn_workflow(dev):
    """The user's SRN evaluation workflow on the card, on an SRN-layout
    fixture: ``apps.train -F srn`` (kernels C and C-bwd; its eval and
    visual through kernel A), ``apps.eval`` with depth and comparison
    images (kernel A), ``apps.eval`` again (resumed from ``finish.txt``),
    ``apps.eval_approx`` with two objects in one batch (kernel A on a
    two-scene table). Each app's kernel counts are set to 0 just before it
    and read just after, and held to the counts its chunking gives; one
    object's eval render through kernel A is held bit for bit to the same
    render through its plain version on the same draws; the PSNR in
    ``finish.txt`` is held to the written images; file counts, finite
    values and rgb in [0, 1] are checked."""
    import contextlib
    import io
    import tempfile

    import numpy as np

    from pixelnerf_tpu_torch.apps import eval as eval_app
    from pixelnerf_tpu_torch.apps import eval_approx
    from pixelnerf_tpu_torch.apps import train as train_app
    from pixelnerf_tpu_torch.apps.args import parse_args
    from pixelnerf_tpu_torch.data import get_split_dataset
    from pixelnerf_tpu_torch.eval import FullRenderer
    from pixelnerf_tpu_torch.utils import png
    from pixelnerf_tpu_torch.utils.exr import read_exr

    os.environ["PIXELNERF_NO_TB"] = "1"
    conf = os.path.join(REPO, "conf", "exp", "srn.conf")
    seconds = {}
    res = {"phase": "srn_workflow", "objects": SRN_OBJECTS, "views_per_object": SRN_VIEWS,
           "image": IMAGE, "source": SRN_SOURCE, "targets": list(SRN_TARGETS)}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        data = write_srn_fixture(os.path.join(tmp, "data"))
        seconds["write_fixture"] = time.time() - t0
        rgb_dir = os.path.join(tmp, "data", "cars_test", "test_00", "rgb")
        res["png_decode_ms"] = png_decode_ms([os.path.join(rgb_dir, f) for f in sorted(os.listdir(rgb_dir))], data)
        common = ["-c", conf, "-F", "srn", "-D", data, "--device", str(dev),
                  "--checkpoints_path", os.path.join(tmp, "ck")]

        # 1. train: 1 epoch x 2 batches of 2 objects x 128 rays (f32), with
        # its eval, visual and checkpoint at batch 1 and a checkpoint at
        # the epoch's end
        argv = common + ["-B", "2", "--epochs", "1", "--epoch_batches", "2", "--workers", "1",
                         "--logs_path", os.path.join(tmp, "logs"), "--visual_path", os.path.join(tmp, "vis")]
        trainer, lines, seconds["train"], launches = run_app(train_app, argv)
        expect = {"gather_rows_lerp": 2 * 2, "gather_rows_lerp_bwd": 2 * 2,
                  "gather_bilerp": 2 + 2 * vis_chunks(), "fused_resnetfc_infer": 0,
                  "fused_gather_resnetfc_infer": 0}
        losses = [float(l.split(" t:")[1].split()[0]) for l in lines if l.startswith("E")]
        visuals = os.listdir(os.path.join(tmp, "vis", "example"))
        res["train"] = {"steps": trainer.step, "rays_per_object": trainer.train_pipeline.rays_per_object,
                        "losses": losses, "visuals": visuals,
                        "launches": launches, "expected_launches": expect}
        if launches != expect:
            raise AssertionError(f"srn_workflow train: launch counts {launches} != expected {expect}")
        if trainer.step != 2 or not losses or not all(math.isfinite(v) for v in losses) or len(visuals) != 1:
            raise AssertionError(f"srn_workflow train: steps {trainer.step}, losses {losses}, visuals {visuals}")

        # 2. eval: 8 target views of each object from source view 64
        view_list = os.path.join(tmp, "views.txt")
        with open(view_list, "w") as f:
            f.write(" ".join(str(v) for v in SRN_TARGETS) + "\n")
        out_dir = os.path.join(tmp, "eval_out")
        argv = common + ["-P", str(SRN_SOURCE), "--eval_view_list", view_list, "--write_depth",
                         "--write_compare", "-O", out_dir]
        _, lines, seconds["eval"], launches = run_app(eval_app, argv)
        chunk = int(parse_args(eval_app.extra_args, argv=argv)[0].ray_batch_size)
        per_object = 2 * -(-len(SRN_TARGETS) * IMAGE * IMAGE // chunk)
        expect = {"gather_rows_lerp": 0, "gather_rows_lerp_bwd": 0, "gather_bilerp": per_object * SRN_OBJECTS,
                  "fused_resnetfc_infer": 0, "fused_gather_resnetfc_infer": 0}
        finish = open(os.path.join(out_dir, "finish.txt")).read().splitlines()
        res["eval"] = {"ray_chunk": chunk, "printed": [l for l in lines if "psnr" in l], "finish": finish,
                       "launches": launches, "expected_launches": expect,
                       "gather_bilerp_launches_per_view": launches["gather_bilerp"] / (len(SRN_TARGETS) * SRN_OBJECTS)}
        if launches != expect:
            raise AssertionError(f"srn_workflow eval: launch counts {launches} != expected {expect}")
        if len(finish) != SRN_OBJECTS or not any(l.startswith("FINAL psnr") for l in lines):
            raise AssertionError(f"srn_workflow eval: finish.txt {finish}, printed {lines[-3:]}")
        test_set = get_split_dataset("srn", data, "test", image_size=(IMAGE, IMAGE))
        for obj_idx, line in enumerate(finish):
            name, psnr, ssim, n = line.split()
            obj_dir = os.path.join(out_dir, name)
            files = sorted(os.listdir(obj_dir))
            want = sorted(f"{v:06d}{suffix}" for v in SRN_TARGETS
                          for suffix in (".png", "_compare.png", "_depth.exr", "_depth_norm.png"))
            if files != want or int(n) != len(SRN_TARGETS):
                raise AssertionError(f"srn_workflow eval: {name} holds {files}, n {n}")
            gt = test_set[obj_idx]["images"] * 0.5 + 0.5
            bounds = [psnr_interval_from_png(png.imread(os.path.join(obj_dir, f"{v:06d}.png")), gt[v])
                      for v in SRN_TARGETS]
            lo, hi = (sum(b[i] for b in bounds) / len(bounds) for i in (0, 1))
            depth = read_exr(os.path.join(obj_dir, f"{SRN_TARGETS[0]:06d}_depth.exr"))
            if not (lo <= float(psnr) <= hi and math.isfinite(float(ssim)) and np.isfinite(depth).all()):
                raise AssertionError(f"srn_workflow eval: {name} psnr {psnr} outside [{lo}, {hi}] "
                                     f"from its images, or non-finite ssim/depth")
            res["eval"].setdefault("psnr_from_png", []).append([lo, hi])

        # 3. resume: both objects are in finish.txt, nothing is rendered
        _, lines, seconds["eval_resume"], launches = run_app(eval_app, argv)
        resumed = open(os.path.join(out_dir, "finish.txt")).read().splitlines()
        res["eval_resume"] = {"launches": launches, "finish_unchanged": resumed == finish}
        if resumed != finish or any(launches.values()) or not any(l.startswith("FINAL psnr") for l in lines):
            raise AssertionError(f"srn_workflow resume: finish {resumed}, launches {launches}")

        # 4. eval_approx: both objects in one SB = 2 batch
        argv = common + ["-P", str(SRN_SOURCE), "-B", str(SRN_OBJECTS)]
        approx, lines, seconds["eval_approx"], launches = run_app(eval_approx, argv)
        chunk = int(parse_args(eval_approx.extra_args, argv=argv)[0].ray_batch_size)
        expect = {"gather_rows_lerp": 0, "gather_rows_lerp_bwd": 0,
                  "gather_bilerp": 2 * -(-IMAGE * IMAGE // chunk), "fused_resnetfc_infer": 0,
                  "fused_gather_resnetfc_infer": 0}
        res["eval_approx"] = {"psnr_ssim": approx, "launches": launches, "expected_launches": expect}
        if launches != expect:
            raise AssertionError(f"srn_workflow eval_approx: launch counts {launches} != expected {expect}")
        if approx is None or not all(math.isfinite(v) for v in approx):
            raise AssertionError(f"srn_workflow eval_approx: {approx}")

        # 5. one object's eval render through kernel A and through its plain
        # version, the same checkpoint and draws: bit for bit
        args, cfg_tree = parse_args(eval_app.extra_args, argv=common + ["-P", str(SRN_SOURCE)])
        with contextlib.redirect_stdout(io.StringIO()):
            net = eval_app.load_net_and_state(args, cfg_tree, dev)
        cfg = eval_app.eval_render_config(cfg_tree, test_set, coarse=False)
        d = test_set[0]
        src, targets = np.array([SRN_SOURCE]), np.array(SRN_TARGETS)
        renders = {}
        for use_kernels in (True, False):
            renderer = FullRenderer(net, cfg, ray_chunk=args.ray_batch_size, use_kernels=use_kernels)
            gen = torch.Generator(device=dev).manual_seed(9)
            torch.cuda.synchronize()
            t0 = time.time()
            renders[use_kernels] = eval_app.render_object(renderer, d, src, targets, test_set.z_near,
                                                          test_set.z_far, generator=gen)
            torch.cuda.synchronize()
            seconds["render_" + ("kernels" if use_kernels else "plain")] = time.time() - t0
        (rgb_k, depth_k), (rgb_p, depth_p) = renders[True], renders[False]
        err = {"rgb": (rgb_k - rgb_p).abs().max().item(), "depth": (depth_k - depth_p).abs().max().item()}
        res["kernel_vs_plain"] = {"max_abs_err": err, "tolerance": 0.0,
                                  "rgb_range": [rgb_k.min().item(), rgb_k.max().item()],
                                  "depth_range": [depth_k.min().item(), depth_k.max().item()]}
        finite = bool(torch.isfinite(rgb_k).all() and torch.isfinite(depth_k).all())
    views = len(SRN_TARGETS) * SRN_OBJECTS
    res["seconds"] = seconds
    # each of the 2 batches pulls 2 objects of the train split; batch 1 also
    # runs the trainer's eval, its visual and a checkpoint
    res["train_seconds_per_batch"] = seconds["train"] / 2
    res["eval_ms_per_view"] = seconds["eval"] * 1e3 / views
    res["render_ms_per_view"] = seconds["render_kernels"] * 1e3 / len(SRN_TARGETS)
    res["launches"] = {k: sum(res[p]["launches"][k] for p in ("train", "eval", "eval_approx"))
                       for k in ("gather_bilerp", "gather_rows_lerp", "gather_rows_lerp_bwd")}
    # rgb = sum(w c) + (1 - sum(w)) over the fine pass's K samples is at
    # most 1 in exact arithmetic; float32 rounds each K-term sum by at most
    # (K - 1) 2^-24 and each of the two adds by 2^-24, so the render may
    # pass 1 by that much (the app clips before it writes)
    k = cfg.n_coarse + cfg.n_fine
    rgb_rounding = 2 * k * 2.0 ** -24
    res["kernel_vs_plain"]["rgb_rounding_allowance"] = rgb_rounding
    res["card"] = nvidia_smi_line()
    emit(res)
    if max(err.values()) != 0.0:
        raise AssertionError(f"srn_workflow: eval render through kernel A differs from plain: {err}")
    if not (finite and rgb_k.min() >= 0 and rgb_k.max() <= 1 + rgb_rounding):
        raise AssertionError(f"srn_workflow: render out of range: {res['kernel_vs_plain']}")
    return res


def make_request(path, net, cfg, enc):
    """The render of one image through ``path`` as ``render(rays (H, W, 8),
    generator=None, noise=None) -> (rgb (H, W, 3), depth (H, W))``:

    - "staged": ``FullRenderer(fast=True)`` on the plain encoding (kernel A,
      kernel B), or with ``use_kernels=False`` for "plain";
    - "baked": the same on a ``bake_encoding``'d ``enc``, which it renders
      unstaged (kernel A on the injection maps, kernel B with z_is_tz);
    - "fused": the unstaged renderer on ``query_fused`` of a
      ``pack_encoding``'d ``enc`` (kernel D).
    """
    from pixelnerf_tpu_torch.eval import FullRenderer
    from pixelnerf_tpu_torch.render import NeRFRenderer

    if path in ("staged", "baked", "plain"):
        fr = FullRenderer(net, cfg, ray_chunk=RAY_CHUNK, fast=True, use_kernels=path != "plain")
        return lambda rays, generator=None, noise=None: fr.render_image(enc, rays, generator, noise)
    if path != "fused":
        raise ValueError(f"unknown path {path!r}")
    renderer = NeRFRenderer(cfg)

    def query_fn(xyz, viewdirs, coarse):
        return net.query_fused(enc, xyz, viewdirs, coarse=coarse)

    def render(rays, generator=None, noise=None):
        h, w, _ = rays.shape
        out = renderer(query_fn, rays.reshape(1, h * w, 8), generator, noise,
                       use_viewdirs=net.use_viewdirs, ray_chunk=RAY_CHUNK)
        return out["fine"]["rgb"].reshape(h, w, 3), out["fine"]["depth"].reshape(h, w)

    return render


def run_requests(render, targets, dev, rgen):
    """One 128x128 request per target pose: (ms of each, host clock around
    work ending in a synchronize; the renders)."""
    from pixelnerf_tpu_torch.utils import geometry

    request_ms, renders = [], []
    with torch.inference_mode():
        for pose in targets:
            t1 = time.time()
            rays = geometry.gen_rays(pose[None], IMAGE, IMAGE, FOCAL, NEAR, FAR, device=dev)[0]
            rgb, depth = render(rays, generator=rgen)
            torch.cuda.synchronize()
            request_ms.append((time.time() - t1) * 1e3)
            renders.append((rgb, depth))
    return request_ms, renders


def check_renders(renders):
    for rgb, depth in renders:
        if not (torch.isfinite(rgb).all() and torch.isfinite(depth).all()):
            raise AssertionError("non-finite render")
        if rgb.shape != (IMAGE, IMAGE, 3) or depth.shape != (IMAGE, IMAGE):
            raise AssertionError(f"render shapes {tuple(rgb.shape)}, {tuple(depth.shape)}")
        # the white-background add may round past 1 by a float32 ulp
        if rgb.min() < 0 or rgb.max() > 1 + 1e-5:
            raise AssertionError(f"rgb outside [0, 1]: {rgb.min().item()}, {rgb.max().item()}")
        # compositing leaves 1 - sum(weights) of each ray on the background;
        # the opaque seeded field leaves < 0.1% there
        if depth.min() < NEAR * (1 - 1e-3) or depth.max() > FAR:
            raise AssertionError(f"depth outside [near, far]: {depth.min().item()}, {depth.max().item()}")
        if rgb.float().std() <= 1e-3:
            raise AssertionError("degenerate (constant) render")


def inference_kernels():
    """The launch counters of the inference kernels, by kernel name."""
    from pixelnerf_tpu_torch.ops.fused_field import fused_gather_resnetfc_infer
    from pixelnerf_tpu_torch.ops.fused_mlp import fused_resnetfc_infer
    from pixelnerf_tpu_torch.ops.gather import gather_bilerp

    return {"gather_bilerp": gather_bilerp, "fused_resnetfc_infer": fused_resnetfc_infer,
            "fused_gather_resnetfc_infer": fused_gather_resnetfc_infer}


def run_path(phase, render, targets, dev, rgen, per_request, extra):
    """Drive one inference path for one request per target, with every
    inference kernel's count set to 0 just before and read just after, and
    hold the counts to ``per_request`` launches per request and the
    renders to the render checks. Returns the phase's record."""
    kernels = inference_kernels()
    for fn in kernels.values():
        fn.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    request_ms, renders = run_requests(render, targets, dev, rgen)
    launches = {name: fn.launches for name, fn in kernels.items()}
    chunks = -(-IMAGE * IMAGE // RAY_CHUNK) * len(targets)
    expect = {name: per_request.get(name, 0) * chunks for name in kernels}
    if launches != expect:
        raise AssertionError(f"{phase}: launch counts {launches} != expected {expect}")
    check_renders(renders)
    steady = request_ms[1:]
    res = {
        "phase": phase, "config": "conf/exp/srn.conf, bf16, 128x128, 64+32 samples",
        "requests": len(targets), "ray_chunk": RAY_CHUNK, **extra,
        "request_ms": request_ms,
        "rays_per_s_steady": IMAGE * IMAGE * len(steady) / (sum(steady) / 1e3),
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": launches, "expected_launches": expect,
        "rgb_std": [r.float().std().item() for r, _ in renders],
        "depth_range": [min(d.min().item() for _, d in renders), max(d.max().item() for _, d in renders)],
    }
    emit(res)
    return res


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from pixelnerf_tpu_torch.models import bake_encoding, pack_encoding
    from pixelnerf_tpu_torch.ops import _build
    from pixelnerf_tpu_torch.render import draw_noise
    from pixelnerf_tpu_torch.utils import geometry

    t_start = time.time()
    dev = torch.device("cuda")
    smi = nvidia_smi_line()
    card = {"name": torch.cuda.get_device_name(0), "nvidia_smi": smi}
    emit({"phase": "device", **card, "torch": torch.__version__, "cuda": torch.version.cuda,
          "count": torch.cuda.device_count()})
    # state the float32 settings the plain versions run under
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.time()
    logs = _build.build(["gather", "fused_mlp", "gather_rows", "fused_field", "gather_study"])
    emit({"phase": "build", "seconds": time.time() - t0,
          "ptxas": {k: [l.strip() for l in v.splitlines() if "Used" in l or "spill" in l]
                    for k, v in logs.items()}})

    g = torch.Generator().manual_seed(0)
    net, cfg = make_srn_model(dev, g)

    with torch.inference_mode():
        res_a = check_kernel_a(dev, g)
        res_b = check_kernel_b(dev, g, net.mlp_fine)

    # the main path: encode one source view, answer three render requests
    images, src_pose = source_view(g, dev)
    targets = target_poses()
    rgen = torch.Generator(device=dev).manual_seed(1)
    torch.cuda.synchronize()
    t0 = time.time()
    with torch.inference_mode():
        enc = net.encode(images, src_pose, FOCAL)
    torch.cuda.synchronize()
    encode_ms = (time.time() - t0) * 1e3
    main_res = run_path("main_path", make_request("staged", net, cfg, enc), targets, dev, rgen,
                        {"gather_bilerp": 2, "fused_resnetfc_infer": 3}, {"encode_ms": encode_ms, "card": smi})
    launches = dict(main_res["launches"])

    # kernels vs their plain versions, end to end, on the same noise
    crop = geometry.gen_rays(targets[0][None], IMAGE, IMAGE, FOCAL, NEAR, FAR, device=dev)[0, 48:64]
    noise = [draw_noise(crop.reshape(1, -1, 8), cfg, torch.Generator(device=dev).manual_seed(2))]
    with torch.inference_mode():
        rgb_k, depth_k = make_request("staged", net, cfg, enc)(crop, noise=noise)
        rgb_p, depth_p = make_request("plain", net, cfg, enc)(crop, noise=noise)
    e2e = {"rgb": (rgb_k - rgb_p).abs().max().item(), "depth": (depth_k - depth_p).abs().max().item()}
    # the fused MLP's bf16 roundings may flip against the plain version's
    # (kernel B's tolerance); composited along 96 samples per ray
    e2e_tol = 2e-2
    emit({"phase": "kernel_vs_plain_e2e", "rays": crop.shape[0] * crop.shape[1], "max_abs_err": e2e,
          "tolerance": e2e_tol})
    if max(e2e.values()) > e2e_tol:
        raise AssertionError(f"kernel and plain renders disagree: {e2e}")

    # the training path's kernels at its own shapes
    inputs_c = kernel_c_inputs(dev, g)
    res_c = check_kernel_c(dev, inputs_c)
    res_c_bwd = check_kernel_c_bwd(dev, g, inputs_c)
    del inputs_c
    train_launches = {"gather_rows_lerp": 0, "gather_rows_lerp_bwd": 0}
    for res in [run_train(dev, key) for key in TRAIN_CONFIGS] + [run_train_app(dev)]:
        for k in train_launches:
            train_launches[k] += res["launches"][k]
    train_kernel_vs_plain(dev)

    # the SRN evaluation workflow: train, eval, resume, eval_approx
    srn = run_srn_workflow(dev)
    for k in train_launches:
        train_launches[k] += srn["launches"][k]

    # the fused and baked field paths: their kernels at the paths' shapes
    with torch.inference_mode():
        res_b_tz = check_kernel_b_tz(dev, g, net.mlp_fine)
        res_d = check_kernel_d(dev, g, net.mlp_fine)
        study = check_gather_study(dev)

    with torch.inference_mode():
        penc = pack_encoding(net, enc)
    fused_res = run_path("fused_path", make_request("fused", net, cfg, penc), targets, dev, rgen,
                         {"fused_gather_resnetfc_infer": 2}, {"card": smi})
    torch.cuda.synchronize()
    t0 = time.time()
    with torch.inference_mode():
        baked = bake_encoding(net, enc)
    torch.cuda.synchronize()
    bake_ms = (time.time() - t0) * 1e3
    baked_res = run_path("baked_path", make_request("baked", net, cfg, baked), targets, dev, rgen,
                         {"gather_bilerp": 2, "fused_resnetfc_infer": 2},
                         {"bake_encoding_ms": bake_ms, "tz_map_shape": list(baked.tz_coarse.shape), "card": smi})

    # the crop again: fused against staged and plain, baked against unbaked
    with torch.inference_mode():
        rgb_f, depth_f = make_request("fused", net, cfg, penc)(crop, noise=noise)
        rgb_b, depth_b = make_request("baked", net, cfg, baked)(crop, noise=noise)
    pairs = {"fused_vs_staged": ((rgb_f, depth_f), (rgb_k, depth_k)),
             "fused_vs_plain": ((rgb_f, depth_f), (rgb_p, depth_p)),
             "baked_vs_unbaked": ((rgb_b, depth_b), (rgb_k, depth_k))}
    errs = {name: {"rgb": (a[0] - b[0]).abs().max().item(), "depth": (a[1] - b[1]).abs().max().item()}
            for name, (a, b) in pairs.items()}
    # fused against staged: kernel D is bit-equal to B fed by A, and a
    # sample's value does not depend on its place in the batch, so only the
    # order of equal depths could differ; against plain, kernel B's
    # tolerance as above; baked against unbaked, the injections are rounded
    # to bf16 once more (~1 bf16 ulp of each), carried through the MLP and
    # composited along 96 samples
    tols = {"fused_vs_staged": 1e-5, "fused_vs_plain": e2e_tol, "baked_vs_unbaked": 3e-2}
    emit({"phase": "fused_vs_staged_e2e", "rays": crop.shape[0] * crop.shape[1], "max_abs_err": errs,
          "tolerance": tols})
    for name, err in errs.items():
        if max(err.values()) > tols[name]:
            raise AssertionError(f"{name}: renders disagree: {err} > {tols[name]}")

    keys = ("name", "route", "source", "replaces", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    # launches: A over the staged inference path and the SRN workflow, B
    # over the staged path, B's z_is_tz variant over the baked path, D over
    # the fused path, C and C-bwd over both training configs, the train app
    # and the SRN workflow, the study's formulations over its bench script
    launches["gather_bilerp"] += srn["launches"]["gather_bilerp"]
    launches.update(train_launches)
    launches["fused_resnetfc_infer[z_is_tz]"] = baked_res["launches"]["fused_resnetfc_infer"]
    launches["fused_gather_resnetfc_infer"] = fused_res["launches"]["fused_gather_resnetfc_infer"]
    ported = [{**{k: r[k] for k in keys}, "launches": launches[r["name"]]}
              for r in (res_a, res_b, res_b_tz, res_c, res_c_bwd, res_d)]
    ported += [{**{k: r[k] for k in keys}, "launches": r["launches"]} for r in study]
    if any(k["launches"] < 1 for k in ported):
        raise AssertionError(f"a kernel was not launched on its path: {ported}")
    emit({"kernels": ported, "card": smi, "seconds": time.time() - t_start})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
