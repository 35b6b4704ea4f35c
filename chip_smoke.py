#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one NVIDIA GPU and check them.

Its paths, at the full width and depth of the SRN model
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
  ``apps.eval_approx`` on an SRN-layout fixture;
- the apps that consume the SRN workflow's model, f32: ``apps.gen_video``,
  ``apps.eval_real``, ``apps.calc_metrics`` with LPIPS,
  ``apps.export_torch``, and the train app's ``--train_remat dots`` and
  ``--profile_dir``;
- the DTU workflow, f32, at three source views and 400x300
  (``conf/exp/dtu.conf``): ``apps.train -F dvr_dtu -V 3`` ->
  ``apps.eval -F dvr_dtu -P "22 25 28"`` on a DTU-layout fixture.

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
   (the backward also at the fine gather's and at a skewed input, and
   two of its launches held bit-equal, on bf16 and float32 tables)
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
20. dtu_workflow (run after 19): a DTU-layout fixture (3 scans x 49 views
    at 400x300, DTU-like cameras: fx, fy ~ 720, an off-centre principal
    point, P of two positive scales, a scale_mat), ``apps.train -F dvr_dtu -V
    3`` for 2 batches of 4 x 128 rays with colour jitter (C, C-bwd; its
    eval and 400x300 visual through A), ``apps.eval -P "22 25 28"`` of two
    target views (A), the eval render through A bit-equal to its plain
    version, ``finish.txt``'s PSNR against the written PNGs, C-bwd at the
    DTU train step's 360,000-row f32 table (against plain, two launches
    bit-equal), the NMR (``-F dvr``) and multi-object readers pulled on
    this host with no imaging library loaded; launch counts per view and
    per step, seconds per batch, ms per view, the DTU item's ms

21. apps_workflow (run after 19, on its fixture, checkpoint and eval
    output; SRN model, f32): ``apps.gen_video`` (8 frames of a spherical
    orbit, 4 of a spline; A), one video frame through A and through its
    plain version, bit for bit, the GIFs' structure and write time,
    ``apps.eval_real`` (a 128x128 and a 256x256 input, 4 views each; A),
    ``apps.calc_metrics --require_lpips`` (seeded VGG-LPIPS weights in the
    lpips package's format; the card's LPIPS held to the CPU module's
    within rtol 2e-4 with TF32 allowed in the process; LPIPS ms per
    128x128 and 400x300 pair), ``apps.export_torch`` (loaded strictly
    into a fresh model, bit-equal), train config (b) with ``remat="dots"``
    (C, C-bwd; its first loss held to the "features" run's), and
    ``apps.train --profile_dir`` for 2 steps (C, C-bwd; the trace names the
    port's kernels)

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
import tempfile
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


def c_bwd_deterministic(table, idx, w, grad_out):
    """Two C-bwd launches on one input: whether both outputs hold the same
    bits, and whether grad_table is its mirror's (each row's taps
    ascending, ``row_owner_bwd_plain``) bit for bit."""
    from pixelnerf_tpu_torch.ops.gather_rows import gather_rows_lerp_bwd, row_owner_bwd_plain

    sys.path.insert(0, os.path.join(REPO, "scripts"))
    from bench_gather_rows_bwd_torch import same_bits

    gt, gw = gather_rows_lerp_bwd(table, idx, w, grad_out)
    gt2, gw2 = gather_rows_lerp_bwd(table, idx, w, grad_out)
    mirror, _ = row_owner_bwd_plain(table, idx, w, grad_out, want_w=False)
    torch.cuda.synchronize()
    return {"two_launches_bit_equal": same_bits(gt, gt2) and same_bits(gw, gw2),
            "grad_table_bit_equal_to_mirror": same_bits(gt, mirror)}


def c_bwd_against_plain(table, idx, w, grad_out):
    """C-bwd on one input against its plain version, timed, and two of its
    launches against each other; raises if they disagree."""
    from pixelnerf_tpu_torch.ops.gather_rows import gather_rows_lerp_bwd, gather_rows_lerp_bwd_plain

    n, c = idx.shape[0], table.shape[1]
    gt, gw = gather_rows_lerp_bwd(table, idx, w, grad_out)
    torch.cuda.synchronize()
    rt, rw = gather_rows_lerp_bwd_plain(table, idx, w, grad_out)
    err_t = (gt.float() - rt.float()).abs().max().item()
    err_w = (gw - rw).abs().max().item()
    # float32 sums in another order (each row's taps ascending, against
    # index_add_'s order; a warp's shuffle tree): a few float32 ulps of the
    # largest entry, plus one bf16 rounding of the table gradient that may
    # fall the other way (2^-8 of the entry)
    tol_t = 8e-3 * rt.float().abs().max().item()
    tol_w = 1e-5 * rw.abs().max().item()
    if not (err_t <= tol_t and err_w <= tol_w):
        raise AssertionError(f"kernel C-bwd disagrees with its plain version: {err_t} > {tol_t} or {err_w} > {tol_w}")
    det = c_bwd_deterministic(table, idx, w, grad_out)
    if not all(det.values()):
        raise AssertionError(f"kernel C-bwd is not deterministic: {det}")
    # bytes: grad_out, idx, w and the table rows a tap reads read once;
    # grad_table and grad_w written once
    row_bytes = c * table.element_size()
    bytes_moved = (grad_out.numel() * grad_out.element_size() + torch.unique(idx).numel() * row_bytes
                   + n * 32 + table.shape[0] * row_bytes + n * 16)
    bound_ms, bound_by = bound(bytes_moved, 16 * n * c, PEAK_F32_FLOPS)
    return {
        "points": n, "table": list(table.shape), "table_dtype": str(table.dtype).replace("torch.", ""),
        "max_abs_err": max(err_t, err_w), "max_abs_err_by_output": {"grad_table": err_t, "grad_w": err_w},
        "tolerance": {"grad_table": tol_t, "grad_w": tol_w}, **det,
        "ms": time_ms(lambda: gather_rows_lerp_bwd(table, idx, w, grad_out), reps=20),
        "plain_ms": time_ms(lambda: gather_rows_lerp_bwd_plain(table, idx, w, grad_out), reps=5),
        "bound_ms": bound_ms, "bound_by": bound_by,
    }


def check_kernel_c_bwd(dev, g, inputs):
    """C-bwd at the coarse gather's shape (the kernels line's numbers), the
    fine gather's 32,768 points and a skewed input (a quarter of the points
    in one cell; ``scripts/bench_gather_rows_bwd_torch.py`` makes both),
    each against its plain version and two launches against each other,
    also on a float32 copy of each table (bit-equal launches, grad_table
    bit-equal to its mirror); the library call at the coarse shape."""
    import torch.nn.functional as F

    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import bench_gather_rows_bwd_torch as bench

    table, idx, w, fmap, grid = inputs
    n, c = idx.shape[0], table.shape[1]
    grad_out = torch.randn((n, c), generator=g).to(torch.bfloat16).to(dev)
    by_input = {"uniform": c_bwd_against_plain(table, idx, w, grad_out)}
    f32 = {"uniform": c_bwd_deterministic(table.float(), idx, w, grad_out)}
    g_more = torch.Generator().manual_seed(6)
    for kind in ("fine", "skewed"):
        t_k, i_k, w_k, go_k = bench.make_inputs(dev, g_more, kind)
        by_input[kind] = c_bwd_against_plain(t_k, i_k, w_k, go_k)
        f32[kind] = c_bwd_deterministic(t_k.float(), i_k, w_k, go_k)
    if not all(v for d in f32.values() for v in d.values()):
        raise AssertionError(f"kernel C-bwd on float32 tables is not deterministic: {f32}")
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
        "inputs": by_input, "float32_tables": f32,
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


def run_train(dev, key, remat=None):
    """Train config ``key`` on the card (with ``remat`` in place of its
    policy where given; the same weights, batches and draws): per-step host
    time around work ending in a synchronize, the loss and gradient norm of
    every step, peak memory, and the launch counts of C and C-bwd (reset
    just before the steps, read just after)."""
    from pixelnerf_tpu_torch.ops.fused_mlp import fused_resnetfc_infer
    from pixelnerf_tpu_torch.ops.gather import gather_bilerp
    from pixelnerf_tpu_torch.ops.gather_rows import gather_rows_lerp, gather_rows_lerp_bwd
    from pixelnerf_tpu_torch.train import make_render_loss, make_train_step

    tc = TRAIN_CONFIGS[key] if remat is None else {**TRAIN_CONFIGS[key], "remat": remat}
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
    # so no gather runs again, while "dots" recomputes all but the matrix
    # products, the gathers too. No inference kernel runs.
    per_step = train_launches_per_step()[key]
    fwd_per_step = per_step * (2 if tc["ray_chunk"] and tc["remat"] in (True, "dots") else 1)
    expect = {"gather_rows_lerp": fwd_per_step * tc["steps"], "gather_rows_lerp_bwd": per_step * tc["steps"],
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
        "launches": launches, "launches_per_step": {"gather_rows_lerp": fwd_per_step, "gather_rows_lerp_bwd": per_step},
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


def run_srn_workflow(dev, tmp):
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
    values and rgb in [0, 1] are checked. Everything is written under
    ``tmp``, where ``run_apps_workflow`` finds the fixture, the checkpoint
    and the eval output."""
    import contextlib
    import io

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


# the apps a user runs once a model is trained, on srn_workflow's fixture,
# checkpoint and eval output: frames per video trajectory, views per
# real-image input, and the seed of the LPIPS weights
VIDEO_FRAMES = {"spherical": 8, "spline": 4}
REAL_VIEWS = 4
LPIPS_SEED = 11


def lpips_state_dict(seed):
    """Seeded VGG-LPIPS weights in the lpips package's state_dict format
    (``net.slice<k>.<idx>.*``, ``lin<k>.model.1.weight``, the scaling
    layer's constants)."""
    import numpy as np

    from pixelnerf_tpu_torch.utils.lpips import _SCALE, _SHIFT, _VGG_PLAN, _VGG_WIDTHS

    rng = np.random.default_rng(seed)
    sd, c_in = {}, 3
    for gi, (group, width) in enumerate(zip(_VGG_PLAN, _VGG_WIDTHS)):
        for idx in group:
            sd[f"net.slice{gi + 1}.{idx}.weight"] = torch.from_numpy(
                rng.normal(0, 0.05, (width, c_in, 3, 3)).astype(np.float32))
            sd[f"net.slice{gi + 1}.{idx}.bias"] = torch.from_numpy(rng.normal(0, 0.01, (width,)).astype(np.float32))
            c_in = width
        sd[f"lin{gi}.model.1.weight"] = torch.from_numpy(
            np.abs(rng.normal(0, 0.05, (1, width, 1, 1))).astype(np.float32))
    sd["scaling_layer.shift"] = torch.from_numpy(_SHIFT.reshape(1, 3, 1, 1))
    sd["scaling_layer.scale"] = torch.from_numpy(_SCALE.reshape(1, 3, 1, 1))
    return sd


def gif_image_count(path):
    """The image descriptors of the GIF at ``path``, walking its blocks:
    the GIF89a header and logical screen (and its colour table), then
    extensions and images (each ending in a run of sub-blocks), and the
    trailer as the file's last byte. Raises where the structure breaks."""
    with open(path, "rb") as f:
        b = f.read()
    if b[:6] != b"GIF89a":
        raise AssertionError(f"{path}: header {b[:6]!r}")

    def table(pos, flags):
        return pos + (3 * 2 ** ((flags & 7) + 1) if flags & 0x80 else 0)

    def sub_blocks(pos):
        while b[pos]:
            pos += b[pos] + 1
        return pos + 1

    pos, images = table(13, b[10]), 0
    while b[pos] != 0x3B:
        if b[pos] == 0x21:                        # extension: label, sub-blocks
            pos = sub_blocks(pos + 2)
        elif b[pos] == 0x2C:                      # image: descriptor, table, LZW size, sub-blocks
            pos = sub_blocks(table(pos + 10, b[pos + 9]) + 1)
            images += 1
        else:
            raise AssertionError(f"{path}: block {b[pos]:#x} at byte {pos}")
    if pos != len(b) - 1:
        raise AssertionError(f"{path}: {len(b) - 1 - pos} bytes after the trailer")
    return images


def run_apps_workflow(dev, tmp, train_features):
    """The apps that consume a trained model, on the card, on
    ``srn_workflow``'s fixture, checkpoint and ``apps.eval`` output in
    ``tmp`` (the SRN model at full width, f32): ``apps.gen_video`` (a
    spherical orbit and a spline, kernel A; one frame also through A's
    plain version, bit for bit; the GIF's structure and write time),
    ``apps.eval_real`` (a 128x128 and a 256x256 input, the latter area
    resized), ``apps.calc_metrics --require_lpips`` over the eval output
    (LPIPS on the card held to the same module on the CPU, with TF32
    allowed in the process as it is by default), ``apps.export_torch`` (the
    export loaded strictly into a fresh model, every tensor bit-equal),
    train config (b) with ``remat="dots"`` beside ``train_features``, and
    ``apps.train --profile_dir`` (the trace names the port's kernels)."""
    import contextlib
    import io
    import json

    import numpy as np

    from pixelnerf_tpu_torch.apps import calc_metrics, eval_real, export_torch, gen_video
    from pixelnerf_tpu_torch.apps import eval as eval_app
    from pixelnerf_tpu_torch.apps import train as train_app
    from pixelnerf_tpu_torch.apps.args import parse_args
    from pixelnerf_tpu_torch.config import load_config
    from pixelnerf_tpu_torch.data import get_split_dataset
    from pixelnerf_tpu_torch.eval import FullRenderer
    from pixelnerf_tpu_torch.models import load_reference_state_dict, make_model
    from pixelnerf_tpu_torch.train import load_variables
    from pixelnerf_tpu_torch.utils import geometry, gif, png
    from pixelnerf_tpu_torch.utils.lpips import LPIPS

    conf = os.path.join(REPO, "conf", "exp", "srn.conf")
    data = os.path.join(tmp, "data", "cars")
    ck = os.path.join(tmp, "ck")
    common = ["-c", conf, "--device", str(dev), "--checkpoints_path", ck]
    none = {"gather_rows_lerp": 0, "gather_rows_lerp_bwd": 0, "gather_bilerp": 0, "fused_resnetfc_infer": 0,
            "fused_gather_resnetfc_infer": 0}
    res = {"phase": "apps_workflow", "model": "conf/exp/srn.conf, float32", "image": IMAGE}
    launches = {"gather_bilerp": 0, "gather_rows_lerp": 0, "gather_rows_lerp_bwd": 0}

    # 1. gen_video: 8 frames of a spherical orbit, 4 of a spline through
    # the object's poses, from source view 64 (one 16,384-ray chunk a frame)
    video = {}
    for traj, n in VIDEO_FRAMES.items():
        out = os.path.join(tmp, f"video_{traj}")
        argv = common + ["-F", "srn", "-D", data, "-P", str(SRN_SOURCE), "--num_views", str(n), "--traj", traj,
                         "-O", out]
        frames, lines, seconds, got = run_app(gen_video, argv)
        chunk = int(parse_args(gen_video.extra_args, argv=argv)[0].ray_batch_size)
        expect = {**none, "gather_bilerp": 2 * n * -(-IMAGE * IMAGE // chunk)}
        files = sorted(os.listdir(out))
        path = os.path.join(out, "example_obj0.gif")
        images = gif_image_count(path)
        video[traj] = {"frames": len(frames), "seconds": seconds, "ms_per_frame_app": seconds * 1e3 / n,
                       "colours_per_frame": [len(np.unique(f.reshape(-1, 3), axis=0)) for f in frames],
                       "files": files, "gif_bytes": os.path.getsize(path), "gif_images": images,
                       "printed": [l for l in lines if l.startswith("mp4")], "launches": got,
                       "expected_launches": expect}
        if got != expect:
            raise AssertionError(f"apps_workflow gen_video {traj}: launch counts {got} != expected {expect}")
        if files != ["example_obj0.gif", "example_obj0_src.png"] or images != n or len(frames) != n:
            raise AssertionError(f"apps_workflow gen_video {traj}: {video[traj]}")
        if not all(f.shape == (IMAGE, IMAGE, 3) and f.dtype == np.uint8 and f.std() > 0 for f in frames):
            raise AssertionError(f"apps_workflow gen_video {traj}: degenerate frames")
        launches["gather_bilerp"] += got["gather_bilerp"]
        if traj == "spherical":
            t0 = time.perf_counter()
            gif.mimwrite(os.path.join(tmp, "again.gif"), frames, duration=1000 / 30)
            video[traj]["gif_write_ms"] = (time.perf_counter() - t0) * 1e3
            video[traj]["gif_write_ms_per_frame"] = video[traj]["gif_write_ms"] / n
            if open(os.path.join(tmp, "again.gif"), "rb").read() != open(path, "rb").read():
                raise AssertionError("apps_workflow: the GIF writer is not deterministic")
    res["gen_video"] = video

    # 2. the first spherical frame through kernel A and through its plain
    # version, the same checkpoint, pose and draws: bit for bit
    argv = common + ["-F", "srn", "-D", data, "-P", str(SRN_SOURCE)]
    args, cfg_tree = parse_args(gen_video.extra_args, argv=argv)
    with contextlib.redirect_stdout(io.StringIO()):
        net = eval_app.load_net_and_state(args, cfg_tree, dev)
    test_set = get_split_dataset("srn", data, "test", image_size=(IMAGE, IMAGE))
    cfg = gen_video.video_render_config(cfg_tree, test_set)
    d = test_set[0]
    radius = float(np.linalg.norm(d["poses"][:, :3, 3], axis=-1).mean())
    pose = gen_video.spherical_trajectory(VIDEO_FRAMES["spherical"], args.elevation, radius)[:1]
    with torch.inference_mode():
        enc = net.encode(torch.from_numpy(d["images"][None, [SRN_SOURCE]]).to(dev),
                         torch.from_numpy(d["poses"][None, [SRN_SOURCE]]).to(dev), torch.as_tensor(d["focal"]),
                         c=torch.from_numpy(d["c"][None]))
    rays = geometry.gen_rays(pose, IMAGE, IMAGE, d["focal"], test_set.z_near, test_set.z_far, c=d["c"], device=dev)[0]
    frame, frame_ms = {}, {}
    for use_kernels in (True, False, True):
        renderer = FullRenderer(net, cfg, ray_chunk=args.ray_batch_size, use_kernels=use_kernels)
        torch.cuda.synchronize()
        t0 = time.time()
        frame[use_kernels], _ = renderer.render_image(enc, rays, torch.Generator(device=dev).manual_seed(9))
        torch.cuda.synchronize()
        frame_ms[use_kernels] = (time.time() - t0) * 1e3
    err = (frame[True] - frame[False]).abs().max().item()
    res["frame_kernel_vs_plain"] = {"max_abs_err": err, "tolerance": 0.0, "samples": [cfg.n_coarse, cfg.n_fine],
                                    "frame_ms_kernels": frame_ms[True], "frame_ms_plain": frame_ms[False]}
    if err != 0.0 or not torch.isfinite(frame[True]).all():
        raise AssertionError(f"apps_workflow: the gen_video frame through kernel A differs from plain: {err}")

    # 3. eval_real: a 128x128 input and a 256x256 one (the factor-2 area resize)
    real = os.path.join(tmp, "real")
    os.makedirs(real)
    view = png.imread(os.path.join(data + "_test", "test_00", "rgb", f"{SRN_SOURCE:06d}.png"))
    png.imwrite(os.path.join(real, "a_normalize.png"), view)
    noise = np.random.default_rng(5).integers(-12, 13, (2 * IMAGE, 2 * IMAGE, 3))
    png.imwrite(os.path.join(real, "b_normalize.png"),
                np.clip(np.repeat(np.repeat(view, 2, 0), 2, 1) + noise, 0, 255).astype(np.uint8))
    out = os.path.join(tmp, "real_out")
    argv = common + ["--input", real, "--size", str(IMAGE), "--num_views", str(REAL_VIEWS), "-O", out]
    _, lines, seconds, got = run_app(eval_real, argv)
    chunk = int(parse_args(eval_real.extra_args, argv=argv)[0].ray_batch_size)
    expect = {**none, "gather_bilerp": 2 * 2 * REAL_VIEWS * -(-IMAGE * IMAGE // chunk)}
    files = sorted(os.listdir(out))
    counts = {b: (len(os.listdir(os.path.join(out, f"{b}_frames"))), gif_image_count(os.path.join(out, f"{b}.gif")))
              for b in ("a_normalize", "b_normalize")}
    frames = [png.imread(os.path.join(out, "b_normalize_frames", f"{i:04}.png")) for i in range(REAL_VIEWS)]
    res["eval_real"] = {"seconds": seconds, "ms_per_view_app": seconds * 1e3 / (2 * REAL_VIEWS), "files": files,
                        "frames_and_gif_images": counts, "launches": got, "expected_launches": expect}
    if got != expect:
        raise AssertionError(f"apps_workflow eval_real: launch counts {got} != expected {expect}")
    if (files != ["a_normalize.gif", "a_normalize_frames", "b_normalize.gif", "b_normalize_frames"]
            or any(c != (REAL_VIEWS, REAL_VIEWS) for c in counts.values())
            or not all(f.shape == (IMAGE, IMAGE, 3) and f.std() > 0 for f in frames)):
        raise AssertionError(f"apps_workflow eval_real: {res['eval_real']}")
    launches["gather_bilerp"] += got["gather_bilerp"]

    # 4. calc_metrics with LPIPS over srn_workflow's eval output, TF32
    # allowed as a process allows it by default; then the same LPIPS module
    # on the CPU over the same images
    weights = os.path.join(tmp, "lpips_vgg.pth")
    torch.save(lpips_state_dict(LPIPS_SEED), weights)
    eval_out = os.path.join(tmp, "eval_out")
    argv = ["-D", data + "_test", "-F", "srn", "-O", eval_out, "--lpips_weights", weights, "--require_lpips",
            "--device", str(dev)]
    torch.backends.cudnn.allow_tf32 = True
    try:
        _, lines, seconds, got = run_app(calc_metrics, argv)
    finally:
        torch.backends.cudnn.allow_tf32 = False
    cpu_lpips = LPIPS.from_torch_file(weights)
    per_object = {}
    for obj in sorted(os.listdir(eval_out)):
        if not os.path.isdir(os.path.join(eval_out, obj)):
            continue
        written = dict(l.split() for l in open(os.path.join(eval_out, obj, "metrics.txt")).read().splitlines())
        gts = np.stack([png.imread(os.path.join(data + "_test", obj, "rgb", f"{v:06d}.png")).astype(np.float32)
                        [..., :3] / 255.0 * 2.0 - 1.0 for v in SRN_TARGETS])
        preds = np.stack([png.imread(os.path.join(eval_out, obj, f"{v:06d}.png")).astype(np.float32)[..., :3]
                          / 255.0 * 2.0 - 1.0 for v in SRN_TARGETS])
        cpu = float(cpu_lpips(torch.from_numpy(preds), torch.from_numpy(gts)).mean())
        per_object[obj] = {"psnr": float(written["psnr"]), "ssim": float(written["ssim"]),
                           "lpips_card": float(written["lpips"]), "lpips_cpu": cpu,
                           "rel_err": abs(float(written["lpips"]) - cpu) / abs(cpu)}
    total = open(os.path.join(eval_out, "all_metrics.txt")).read().splitlines()[-1]
    lp = LPIPS.from_torch_file(weights).to(dev)
    rng = torch.Generator().manual_seed(6)
    timing = {}
    for name, (h, w, n) in {"128x128": (IMAGE, IMAGE, 16), "400x300": (300, 400, 4)}.items():
        a, b = (torch.rand((n, h, w, 3), generator=rng).mul(2).sub(1).to(dev) for _ in range(2))
        timing[f"lpips_ms_per_pair_{name}"] = time_ms(lambda: lp(a, b), reps=5) / n
    res["calc_metrics"] = {"seconds": seconds, "objects": per_object, "all_metrics_total": total,
                           "tolerance_rel": 2e-4, "launches": got, **timing}
    print(total, flush=True)
    if len(per_object) != SRN_OBJECTS or not total.startswith(" psnr:") or "lpips:" not in total:
        raise AssertionError(f"apps_workflow calc_metrics: {res['calc_metrics']}")
    if not all(math.isfinite(o["lpips_card"]) and o["lpips_card"] > 0 and o["rel_err"] <= 2e-4
               for o in per_object.values()):
        raise AssertionError(f"apps_workflow calc_metrics: LPIPS on the card differs from the CPU's: {per_object}")
    if any(got.values()):
        raise AssertionError(f"apps_workflow calc_metrics: a kernel ran: {got}")

    # 5. export_torch of the train app's checkpoint, loaded strictly into a
    # fresh model: every tensor bit-equal to the checkpoint's
    exported = os.path.join(tmp, "export", "pixel_nerf_latest")
    os.makedirs(os.path.dirname(exported))
    _, lines, seconds, _ = run_app(export_torch, ["-n", "example", "--checkpoints_path", ck, "--out", exported])
    saved = load_variables(os.path.join(ck, "example"), dev)["model"]
    fresh = make_model(load_config(conf)["model"], device=dev, generator=torch.Generator().manual_seed(123))
    skipped = load_reference_state_dict(fresh, torch.load(exported, map_location=dev, weights_only=True))
    own = fresh.state_dict()
    unequal = [k for k, v in saved.items() if not k.endswith("num_batches_tracked") and not torch.equal(own[k], v)]
    res["export_torch"] = {"seconds": seconds, "printed": lines[-1:], "tensors": len(torch.load(exported)),
                           "skipped": skipped, "unequal": unequal}
    if skipped or unequal or not lines[-1].startswith("Exported step-2 weights"):
        raise AssertionError(f"apps_workflow export_torch: {res['export_torch']}")

    # 6. train config (b) with remat="dots", the features run's weights,
    # batches and draws
    dots = run_train(dev, "b", remat="dots")
    rel = abs(dots["loss"][0] - train_features["loss"][0]) / abs(train_features["loss"][0])
    res["train_b_dots"] = {
        "step_ms": [s * 1e3 for s in dots["step_s"]], "features_step_ms": [s * 1e3 for s in train_features["step_s"]],
        "peak_memory_gb": dots["peak_memory_gb"], "features_peak_memory_gb": train_features["peak_memory_gb"],
        "launches_per_step": dots["launches_per_step"], "features_launches_per_step": train_features["launches_per_step"],
        "first_loss": dots["loss"][0], "features_first_loss": train_features["loss"][0], "first_loss_rel_err": rel,
        "tolerance_rel": 1e-6}
    if rel > 1e-6:
        raise AssertionError(f"apps_workflow: the dots step's first loss differs from features': {res['train_b_dots']}")
    for k in ("gather_rows_lerp", "gather_rows_lerp_bwd"):
        launches[k] += dots["launches"][k]

    # 7. apps.train --profile_dir for 2 steps: a trace that names the port's kernels
    prof = os.path.join(tmp, "profile")
    argv = common + ["-n", "profiled", "-F", "srn", "-D", data, "-B", "2", "--epochs", "1", "--epoch_batches", "2",
                     "--workers", "1", "--logs_path", os.path.join(tmp, "logs"),
                     "--visual_path", os.path.join(tmp, "vis"), "--profile_dir", prof]
    trainer, lines, seconds, got = run_app(train_app, argv)
    traces = sorted(os.listdir(prof))
    events = json.load(open(os.path.join(prof, traces[0])))["traceEvents"] if len(traces) == 1 else []
    kernels = sorted({e["name"] for e in events if e.get("cat") == "kernel"})
    ours = [k for k in kernels if any(s in k for s in ("gather_rows_kernel", "gather_rows_bwd", "gather_bilerp"))]
    res["profile"] = {"seconds": seconds, "steps": trainer.step, "files": traces,
                      "trace_mb": sum(os.path.getsize(os.path.join(prof, f)) for f in traces) / 1e6,
                      "kernel_names": len(kernels), "port_kernels": ours, "launches": got}
    if trainer.step != 2 or len(traces) != 1 or not ours:
        raise AssertionError(f"apps_workflow profile: {res['profile']}")
    for k in launches:
        launches[k] += got[k]
    res["launches"] = launches
    res["card"] = nvidia_smi_line()
    emit(res)
    return res


# the DTU workflow (conf/exp/dtu.conf: the SRN model's widths, 64 + 32
# samples, no white background, near 0.1, far 5.0): DTU's 49 views of
# 400x300 RGB per scan, its three source views, two target views
DTU_SPLITS = {"train": ("scan1", "scan2"), "val": ("scan3",), "test": ("scan3",)}
DTU_VIEWS, DTU_H, DTU_W = 49, 300, 400
DTU_SOURCE = "22 25 28"
DTU_TARGETS = (10, 40)
DTU_TRAIN_SB, DTU_TRAIN_RAYS = 4, 128
# rays per chunk of the eval render: 10,000 rays x 96 fine samples x 3
# views keep each f32 activation of the MLP chain near 6 GB
DTU_RAY_CHUNK = 10000
NMR_VIEWS, NMR_SIZE = 24, 64
MULTI_FRAMES, MULTI_SIZE = 8, 128


def _orbit_pose(i, n, radius, height):
    """Camera-to-world pose of camera i of n on an arc about the object."""
    from pixelnerf_tpu_torch.utils import geometry

    a = 2.2 * i / max(n - 1, 1) - 1.1
    return geometry.look_at([radius * math.sin(a), height, radius * math.cos(a)], [0.0, 0.0, 0.0])


def _smooth_image(rng, h, w, channels, v):
    """A uint8 image of smooth colour fields that change with the view,
    plus a little noise."""
    import numpy as np

    yy, xx = np.mgrid[:h, :w].astype(np.float32)
    fields = [np.sin(xx / (23 + 5 * k) + 0.3 * v + k) * np.cos(yy / (17 + 3 * k) - 0.2 * v) for k in range(channels)]
    img = 127.5 + 100 * np.stack(fields, -1) + rng.uniform(-8, 8, (h, w, channels))
    return np.clip(img, 0, 255).astype(np.uint8)


def write_dtu_fixture(root):
    """A DTU-layout dataset (``-D`` is ``root``): ``DTU/scan{1,2,3}/image/
    0000NN.png`` (DTU_VIEWS views of DTU_W x DTU_H RGB, written by the
    port's PNG writer with the five row filters in turn), ``cameras.npz``
    with ``world_mat_i = s K [R | t]`` (DTU-like intrinsics: fx, fy ~ 720,
    the principal point off the centre; s > 0 of two sizes) and the
    ``scale_mat_i`` that normalises the object, and ``new_{train,val,
    test}.lst``."""
    import numpy as np

    from pixelnerf_tpu_torch.utils import png

    rng = np.random.default_rng(8)
    flip = np.diag([1.0, -1.0, -1.0, 1.0])
    scale, trans = 210.0, np.array([12.0, -25.0, 610.0])
    cat = os.path.join(root, "DTU")
    for scan in sorted({s for objs in DTU_SPLITS.values() for s in objs}):
        os.makedirs(os.path.join(cat, scan, "image"))
        cams = {}
        for v in range(DTU_VIEWS):
            png.imwrite(os.path.join(cat, scan, "image", f"{v:06d}.png"),
                        _smooth_image(rng, DTU_H, DTU_W, 3, v), filters=np.arange(DTU_H) % 5)
            K = np.array([[720.0 + rng.uniform(-4, 4), 0.0, DTU_W / 2 + 12 + rng.uniform(-1, 1)],
                          [0.0, 718.0 + rng.uniform(-4, 4), DTU_H / 2 - 9 + rng.uniform(-1, 1)], [0.0, 0.0, 1.0]])
            # OpenCV's camera (y down, z forward) in the unnormalised world
            pose_cv = flip @ _orbit_pose(v, DTU_VIEWS, 2.4, 0.8) @ flip
            centre = scale * pose_cv[:3, 3] + trans
            r_w2c = pose_cv[:3, :3].T
            P = (0.7 if v % 2 else 1.3) * K @ np.concatenate([r_w2c, (-r_w2c @ centre)[:, None]], 1)
            scale_mat = np.eye(4)
            scale_mat[:3, :3] *= scale
            scale_mat[:3, 3] = trans
            cams[f"world_mat_{v}"] = np.vstack([P, [0.0, 0.0, 0.0, 1.0]]).astype(np.float32)
            cams[f"scale_mat_{v}"] = scale_mat.astype(np.float32)
        np.savez(os.path.join(cat, scan, "cameras.npz"), **cams)
    for split, objs in DTU_SPLITS.items():
        with open(os.path.join(cat, f"new_{split}.lst"), "w") as f:
            f.write("\n".join(objs) + "\n")
    return root


def write_nmr_and_multi_obj_fixtures(root):
    """One NMR-layout object (``-F dvr``: NMR_VIEWS views of NMR_SIZE^2 RGB
    with masks, ``world_mat``/``camera_mat`` cameras, ``softras_train.lst``)
    and one multi-object scene (``-F multi_obj``: MULTI_FRAMES RGBA frames
    of MULTI_SIZE^2, ``transforms.json``), written by the port's PNG writer.
    Returns their ``-D`` paths."""
    import json

    import numpy as np

    from pixelnerf_tpu_torch.utils import png

    rng = np.random.default_rng(9)
    world = np.array([[1, 0, 0, 0], [0, 0, -1, 0], [0, 1, 0, 0], [0, 0, 0, 1]], np.float64)
    cam = np.diag([1.0, -1.0, -1.0, 1.0])
    nmr = os.path.join(root, "nmr")
    obj = os.path.join(nmr, "02958343", "obj0")
    os.makedirs(os.path.join(obj, "image"))
    os.makedirs(os.path.join(obj, "mask"))
    cams = {}
    yy, xx = np.mgrid[:NMR_SIZE, :NMR_SIZE]
    for v in range(NMR_VIEWS):
        png.imwrite(os.path.join(obj, "image", f"{v:04d}.png"), _smooth_image(rng, NMR_SIZE, NMR_SIZE, 3, v),
                    filters=np.arange(NMR_SIZE) % 5)
        disc = (xx - 32 - v % 5) ** 2 + (yy - 30) ** 2 < 18 ** 2
        png.imwrite(os.path.join(obj, "mask", f"{v:04d}.png"), disc.astype(np.uint8) * 255)
        c2w = _orbit_pose(v, NMR_VIEWS, 2.7, 0.9)
        cams[f"world_mat_{v}"] = np.linalg.inv(np.linalg.inv(world) @ c2w @ np.linalg.inv(cam)).astype(np.float32)
        cams[f"camera_mat_{v}"] = np.diag([1.75, 1.75, 1.0, 1.0]).astype(np.float32)
    np.savez(os.path.join(obj, "cameras.npz"), **cams)
    with open(os.path.join(nmr, "02958343", "softras_train.lst"), "w") as f:
        f.write("obj0\n")
    multi = os.path.join(root, "multi")
    scene = os.path.join(multi, "train", "00000")
    os.makedirs(scene)
    frames = []
    for k in range(MULTI_FRAMES):
        rgba = _smooth_image(rng, MULTI_SIZE, MULTI_SIZE, 4, k)
        rgba[..., 3] = np.where(rgba[..., 3] > 127, 255, 0)
        png.imwrite(os.path.join(scene, f"r_{k}_obj.png"), rgba, filters=np.arange(MULTI_SIZE) % 5)
        frames.append({"file_path": f"./r_{k}", "transform_matrix": _orbit_pose(k, MULTI_FRAMES, 7.0, 2.0).tolist()})
    with open(os.path.join(scene, "transforms.json"), "w") as f:
        json.dump({"camera_angle_x": 0.6911, "frames": frames}, f)
    return nmr, multi


def pull_dvr_and_multi_obj(root):
    """Pull the NMR and multi-object fixtures' items on this host through
    ``get_split_dataset`` (``-F dvr``, ``-F multi_obj``): shapes, finite
    values, host ms; and that no imaging library was loaded."""
    import numpy as np

    from pixelnerf_tpu_torch.data import get_split_dataset

    nmr, multi = write_nmr_and_multi_obj_fixtures(root)
    res = {}
    for fmt, path, shape in (("dvr", nmr, (NMR_VIEWS, NMR_SIZE, NMR_SIZE, 3)),
                             ("multi_obj", multi, (MULTI_FRAMES, MULTI_SIZE, MULTI_SIZE, 3))):
        dset = get_split_dataset(fmt, path, "train")
        t0 = time.perf_counter()
        d = dset[0]
        ms = (time.perf_counter() - t0) * 1e3
        ok = (d["images"].shape == shape and d["masks"].shape == shape[:3] + (1,) and d["bbox"].shape == (shape[0], 4)
              and all(np.isfinite(d[k]).all() for k in ("images", "masks", "bbox", "poses", "focal")))
        res[fmt] = {"type": type(dset).__name__, "images": list(d["images"].shape), "item_ms": ms,
                    "focal": float(d["focal"]), "masks_mean": float(d["masks"].mean())}
        if not ok or not 0.0 < d["masks"].mean() < 1.0:
            raise AssertionError(f"dtu_workflow: the {fmt} reader's item is wrong: {res[fmt]}")
    loaded = sorted(m for m in ("cv2", "imageio", "PIL") if m in sys.modules)
    res["imaging_libraries_loaded"] = loaded
    if loaded:
        raise AssertionError(f"dtu_workflow: a reader loaded {loaded}")
    return res


def run_dtu_workflow(dev):
    """The user's DTU workflow on the card, on a DTU-layout fixture at
    400x300 with three source views (NS = 3), f32 as the JAX apps run:
    ``apps.train -F dvr_dtu -V 3`` for 2 steps of 4 x 128 rays with colour
    jitter (kernels C and C-bwd; its eval and visual through kernel A),
    ``apps.eval -F dvr_dtu -P "22 25 28"`` of two target views of the test
    scan (kernel A), its eval render through kernel A held bit for bit to
    the same render through the plain gather, ``finish.txt``'s PSNR held to
    the written images; C-bwd at the DTU train step's table (360,000 f32
    rows), against its plain version and two launches bit-equal; the NMR
    and multi-object readers pulled on this host. Each app's kernel counts
    are set to 0 just before it and read just after."""
    import contextlib
    import io
    import tempfile

    import numpy as np

    from pixelnerf_tpu_torch.apps import eval as eval_app
    from pixelnerf_tpu_torch.apps import train as train_app
    from pixelnerf_tpu_torch.apps.args import parse_args
    from pixelnerf_tpu_torch.data import get_split_dataset
    from pixelnerf_tpu_torch.eval import FullRenderer
    from pixelnerf_tpu_torch.utils import png

    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import bench_gather_rows_bwd_torch as bench

    os.environ["PIXELNERF_NO_TB"] = "1"
    conf = os.path.join(REPO, "conf", "exp", "dtu.conf")
    seconds = {}
    res = {"phase": "dtu_workflow", "config": "conf/exp/dtu.conf, float32", "views_per_scan": DTU_VIEWS,
           "image": [DTU_W, DTU_H], "source": DTU_SOURCE, "targets": list(DTU_TARGETS), "splits": DTU_SPLITS}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        data = write_dtu_fixture(os.path.join(tmp, "data"))
        seconds["write_fixture"] = time.time() - t0
        res["readers"] = pull_dvr_and_multi_obj(os.path.join(tmp, "small"))
        test_set = get_split_dataset("dvr_dtu", data, "test", training=False)
        train_set = get_split_dataset("dvr_dtu", data, "train")
        t0 = time.perf_counter()
        d = test_set[0]
        res["dtu_item_ms"] = {"test_49_views": (time.perf_counter() - t0) * 1e3}
        t0 = time.perf_counter()
        train_set[0]
        res["dtu_item_ms"]["train_49_views_jittered"] = (time.perf_counter() - t0) * 1e3
        res["dtu_item"] = {"images": list(d["images"].shape), "focal": d["focal"].tolist(), "c": d["c"].tolist()}
        if d["images"].shape != (DTU_VIEWS, DTU_H, DTU_W, 3) or d["focal"].shape != (2,):
            raise AssertionError(f"dtu_workflow: DTU item {res['dtu_item']}")
        common = ["-c", conf, "-F", "dvr_dtu", "-D", data, "--device", str(dev),
                  "--checkpoints_path", os.path.join(tmp, "ck")]

        # 1. train: 2 batches of 4 scans x 128 rays from 3 source views, its
        # eval, visual and checkpoint at batch 1 (dtu.conf repeats an epoch
        # 32 times: once here)
        argv = common + ["-V", "3", "-B", str(DTU_TRAIN_SB), "-R", str(DTU_TRAIN_RAYS), "--epochs", "1",
                         "--epoch_batches", "2", "--workers", "1", "--override", "train.num_epoch_repeats=1",
                         "--logs_path", os.path.join(tmp, "logs"), "--visual_path", os.path.join(tmp, "vis")]
        trainer, lines, seconds["train"], launches = run_app(train_app, argv)
        from pixelnerf_tpu_torch.apps.train import VIS_RAY_CHUNK

        vis_chunks = -(-DTU_H * DTU_W // VIS_RAY_CHUNK)
        expect = {"gather_rows_lerp": 2 * 2, "gather_rows_lerp_bwd": 2 * 2, "gather_bilerp": 2 + 2 * vis_chunks,
                  "fused_resnetfc_infer": 0, "fused_gather_resnetfc_infer": 0}
        losses = [float(l.split(" t:")[1].split()[0]) for l in lines if l.startswith("E")]
        visuals = os.listdir(os.path.join(tmp, "vis", "example"))
        vis = png.imread(os.path.join(tmp, "vis", "example", visuals[0])) if visuals else None
        res["train"] = {"steps": trainer.step, "launches": launches, "expected_launches": expect,
                        "losses": losses, "visuals": visuals, "visual_shape": None if vis is None else list(vis.shape),
                        "jitter": type(trainer.train_pipeline.dataset).__name__}
        if launches != expect:
            raise AssertionError(f"dtu_workflow train: launch counts {launches} != expected {expect}")
        if (trainer.step != 2 or not losses or not all(math.isfinite(v) for v in losses) or vis is None
                or vis.shape != (2 * DTU_H, 5 * DTU_W, 3) or res["train"]["jitter"] != "ColorJitterDataset"):
            raise AssertionError(f"dtu_workflow train: {res['train']}")

        # 2. eval: two target views of the test scan from views 22, 25, 28
        view_list = os.path.join(tmp, "views.txt")
        with open(view_list, "w") as f:
            f.write(" ".join(str(v) for v in DTU_TARGETS) + "\n")
        out_dir = os.path.join(tmp, "eval_out")
        argv = common + ["-P", DTU_SOURCE, "--eval_view_list", view_list, "-R", str(DTU_RAY_CHUNK), "-O", out_dir]
        _, lines, seconds["eval"], launches = run_app(eval_app, argv)
        views = len(DTU_TARGETS) * len(DTU_SPLITS["test"])
        chunks = -(-len(DTU_TARGETS) * DTU_H * DTU_W // DTU_RAY_CHUNK)
        expect = {"gather_rows_lerp": 0, "gather_rows_lerp_bwd": 0, "gather_bilerp": 2 * chunks,
                  "fused_resnetfc_infer": 0, "fused_gather_resnetfc_infer": 0}
        finish = open(os.path.join(out_dir, "finish.txt")).read().splitlines()
        res["eval"] = {"ray_chunk": DTU_RAY_CHUNK, "finish": finish, "launches": launches, "expected_launches": expect,
                       "printed": [l for l in lines if "psnr" in l]}
        if launches != expect:
            raise AssertionError(f"dtu_workflow eval: launch counts {launches} != expected {expect}")
        name, psnr, ssim, n = finish[0].split()
        bounds = [psnr_interval_from_png(png.imread(os.path.join(out_dir, name, f"{v:06d}.png")),
                                         d["images"][v] * 0.5 + 0.5) for v in DTU_TARGETS]
        lo, hi = (sum(b[i] for b in bounds) / len(bounds) for i in (0, 1))
        res["eval"]["psnr_from_png"] = [lo, hi]
        if len(finish) != 1 or int(n) != len(DTU_TARGETS) or not (lo <= float(psnr) <= hi and math.isfinite(float(ssim))):
            raise AssertionError(f"dtu_workflow eval: finish.txt {finish}, psnr from the images [{lo}, {hi}]")

        # 3. the eval render through kernel A and through its plain version,
        # the same checkpoint and draws: bit for bit
        args, cfg_tree = parse_args(eval_app.extra_args, argv=common + ["-P", DTU_SOURCE, "-R", str(DTU_RAY_CHUNK)])
        with contextlib.redirect_stdout(io.StringIO()):
            net = eval_app.load_net_and_state(args, cfg_tree, dev)
        cfg = eval_app.eval_render_config(cfg_tree, test_set, coarse=False)
        src, targets = np.array([int(x) for x in DTU_SOURCE.split()]), np.array(DTU_TARGETS)
        renders = {}
        for use_kernels in (True, False):
            renderer = FullRenderer(net, cfg, ray_chunk=DTU_RAY_CHUNK, use_kernels=use_kernels)
            gen = torch.Generator(device=dev).manual_seed(9)
            torch.cuda.synchronize()
            t0 = time.time()
            renders[use_kernels] = eval_app.render_object(renderer, d, src, targets, test_set.z_near,
                                                          test_set.z_far, generator=gen)
            torch.cuda.synchronize()
            seconds["render_" + ("kernels" if use_kernels else "plain")] = time.time() - t0
        (rgb_k, depth_k), (rgb_p, depth_p) = renders[True], renders[False]
        err = {"rgb": (rgb_k - rgb_p).abs().max().item(), "depth": (depth_k - depth_p).abs().max().item()}
        finite = bool(torch.isfinite(rgb_k).all() and torch.isfinite(depth_k).all())
        k = cfg.n_coarse + cfg.n_fine
        rgb_rounding = 2 * k * 2.0 ** -24      # as srn_workflow's bound, without the white background
        res["kernel_vs_plain"] = {"max_abs_err": err, "tolerance": 0.0, "shape": list(rgb_k.shape),
                                  "rgb_range": [rgb_k.min().item(), rgb_k.max().item()],
                                  "depth_range": [depth_k.min().item(), depth_k.max().item()],
                                  "rgb_rounding_allowance": rgb_rounding}
        del renders, rgb_p, depth_p, net

    # 4. C-bwd at the DTU train step's table, against its plain version,
    # two launches bit-equal
    res["c_bwd_dtu_table"] = c_bwd_against_plain(*bench.make_inputs(dev, torch.Generator().manual_seed(7), "dtu"))
    res["seconds"] = seconds
    res["train_seconds_per_batch"] = seconds["train"] / 2
    res["eval_ms_per_view"] = seconds["eval"] * 1e3 / views
    res["render_ms_per_view"] = seconds["render_kernels"] * 1e3 / len(DTU_TARGETS)
    res["launches"] = {k: res["train"]["launches"][k] + res["eval"]["launches"][k]
                       for k in ("gather_bilerp", "gather_rows_lerp", "gather_rows_lerp_bwd")}
    res["launches_per"] = {"gather_bilerp_per_eval_view": res["eval"]["launches"]["gather_bilerp"] / views,
                           "gather_rows_lerp_per_train_step": res["train"]["launches"]["gather_rows_lerp"] / 2,
                           "gather_rows_lerp_bwd_per_train_step": res["train"]["launches"]["gather_rows_lerp_bwd"] / 2}
    res["card"] = nvidia_smi_line()
    emit(res)
    if max(err.values()) != 0.0:
        raise AssertionError(f"dtu_workflow: eval render through kernel A differs from plain: {err}")
    if not (finite and rgb_k.shape == (len(DTU_TARGETS), DTU_H, DTU_W, 3) and rgb_k.min() >= 0
            and rgb_k.max() <= 1 + rgb_rounding):
        raise AssertionError(f"dtu_workflow: render out of range: {res['kernel_vs_plain']}")
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
    train_runs = {key: run_train(dev, key) for key in TRAIN_CONFIGS}
    for res in list(train_runs.values()) + [run_train_app(dev)]:
        for k in train_launches:
            train_launches[k] += res["launches"][k]
    train_kernel_vs_plain(dev)

    # the SRN evaluation workflow: train, eval, resume, eval_approx; the
    # apps that consume its model; then the DTU workflow at NS = 3 and 400x300
    with tempfile.TemporaryDirectory() as srn_tmp:
        srn = run_srn_workflow(dev, srn_tmp)
        apps = run_apps_workflow(dev, srn_tmp, train_runs["b"])
    dtu = run_dtu_workflow(dev)
    for k in train_launches:
        train_launches[k] += srn["launches"][k] + dtu["launches"][k] + apps["launches"][k]

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
    # launches: A over the staged inference path, the SRN and DTU
    # workflows and the video and real-image apps, B over the staged path,
    # B's z_is_tz variant over the baked path, D over the fused path, C and
    # C-bwd over both training configs, the train app, the two workflows,
    # the "dots" run and the profiled train app, the study's formulations
    # over its bench script
    launches["gather_bilerp"] += sum(r["launches"]["gather_bilerp"] for r in (srn, dtu, apps))
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
