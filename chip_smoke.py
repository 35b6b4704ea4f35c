#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one NVIDIA GPU and check them.

Its paths, at the full width and depth of the SRN model
(``conf/exp/srn.conf``: ResNet34 to a 512-channel latent, ResnetFC 512 x 5
blocks, 64 coarse + 32 fine samples), weights random from a seed:

- inference, in bf16: ``make_model`` -> ``encode`` of one 128^2 source
  view -> ``FullRenderer(fast=True).render_image`` of three 128x128 novel
  views (three requests), staged: the feature stage in one launch of kernel
  A's field instance, kernel B's MLP;
- inference at three source views, in bf16: the DTU model
  (``conf/exp/dtu.conf``) -> ``encode`` of three 400x300 views ->
  ``FullRenderer(fast=True).render_image`` of one view in 40,000-ray
  chunks, as ``dtu.render`` runs it: kernel A, kernel B's multi-view mode;
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
- the model variants: the global encoder, the custom conv encoder, SPADE
  and softplus with ``feature_scale``, ImplicitNet fields and the quad
  gather, three requests each, and a train step of three of them;
- mesh extraction, f32: ``apps.recon --reso 128`` on the SRN workflow's
  model, its OBJ read back and rasterized;
- the multi-GPU layer at world size 1 (NCCL): the sharded render and the
  sharded train step against their single-process forms;
- the DTU workflow, f32, at three source views and 400x300
  (``conf/exp/dtu.conf``): ``apps.train -F dvr_dtu -V 3`` ->
  ``apps.eval -F dvr_dtu -P "22 25 28"`` on a DTU-layout fixture.

Phases, one JSON line each:

1. device: ``nvidia-smi`` name and power limit, torch and CUDA versions
2. build: the five CUDA sources of ``pixelnerf_tpu_torch/csrc`` for
   sm_90a, one nvcc each, in parallel
2b. jpeg: the port's JPEG reader (host code) on every committed fixture of
   ``tests/fixtures/jpeg/``, bit-equal to its expected decode; ms per image
   and megapixels/s of the 420x420 photo and of the largest fixture, beside
   the PNG reader's ms on the same pixels
3. kernel A (gather) and 4. kernel B (fused MLP) against their plain
   PyTorch versions at the inference path's shapes, with times, the bound
   and a library call's time; A also on the baked path's 1536-wide rows,
   at 64 and 256 channels and on one request's ray-major coarse points
3b. kernel_a_field: A's field instance (the feature stage in one launch)
   through ``scripts/bench_gather_field_torch.py`` at one ``dtu.render``
   coarse chunk and one ``srn.render`` view's samples, bit-equal to its
   plain mirror, timed beside its bound, the mirror and the separate stage
4b. kernel_b_views: kernel B's multi-view mode at one fine chunk of a DTU
   view (40,000 rays x 96 samples x 3 source views) through
   ``ResnetFC(fast=True)``, against its plain version and timed beside it
   and the dense bf16 chain (both by slices of the points: at this shape
   they do not fit the card); its bound at the function's own widths
   (``mlp_views_flops``) and at the padded ones (``mlp_flops``)
5. main_path: the inference path, with A's field instance's and B's
   launch counts read around it, and ``field.features``' spans
   (``inputs_fused``) around one more request
6. kernel_vs_plain_e2e: a 2048-ray crop rendered through the kernels and
   through their plain versions, on the same noise; field_vs_separate_e2e:
   the crop with the feature stage composed around kernel A instead
6b. dtu_main_path: the DTU request at three source views in bf16
   (``conf/exp/dtu.conf``, 400x300, 40,000-ray chunks) through
   ``FullRenderer(fast=True)``: kernel B's multi-view mode, with the launch
   counts and ``field.mlp``'s and ``field.features``' spans read around one
   view, its ms and peak memory, and a crop against the plain versions and
   against the separate feature stage on the same noise
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
    scale, timed, each formulation's share of its bound and its modelled
    L2 bytes over ms; block_stage's binning held to its plain mirror),
    float32 and bf16 tables
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
    decode ms; then ``apps.eval --scale 2`` of one object's two target
    views at 256x256 (A: 131,072 rays in 3 chunks, 6 launches), its
    upscaled ground truth in the comparison image equal to the same area
    upscale made on this host, its PSNR within the written images'
20. dtu_workflow (run after 19): a DTU-layout fixture (3 scans x 49 views
    at 400x300, DTU-like cameras: fx, fy ~ 720, an off-centre principal
    point, P of two positive scales, a scale_mat), ``apps.train -F dvr_dtu -V
    3`` for 2 batches of 4 x 128 rays with colour jitter (C, C-bwd; its
    eval and 400x300 visual through A), ``apps.eval -P "22 25 28"`` of two
    target views (A), the eval render through A bit-equal to its plain
    version, ``finish.txt``'s PSNR against the written PNGs, C-bwd at the
    DTU train step's 360,000-row f32 table (against plain, two launches
    bit-equal), the NMR (``-F dvr``) and multi-object readers pulled on
    this host with no imaging library loaded (``readers_jpeg``: an NMR
    object of the committed 64x64 JPEG views, its item equal to its twin's
    of decoded PNG views); launch counts per view and per step, seconds per
    batch, ms per view, the DTU item's ms

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

21b. preproc (run after 21, on srn_workflow's checkpoint): ``apps.preproc
    --backend grabcut`` on ``raw/photo1.png`` and ``raw/photo2.png``
    (420x420), GrabCut's per-pixel work on the card, then with ``--cpu``;
    the card's outputs held to the CPU's (equal, or foreground IoU >= 0.99
    with the differing pixels counted); per photo the ms of each step (each
    GrabCut pass's device work and host cut apart), the foreground share,
    the ellipse and crop radius; then ``apps.eval_real --debug_nans`` on
    the card's outputs at 128x128 (4 views each; A, launches counted). The
    photos also hold photo1 as the committed JPEG (quality 90, 4:2:0) and
    as a PNG of its expected decode, whose outputs must be equal; then
    ``apps.eval_real`` on that 420x420 JPEG itself (A, launches counted)

22. recon (run after 21, on srn_workflow's fixture and checkpoint; SRN
    model, f32): a level from ``eval_sigma_grid`` at 32^3 (its 95th
    percentile), then ``apps.recon --reso 128`` (2,097,152 points in 32
    queries of 65,536: kernel A; the colours at the vertices: A), with the
    grid, surface, colour and OBJ write times; the mesh's counts and index
    range; the OBJ read back with the port's ``load_obj`` and rasterized
    to one 128x128 view; one grid chunk through A held to its plain
    version

23. parallel (run after 18): a process group of world size 1 over NCCL,
    ``make_mesh()`` (1 x 1), ``make_sharded_render(fast=True)`` and
    ``FullRenderer(mesh=)`` on one 128x128 request of the bf16 SRN model
    bit-equal to ``FullRenderer`` on the same draws (A, B), one train step
    of config (a) with ``mesh=`` bit-equal in every parameter to the step
    without it (C, C-bwd); one card measures no scaling

23b. tools (run after 20): the port's user tools on the card's host, each
    step timed: ``scripts/make_multi_obj_dataset_torch.py`` (6 scenes x 8
    views at 64^2) read by ``MultiObjectDataset``; ``apps.train -F
    multi_obj`` for 2 batches and 2 more resumed (C, C-bwd; its eval and
    visual through A) with ``snapshot_watcher_torch``'s rule after each;
    ``quality_curve_torch`` over the two snapshots and the live file (A);
    ``export_demo_checkpoint_torch`` (bf16, its size against the full
    file's) and ``eval_approx`` on it (A); ``render_shapenet_objs_torch
    --backend software`` on two cube models (ms per view) read by
    ``MultiObjectDataset``; ``make_real_layout_fixtures_torch`` read by the
    SRN and DVR readers; ``make_real_input_torch`` against
    ``raw/photo*.png`` (differing values counted)

24. variants (run last): the model variants of the SRN model at full
    width, bf16, three requests each through ``FullRenderer(fast=True)``
    with A's and B's launches asserted per config: ``global`` (a ResNet34
    global encoder, latent 128: B at z 640), ``custom`` (the custom conv
    encoder: A on a 128-channel 128x128 map, B at z 128),
    ``spade_softplus`` (SPADE, softplus beta 10, feature_scale 0.5: the
    dense chain, no B), ``implicit`` (ImplicitNet fields: no B), ``quad``
    (the quad-corner gather: no A); kernel B at z 640 and 128 (with its
    ring stages) and A on the 128-channel map against their plain
    versions; the global config's crop through the kernels and through
    their plain versions; three f32 train steps each of ``global``,
    ``custom`` and ``quad`` after a warm-up (C's and C-bwd's launches
    asserted, none for quad); C and C-bwd at the custom encoder's table (C bit-equal to
    plain, C-bwd's grad_table bit-equal to its mirror)

then the seconds of every phase (``phase_seconds``), the ``kernels``
line, the card's name and power limit, and
``{"ok": true, ...}`` as the last line. Any failure raises and exits
non-zero; without a GPU it exits non-zero before printing anything.

Usage: ``python3 chip_smoke.py`` from the root of the repository.
"""
import contextlib
import copy
import ctypes
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


def queued_ms(fn, reps=50):
    """Mean device time of ``fn`` over ``reps`` calls queued behind a
    device-side wait (~25 ms, longer than the host takes to enqueue them),
    so that a launch shorter than its host cost is timed on the device
    alone."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
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


def rows_read(idx):
    """The table rows that (N, 4) corner indices touch, each counted once:
    what a gather's bound reads of its table."""
    return torch.unique(idx).numel()


def kernel_a_record(dev, g, hl, wl, c):
    """Kernel A at one image's coarse gather from an hl x wl x c bf16
    latent table, 16384 rays x 64 samples, bf16 output (the MLP's input
    dtype): held to its plain version bit for bit and timed. Returns the
    record and (table, base, w, n)."""
    import torch.nn.functional as F

    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import bench_gather_a_torch as bench_a

    from pixelnerf_tpu_torch.ops.gather import gather_bilerp, gather_bilerp_plain
    from pixelnerf_tpu_torch.ops.grid_sample import bilinear_pair_bases

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
    bytes_moved = n * c * 2 + n * (8 + 8) + bench_a.rows_read(base, wl) * c * 2
    bound_ms, bound_by = bound(bytes_moved, 6 * n * c, PEAK_F32_FLOPS)
    res = {
        "name": "gather_bilerp", "route": "cuda",
        "source": "pixelnerf_tpu_torch/csrc/gather.cu",
        "replaces": "pixelnerf_tpu/ops/gather_pallas.py:110",
        "shape": {"table": [hl * wl, c], "points": n, "out_dtype": "bfloat16"},
        "max_abs_err": err, "tolerance": tol,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by, "bound_share": bound_ms / ms,
        "library_ms": library_ms, "library_call": "F.grid_sample(NCHW bf16, bilinear, border)",
    }
    return res, (table, base, w, n)


def check_kernel_a(dev, g):
    """Kernel A at one image's coarse gather: a 64x64x512 bf16 latent table,
    16384 rays x 64 samples, bf16 output (the MLP's input dtype); also on
    the baked path's 1536-wide rows, at 64 and 256 channels (the ResNet
    encoder's latent at num_layers 1 and 3) and on one request's ray-major
    coarse points (``scripts/bench_gather_a_torch.py``), each bit-equal to
    its plain version, timed, with its bound's share of the time."""
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import bench_gather_a_torch as bench_a

    from pixelnerf_tpu_torch.ops.gather import gather_bilerp, gather_bilerp_plain

    hl = wl = 64
    res, (table, base, w, n) = kernel_a_record(dev, g, hl, wl, 512)
    tol = res["tolerance"]
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
    bound_w, _ = bound(n * 1536 * 2 + n * (8 + 8) + bench_a.rows_read(base, wl) * 1536 * 2, 6 * n * 1536,
                       PEAK_F32_FLOPS)
    ms_w = time_ms(lambda: gather_bilerp(wide, base, w, wl, torch.bfloat16), reps=10)
    res["wide_rows"] = {
        "table": [hl * wl, 1536], "points": n, "max_abs_err": err_w, "points_compared": m,
        "ms": ms_w, "bound_ms": bound_w, "bound_share": bound_w / ms_w,
    }
    del wide
    # one lane a 16-byte piece: 8 lanes a point (4 points a warp) at 64
    # channels, 32 at 256; then the main path's own distribution of points
    keep = ("points", "table", "max_abs_err", "ms", "bound_ms", "bound_share")
    for c in (64, 256):
        t = torch.randn((hl * wl, c), generator=g).to(torch.bfloat16).to(dev)
        r = bench_a.reading(t, base, w, None, hl, wl, torch.bfloat16, library=False)
        res[f"channels_{c}"] = {k: r[k] for k in keep}
    base_r, w_r, _ = bench_a.request_points(hl, wl, dev)
    r = bench_a.reading(table, base_r, w_r, None, hl, wl, torch.bfloat16, library=False)
    res["request_points"] = {k: r[k] for k in keep}
    bad = {k: res[k]["max_abs_err"] for k in ("channels_64", "channels_256", "request_points")
           if res[k]["max_abs_err"] > tol}
    if bad:
        raise AssertionError(f"kernel A disagrees with its plain version: {bad} > {tol}")
    emit({"phase": "kernel_a", **res})
    return res


def check_kernel_a_field(dev):
    """Kernel A's field instance (``gather_bilerp_field``: the feature stage
    in one launch) through ``scripts/bench_gather_field_torch.py`` at one
    ``dtu.render`` coarse chunk (7,680,000 rows, bf16) and one ``srn.render``
    view's samples (1,572,864 rows, bf16 and float32): bit-equal to its
    plain mirror, timed beside its bound, the mirror and the separate stage
    it replaces (``library_ms``: ``_point_inputs``, ``index_latent`` through
    kernel A, the casts)."""
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import bench_gather_field_torch as bench_f

    readings = [bench_f.measure(shape, pair, dev) for shape, pair in (("dtu", "bf16"), ("srn", "bf16"), ("srn", "f32"))]
    unequal = [(r["shape"], r["pair"]) for r in readings if not r["bit_equal_to_plain"]]
    dtu = readings[0]
    res = {
        "name": "gather_bilerp_field", "route": "cuda", "source": "pixelnerf_tpu_torch/csrc/gather.cu",
        "replaces": "none: the feature stage around gather_packed_lerp, pixelnerf_tpu/models/pixelnerf.py (XLA's)",
        "max_abs_err": float("inf") if unequal else 0.0, "tolerance": 0.0,
        "ms": dtu["ms"], "plain_ms": dtu["plain_ms"], "bound_ms": dtu["bound_ms"], "bound_by": "bytes",
        "bound_share": dtu["bound_share"], "library_ms": dtu["separate_ms"],
        "library_call": "the separate stage: _point_inputs, index_latent through kernel A, the casts",
        "readings": readings,
    }
    emit({"phase": "kernel_a_field", **res})
    if unequal:
        raise AssertionError(f"kernel A's field instance differs from its plain mirror: {unequal}")
    return res


def check_kernel_b(dev, g, mlp, phase="kernel_b", more_shapes=True):
    """Kernel B at the coarse pass's shape: one image's 16384 x 64 samples
    through the SRN fine MLP's weights (512 wide, 5 blocks, 3 injections),
    or a variant's fine MLP (its latent width); with ``more_shapes`` also
    at the fine pass's and a ragged number of rows."""
    from pixelnerf_tpu_torch.ops.fused_mlp import (
        KC, fused_resnetfc_infer, fused_resnetfc_infer_plain, pack_weights, z_tile_width,
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
        "z_tile": z_tile_width(mlp.d_latent),
        "ring_stages": ring_stages(-(-mlp.d_in // KC) * KC, z_tile_width(mlp.d_latent), dh),
        "max_abs_err": err, "tolerance": tol, "frac_within_1e-2": close,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms, "library_call": "bf16 torch.matmul chain (ResnetFC fast=False)",
        "tflops": flops / ms / 1e9, **mlp_traffic(n, ms, weights, mlp.d_latent * 2, bytes_moved),
    }

    def other_shape(m):
        zm = torch.randn((m, mlp.d_latent), generator=g).to(torch.bfloat16).to(dev)
        xm = torch.randn((m, mlp.d_in), generator=g).to(torch.bfloat16).to(dev)
        return (zm, xm, weights, mlp.n_blocks, mlp.combine_layer)

    if more_shapes:
        res.update(mlp_other_shapes(fused_resnetfc_infer, fused_resnetfc_infer_plain, other_shape, "kernel B",
                                    lambda m: mlp_flops(m, weights, mlp)))
    emit({"phase": phase, **res})
    return res


DTU_CHUNK_RAYS, DTU_CHUNK_SAMPLES, DTU_SOURCE_VIEWS = 40_000, 96, 3   # one fine chunk of a DTU view (dtu.render)


def check_kernel_b_views(dev, g, mlp, slices=8):
    """Kernel B's multi-view mode at one fine chunk of a DTU view: 40,000
    rays x 96 samples, 3 source views averaged at combine_layer, through
    the SRN fine MLP's weights (the DTU model's widths: latent 512, 512
    wide, 5 blocks, 3 injections), one launch through
    ``ResnetFC(fast=True)``. Its plain version and the dense bf16 chain
    (the library yardstick, what ran before at NS > 1) hold float32 or
    (rows, 1536) copies that do not fit the card at this shape: they run on
    ``slices`` slices of the points, held and timed slice by slice."""
    from pixelnerf_tpu_torch.ops.fused_mlp import (
        disagreement_with_plain, agrees_with_plain, fused_resnetfc_infer, fused_resnetfc_infer_plain,
        pack_weights,
    )

    b, views = DTU_CHUNK_RAYS * DTU_CHUNK_SAMPLES, DTU_SOURCE_VIEWS
    z = torch.randn((views * b, mlp.d_latent), generator=g).to(torch.bfloat16).to(dev)
    x = torch.randn((views * b, mlp.d_in), generator=g).to(torch.bfloat16).to(dev)
    weights = pack_weights(mlp)
    before = fused_resnetfc_infer.launches
    out = mlp((z, x), combine_inner_dims=(views, b), fast=True).reshape(-1, 4)
    torch.cuda.synchronize()
    launches = fused_resnetfc_infer.launches - before
    assert launches == 1, launches

    def part(t, lo, hi):     # the points lo..hi of every view
        return t.reshape(views, b, -1)[:, lo:hi].reshape(views * (hi - lo), -1)

    edges = [b * i // slices for i in range(slices + 1)]
    refs, peaks, plain_ms, library_ms = [], [], 0.0, 0.0
    for lo, hi in zip(edges[:-1], edges[1:]):
        zs, xs = part(z, lo, hi), part(x, lo, hi)
        ref, peak = fused_resnetfc_infer_plain(zs, xs, weights, mlp.n_blocks, mlp.combine_layer, hidden_max=True,
                                               views=views, points=hi - lo)
        refs.append(ref)
        peaks.append(peak)
        plain_ms += time_ms(lambda: fused_resnetfc_infer_plain(zs, xs, weights, mlp.n_blocks, mlp.combine_layer,
                                                               views=views, points=hi - lo), reps=1, warmup=0)
        library_ms += time_ms(lambda: mlp((zs, xs), combine_inner_dims=(views, hi - lo), fast=False),
                              reps=1, warmup=1 if lo == 0 else 0)
        del zs, xs
    agree = disagreement_with_plain(out, torch.cat(refs), torch.cat(peaks))
    if not agrees_with_plain(agree):
        raise AssertionError(f"kernel B's multi-view mode disagrees with its plain version: {agree}")
    del out, refs, peaks
    ms = time_ms(lambda: fused_resnetfc_infer(z, x, weights, mlp.n_blocks, mlp.combine_layer, views=views,
                                              points=b), reps=5)
    dh, n_lin_z = mlp.d_hidden, mlp.n_lin_z
    flops = mlp_views_flops(b, mlp, views)
    bytes_moved = views * b * (mlp.d_in + mlp.d_latent) * 2 + b * 4 * 4 + sum(w.numel() * 2 for w in weights)
    bound_ms, bound_by = bound(bytes_moved, flops, PEAK_BF16_FLOPS)
    padded_ms, _ = bound(bytes_moved, mlp_flops(b, weights, mlp, views=views), PEAK_BF16_FLOPS)
    res = {
        "name": "fused_resnetfc_infer[views=3]", "route": "cuda",
        "source": "pixelnerf_tpu_torch/csrc/fused_mlp.cu",
        "replaces": "none: the JAX package leaves NS > 1 to XLA",
        "shape": {"points": b, "views": views, "rows": views * b, "d_hidden": dh, "d_latent": mlp.d_latent,
                  "d_in": mlp.d_in, "n_blocks": mlp.n_blocks, "n_lin_z": n_lin_z},
        "max_abs_err": agree["max_abs_err"], "agreement": agree,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by, "bound_share": bound_ms / ms,
        "mflop_per_point": flops / b / 1e6, "bound_ms_padded": padded_ms, "bound_share_padded": padded_ms / ms,
        "library_ms": library_ms,
        "library_call": f"dense bf16 chain (ResnetFC fast=False), {slices} slices of the points",
        "plain_call": f"{slices} slices of the points",
        "tflops": flops / ms / 1e9, "check_launches": launches,
    }
    emit({"phase": "kernel_b_views", **res})
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


def mlp_flops(n, weights, mlp, with_wz=True, views=1):
    """Operations of the fused MLP on n rows, padded as
    pixelnerf_tpu/ops/fused_mlp.py:130-134 counts them (the injection
    product at the latent's own width d_z); with ``views`` above 1, on n
    points of that many views averaged at the combine layer (lin_in, the
    injections and the blocks before it once a view)."""
    dh, d_in_pad = weights[0].shape
    n_lin_z = min(mlp.combine_layer, mlp.n_blocks) if with_wz else 0
    d_z = weights[2].shape[1] if with_wz else 0
    if views > 1:
        pre = d_in_pad + n_lin_z * d_z + 2 * n_lin_z * dh
        return 2 * n * dh * (views * pre + 2 * (mlp.n_blocks - n_lin_z) * dh + 128)
    return 2 * n * dh * (d_in_pad + n_lin_z * d_z + 2 * mlp.n_blocks * dh + 128)


def mlp_views_flops(n, mlp, views):
    """Operations of the field on n points of ``views`` views averaged at
    the combine layer, at the function's own widths (not padded as
    :func:`mlp_flops` pads them): lin_in at d_in columns, the injections and
    the blocks before the combine layer once a view, the rest once a point,
    lin_out at 4 columns."""
    dh, n_lin_z = mlp.d_hidden, mlp.n_lin_z
    pre = mlp.d_in + n_lin_z * mlp.d_latent + 2 * n_lin_z * dh
    return 2 * n * dh * (views * pre + 2 * (mlp.n_blocks - n_lin_z) * dh + 4)


def ring_stages(kx, zw, dh):
    """The weight ring's stages that kernel B's block holds at these widths,
    asked of the built kernel (csrc/mlp_body.cuh stages_that_fit)."""
    from pixelnerf_tpu_torch.ops import _build

    fn = _build.load("fused_mlp").mlp_body_ring_stages
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_int
    return fn(kx, zw, dh)


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
        fused_gather_resnetfc_infer, fused_gather_resnetfc_infer_plain,
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
        "b_fed_by_a_ms": composition_ms, "tflops": flops / ms / 1e9,
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
    study's path (read before ``block_stage``'s launches are profiled);
    ``block_stage``'s binning must equal its plain mirror at both dtypes.
    The phase prints, per formulation and dtype, ms, the share of the bound
    and the bench's modelled L2 bytes over ms. Returns one kernels-line
    entry per formulation, timed from the bf16 table, the dtype the port's
    latents have, with its time and share from the float32 table beside
    it."""
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
    profiled = bench.block_stage_launches(dev)
    n, c = bench.P, bench.C
    by = {(r["name"], r["table"]): r for r in timed}
    bounds = {}
    for dtn, size in (("f32", 4), ("bf16", 2)):
        bounds[dtn] = bound(n * (32 + c * 4) + bench.H * bench.W * c * size, 7 * n * c, PEAK_F32_FLOPS)
    # per formulation and dtype: ms, the share of the bound, the modelled
    # L2 bytes (a model, not a counter) over ms
    summary = {f"{name} {dtn}": {"ms": by[(name, dtn)].get("ms"),
                                 "bound_share": bounds[dtn][0] / by[(name, dtn)]["ms"]
                                 if "ms" in by[(name, dtn)] else None,
                                 "modelled_l2_tb_s": by[(name, dtn)].get("modelled_l2_tb_s")}
               for name in FORMULATIONS for dtn in ("f32", "bf16")}
    emit({"phase": "kernel_e", "shape": {"table": [bench.H * bench.W, c], "points": n, "tile": bench.TILE,
                                         "out_dtype": "float32"},
          "bound_ms": {k: v[0] for k, v in bounds.items()}, "bound_by": bounds["bf16"][1],
          "launches": launches, "formulations": summary, "timings": timed,
          "block_stage_kernels_us": {r["table"]: r["us"] for r in profiled}})
    binning = [r for r in timed if r["name"] == "block_stage's binning"]
    if len(binning) != 2 or not all(r["matches_mirror"] for r in binning):
        raise AssertionError(f"block_stage's binning differs from its plain mirror: {binning}")
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
            "max_abs_err": max(r["max_abs_err"], by[(name, "f32")]["max_abs_err"]), "ms": r["ms"],
            "bound_share": summary[f"{name} bf16"]["bound_share"], "ms_f32_table": by[(name, "f32")]["ms"],
            "bound_share_f32": summary[f"{name} f32"]["bound_share"],
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
    seed_field(net, g, dev)
    return net, RenderConfig.from_conf(conf["renderer"])


def seed_field(net, g, dev):
    """Seeded weights off the init: fc_1 starts at zero (identity blocks),
    and a density bias makes the random field opaque, so the render has
    depth in [near, far] and rgb that varies across the image."""
    with torch.no_grad():
        for mlp in (net.mlp_coarse, net.mlp_fine):
            for blk in mlp.blocks:
                blk.fc_1.weight.copy_(torch.randn(blk.fc_1.weight.shape, generator=g).to(dev) * 0.02)
                blk.fc_1.bias.copy_(torch.randn(blk.fc_1.bias.shape, generator=g).to(dev) * 0.02)
            mlp.lin_out.bias[3] = 10.0
            mlp.lin_out.weight[:3] *= 0.1
            mlp.lin_out.weight[3] *= 0.01


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
    bytes_moved = n * c * 2 + n * (16 + 16) + rows_read(idx) * c * 2
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


def train_setup(dev, key, seed=0, variant=None):
    """The SRN model (or its ``variant``) for training config ``key``
    (weights from ``seed``), its config and the config's batches from the
    port's synthetic scenes at SRN geometry."""
    from pixelnerf_tpu_torch.data import RayBatchPipeline, SyntheticSphereDataset
    from pixelnerf_tpu_torch.models import make_model
    from pixelnerf_tpu_torch.render import RenderConfig

    tc = TRAIN_CONFIGS[key]
    conf = variant_conf(variant, tc["dtype"])
    net = make_model(conf["model"], device=dev, generator=torch.Generator().manual_seed(seed),
                     image_size=(IMAGE, IMAGE))
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
    # each epoch the trainer's eval renders through kernel A's field
    # instance (2 launches) and so does its visual, one full view in chunks
    # of VIS_RAY_CHUNK rays
    expect = {"gather_rows_lerp": 2 * steps, "gather_rows_lerp_bwd": 2 * steps, "gather_bilerp": 0,
              "gather_bilerp_field": (2 + 2 * vis_chunks()) * epochs, "fused_resnetfc_infer": 0,
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
SRN_SCALE_TARGETS = (31, 127)      # apps.eval --scale 2 of one object: 256x256, 131,072 rays


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


JPEG_FIXTURES = os.path.join(REPO, "tests", "fixtures", "jpeg")
JPEG_TIMED = ("photo1", "texture_400x300")    # the 420x420 photo and the largest fixture
JPEG_REPEATS = 5


def run_jpeg(tmp):
    """The port's JPEG reader on this host: every committed fixture of
    ``tests/fixtures/jpeg/`` decoded by ``jpeg.imread`` and held bit for bit
    to its expected decode (``expected.npz``, imageio's decode where the
    fixtures were made), and through ``image_io.imread``; then the ms per
    image (the least and the median of JPEG_REPEATS decodes) and megapixels
    per second of the photo and of the largest fixture, beside the PNG
    reader's ms on the same pixels written by the port's PNG writer."""
    import glob

    import numpy as np

    from pixelnerf_tpu_torch.utils import image_io, jpeg, png

    expected = np.load(os.path.join(JPEG_FIXTURES, "expected.npz"))
    paths = sorted(glob.glob(os.path.join(JPEG_FIXTURES, "*.jpg")))
    names = [os.path.splitext(os.path.basename(p))[0] for p in paths]
    if sorted(names) != sorted(expected.files) or not paths:
        raise AssertionError(f"jpeg: the fixtures {names} and their decodes {expected.files} differ")
    differing = {}
    for name, path in zip(names, paths):
        for how, got in (("jpeg", jpeg.imread(path)), ("image_io", image_io.imread(path))):
            ref = expected[name]
            if got.shape != ref.shape or got.dtype != ref.dtype or not np.array_equal(got, ref):
                differing[f"{name} ({how})"] = (list(got.shape), list(ref.shape), int(np.sum(got != ref))
                                               if got.shape == ref.shape else None)
    timed = {}
    for name in JPEG_TIMED:
        path = os.path.join(JPEG_FIXTURES, f"{name}.jpg")
        ms = []
        for _ in range(JPEG_REPEATS):
            t0 = time.perf_counter()
            jpeg.imread(path)
            ms.append((time.perf_counter() - t0) * 1e3)
        as_png = os.path.join(tmp, f"{name}.png")
        png.imwrite(as_png, expected[name])
        png_ms = []
        for _ in range(JPEG_REPEATS):
            t0 = time.perf_counter()
            png.imread(as_png)
            png_ms.append((time.perf_counter() - t0) * 1e3)
        h, w = expected[name].shape[:2]
        timed[name] = {"size": [w, h], "bytes": os.path.getsize(path), "ms_min": min(ms),
                       "ms_median": float(np.median(ms)), "megapixels_per_s": h * w / 1e3 / float(np.median(ms)),
                       "png_ms_median": float(np.median(png_ms)), "png_bytes": os.path.getsize(as_png)}
    rec = {"phase": "jpeg", "card": nvidia_smi_line(), "files": len(paths),
           "bit_equal": len(paths) - len({k.split(" ")[0] for k in differing}), "differing": differing,
           "timed": timed, "repeats": JPEG_REPEATS}
    emit(rec)
    if differing:
        raise AssertionError(f"jpeg: decodes differ from the expected ones: {differing}")
    return rec


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
    from pixelnerf_tpu_torch.eval.common import resize_area_like_cv2
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
    expect = {"gather_rows_lerp": 2 * 2, "gather_rows_lerp_bwd": 2 * 2, "gather_bilerp": 0,
              "gather_bilerp_field": 2 + 2 * vis_chunks(), "fused_resnetfc_infer": 0,
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
    expect = {"gather_rows_lerp": 0, "gather_rows_lerp_bwd": 0, "gather_bilerp": 0,
              "gather_bilerp_field": per_object * SRN_OBJECTS, "fused_resnetfc_infer": 0,
              "fused_gather_resnetfc_infer": 0}
    finish = open(os.path.join(out_dir, "finish.txt")).read().splitlines()
    res["eval"] = {"ray_chunk": chunk, "printed": [l for l in lines if "psnr" in l], "finish": finish,
                   "launches": launches, "expected_launches": expect,
                   "gather_bilerp_field_launches_per_view":
                       launches["gather_bilerp_field"] / (len(SRN_TARGETS) * SRN_OBJECTS)}
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
    expect = {"gather_rows_lerp": 0, "gather_rows_lerp_bwd": 0, "gather_bilerp": 0,
              "gather_bilerp_field": 2 * -(-IMAGE * IMAGE // chunk), "fused_resnetfc_infer": 0,
              "fused_gather_resnetfc_infer": 0}
    res["eval_approx"] = {"psnr_ssim": approx, "launches": launches, "expected_launches": expect}
    if launches != expect:
        raise AssertionError(f"srn_workflow eval_approx: launch counts {launches} != expected {expect}")
    if approx is None or not all(math.isfinite(v) for v in approx):
        raise AssertionError(f"srn_workflow eval_approx: {approx}")

    # 4b. eval --scale 2: one object's two target views at 256x256 (the
    # ground truth area-upscaled from 128x128 as OpenCV's INTER_AREA does)
    scale_views = os.path.join(tmp, "views_scale2.txt")
    with open(scale_views, "w") as f:
        f.write(" ".join(str(v) for v in SRN_SCALE_TARGETS) + "\n")
    scale_dir = os.path.join(tmp, "eval_scale2")
    argv = common + ["-P", str(SRN_SOURCE), "--eval_view_list", scale_views, "--scale", "2", "--limit", "1",
                     "--write_compare", "-O", scale_dir]
    _, lines, seconds["eval_scale2"], launches = run_app(eval_app, argv)
    chunk = int(parse_args(eval_app.extra_args, argv=argv)[0].ray_batch_size)
    side = 2 * IMAGE
    expect = {"gather_rows_lerp": 0, "gather_rows_lerp_bwd": 0, "gather_bilerp": 0,
              "gather_bilerp_field": 2 * -(-len(SRN_SCALE_TARGETS) * side * side // chunk),
              "fused_resnetfc_infer": 0, "fused_gather_resnetfc_infer": 0}
    name, psnr, ssim, n = open(os.path.join(scale_dir, "finish.txt")).read().split()
    gt_src = test_set[0]["images"] * 0.5 + 0.5
    bounds, gt_equal = [], []
    for v in SRN_SCALE_TARGETS:
        # the app's upscale on this host against the same resize made here,
        # as the written comparison image holds it
        gt = np.clip(resize_area_like_cv2(gt_src[v], side, side), 0.0, 1.0)
        compare = png.imread(os.path.join(scale_dir, name, f"{v:06d}_compare.png"))
        gt_equal.append(bool(np.array_equal(compare[:, :side], (gt * 255).astype(np.uint8))))
        bounds.append(psnr_interval_from_png(png.imread(os.path.join(scale_dir, name, f"{v:06d}.png")), gt))
    lo, hi = (sum(b[i] for b in bounds) / len(bounds) for i in (0, 1))
    res["eval_scale2"] = {"image": side, "rays": len(SRN_SCALE_TARGETS) * side * side, "ray_chunk": chunk,
                          "finish": [name, psnr, ssim, n], "psnr_from_png": [lo, hi], "gt_equal": gt_equal,
                          "launches": launches, "expected_launches": expect,
                          "ms_per_view": seconds["eval_scale2"] * 1e3 / len(SRN_SCALE_TARGETS)}
    if launches != expect:
        raise AssertionError(f"srn_workflow eval --scale 2: launch counts {launches} != expected {expect}")
    if not (all(gt_equal) and int(n) == len(SRN_SCALE_TARGETS) and math.isfinite(float(psnr))
            and lo <= float(psnr) <= hi and math.isfinite(float(ssim))):
        raise AssertionError(f"srn_workflow eval --scale 2: {res['eval_scale2']}")

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
    res["launches"] = {k: sum(res[p]["launches"][k] for p in ("train", "eval", "eval_approx", "eval_scale2"))
                       for k in ("gather_bilerp", "gather_bilerp_field", "gather_rows_lerp", "gather_rows_lerp_bwd")}
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
# committed 420x420 photos under raw/; photo1 as a JPEG (tests/fixtures/jpeg/photo1.jpg,
# quality 90, 4:2:0) and as a PNG of that JPEG's expected decode
PREPROC_PHOTOS = ("photo1.png", "photo2.png", "photo1_q90.jpg", "photo1_q90_decoded.png")
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
    spherical orbit and a spline, kernel A's field instance; one frame also
    through its plain version, bit for bit, and through the separate
    feature stage, within 1e-4; the GIF's structure and write time),
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
    none = {"gather_rows_lerp": 0, "gather_rows_lerp_bwd": 0, "gather_bilerp": 0, "gather_bilerp_field": 0,
            "fused_resnetfc_infer": 0, "fused_gather_resnetfc_infer": 0}
    res = {"phase": "apps_workflow", "model": "conf/exp/srn.conf, float32", "image": IMAGE}
    launches = {"gather_bilerp": 0, "gather_bilerp_field": 0, "gather_rows_lerp": 0, "gather_rows_lerp_bwd": 0}

    # 1. gen_video: 8 frames of a spherical orbit, 4 of a spline through
    # the object's poses, from source view 64 (one 16,384-ray chunk a frame)
    video = {}
    for traj, n in VIDEO_FRAMES.items():
        out = os.path.join(tmp, f"video_{traj}")
        argv = common + ["-F", "srn", "-D", data, "-P", str(SRN_SOURCE), "--num_views", str(n), "--traj", traj,
                         "-O", out]
        frames, lines, seconds, got = run_app(gen_video, argv)
        chunk = int(parse_args(gen_video.extra_args, argv=argv)[0].ray_batch_size)
        expect = {**none, "gather_bilerp_field": 2 * n * -(-IMAGE * IMAGE // chunk)}
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
        launches["gather_bilerp_field"] += got["gather_bilerp_field"]
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
    # 2b. the same frame with the feature stage composed around kernel A
    # (the path before the field instance), float32: the x and latent rows
    # move by the camera rotation's rounding alone (~1e-5 of their values
    # at most, tests/test_torch_kernels.py), and the float32 field keeps
    # that size
    renderer = FullRenderer(net, cfg, ray_chunk=args.ray_batch_size)
    rgb_f, depth_f = renderer.render_image(enc, rays, torch.Generator(device=dev).manual_seed(9))
    with separate_feature_stage():
        rgb_s, depth_s = renderer.render_image(enc, rays, torch.Generator(device=dev).manual_seed(9))
    err_s = {"rgb": (rgb_f - rgb_s).abs().max().item(), "depth": (depth_f - depth_s).abs().max().item()}
    tol_s = {"rgb": 1e-4, "depth": 1e-4 * (test_set.z_far - test_set.z_near)}
    res["frame_field_vs_separate"] = {"max_abs_err": err_s, "tolerance": tol_s}
    if any(err_s[k] > tol_s[k] for k in tol_s):
        raise AssertionError(f"apps_workflow: the f32 frame through the field instance differs from the "
                             f"separate stage's: {err_s}")

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
    expect = {**none, "gather_bilerp_field": 2 * 2 * REAL_VIEWS * -(-IMAGE * IMAGE // chunk)}
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
    launches["gather_bilerp_field"] += got["gather_bilerp_field"]

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


# mesh extraction (apps.recon) on srn_workflow's checkpoint and fixture:
# the grid's resolution, the probe grid that picks the level, the view the
# OBJ is rasterized to
RECON_RESO = 128
RECON_PROBE_RESO = 32
RECON_PERCENTILE = 95.0
RECON_CHUNK = 65536


# tools phase: the port's user tools on the card's host, in a temporary
# directory: 6 scenes x 8 views of 64^2 for the multi-object dataset, two
# snapshots of a 2 + 2 step run, two cube models for the OBJ renderer
TOOLS_SCENES, TOOLS_VIEWS, TOOLS_IMAGE = 6, 8, 64
TOOLS_MESH_SCENES, TOOLS_MESH_VIEWS = 2, 4
# values of each photo that may differ from raw/photo*.png by one level
PHOTO_DIFF_ALLOWANCE = 100


def write_cube_model(model_dir, color):
    """A ShapeNet-layout model: ``models/model_normalized.obj``, a unit
    cube of six quads, and its .mtl with one diffuse colour."""
    os.makedirs(os.path.join(model_dir, "models"), exist_ok=True)
    with open(os.path.join(model_dir, "models", "cube.mtl"), "w") as f:
        f.write(f"newmtl m\nKd {color[0]} {color[1]} {color[2]}\n")
    verts = [(-1, -1, -1), (1, -1, -1), (1, 1, -1), (-1, 1, -1), (-1, -1, 1), (1, -1, 1), (1, 1, 1), (-1, 1, 1)]
    quads = [(1, 2, 3, 4), (5, 8, 7, 6), (1, 5, 6, 2), (2, 6, 7, 3), (3, 7, 8, 4), (5, 1, 4, 8)]
    with open(os.path.join(model_dir, "models", "model_normalized.obj"), "w") as f:
        f.write("mtllib cube.mtl\nusemtl m\n")
        f.writelines(f"v {x} {y} {z}\n" for x, y, z in verts)
        f.writelines("f " + " ".join(str(i) for i in q) + "\n" for q in quads)


def run_tools(dev):
    """The port's user tools (``scripts/*_torch.py``) on the card's host,
    each step timed: ``make_multi_obj_dataset_torch`` read by the port's
    ``MultiObjectDataset``; ``apps.train -F multi_obj`` on it for 2 + 2
    batches (the second run resumed; kernels C and C-bwd, its eval and
    visual through A) with ``snapshot_watcher_torch``'s rule snapshotting
    the live checkpoint after each run; ``quality_curve_torch`` over the
    snapshots and the live file (``eval_approx`` through A);
    ``export_demo_checkpoint_torch`` (bf16, no optimizer) and
    ``eval_approx`` on its output (A); ``render_shapenet_objs_torch
    --backend software`` on two cube models read by ``MultiObjectDataset``;
    ``make_real_layout_fixtures_torch`` (SRN, DTU, NMR) read by the three
    readers; ``make_real_input_torch`` held to the committed
    ``raw/photo*.png`` (differing values counted). Launch counts are set to
    0 before each app and read after it."""
    import contextlib
    import io

    import numpy as np

    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import export_demo_checkpoint_torch
    import make_multi_obj_dataset_torch
    import make_real_input_torch
    import make_real_layout_fixtures_torch
    import quality_curve_torch
    import render_shapenet_objs_torch
    import snapshot_watcher_torch

    from pixelnerf_tpu_torch.apps import eval_approx
    from pixelnerf_tpu_torch.apps import train as train_app
    from pixelnerf_tpu_torch.apps.train import VIS_RAY_CHUNK
    from pixelnerf_tpu_torch.data import DVRDataset, MultiObjectDataset, SRNDataset
    from pixelnerf_tpu_torch.train.state import CKPT_NAME
    from pixelnerf_tpu_torch.utils import png

    os.environ["PIXELNERF_NO_TB"] = "1"
    seconds, res, wrong = {}, {"phase": "tools"}, []

    def quiet(fn, *args):
        with contextlib.redirect_stdout(io.StringIO()):
            return fn(*args)

    def expect(step, launches, want):
        res[step]["launches"], res[step]["expected_launches"] = launches, want
        if launches != want:
            wrong.append(f"{step}: launch counts {launches} != expected {want}")

    none = {"gather_bilerp": 0, "gather_bilerp_field": 0, "gather_rows_lerp": 0, "gather_rows_lerp_bwd": 0,
            "fused_resnetfc_infer": 0, "fused_gather_resnetfc_infer": 0}
    with tempfile.TemporaryDirectory() as tmp:
        # 1. the multi-object dataset, read back
        data = os.path.join(tmp, "multi")
        t0 = time.time()
        quiet(make_multi_obj_dataset_torch.main, ["--out", data, "--scenes", str(TOOLS_SCENES), "--views",
                                                  str(TOOLS_VIEWS), "--size", str(TOOLS_IMAGE)])
        seconds["make_multi_obj_dataset"] = time.time() - t0
        t0 = time.time()
        item = MultiObjectDataset(data, stage="train")[0]
        seconds["multi_obj_item"] = time.time() - t0
        res["make_multi_obj_dataset"] = {"splits": {s: len(os.listdir(os.path.join(data, s)))
                                                    for s in ("train", "val", "test")},
                                         "item_images": list(item["images"].shape)}
        if item["images"].shape != (TOOLS_VIEWS, TOOLS_IMAGE, TOOLS_IMAGE, 3) or not np.isfinite(item["images"]).all():
            raise AssertionError(f"tools: multi-object item {res['make_multi_obj_dataset']}")

        # 2. train on it, 2 batches, then 2 more resumed; a snapshot after each run
        conf = os.path.join(REPO, "conf", "exp", "multi_obj.conf")
        ck = os.path.join(tmp, "ck")
        live = os.path.join(ck, "tools", CKPT_NAME)
        argv = ["-n", "tools", "-c", conf, "-F", "multi_obj", "-D", data, "--device", str(dev),
                "--checkpoints_path", ck, "-B", "2", "-V", "1", "--epochs", "1", "--epoch_batches", "2",
                "--workers", "1", "--logs_path", os.path.join(tmp, "logs"), "--visual_path", os.path.join(tmp, "vis")]
        last_snap = -2
        res["train"] = {"steps": [], "losses": [], "snapshot_steps": []}
        launches_sum = dict(none)
        for run in range(2):
            trainer, lines, seconds[f"train_{run}"], launches = run_app(train_app, argv + ["--resume"] * run)
            res["train"]["steps"].append(trainer.step)
            res["train"]["losses"] += [float(l.split(" t:")[1].split()[0]) for l in lines if l.startswith("E")]
            for k in launches_sum:
                launches_sum[k] += launches[k]
            t0 = time.time()
            last_snap = quiet(snapshot_watcher_torch.snapshot_if_due, live, last_snap, 2)
            seconds[f"snapshot_{run}"] = time.time() - t0
            res["train"]["snapshot_steps"].append(last_snap)
        vis = 2 * -(-TOOLS_IMAGE * TOOLS_IMAGE // VIS_RAY_CHUNK)
        expect("train", launches_sum, {**none, "gather_rows_lerp": 2 * 4, "gather_rows_lerp_bwd": 2 * 4,
                                       "gather_bilerp_field": 2 * (2 + vis)})
        snaps = sorted(f for f in os.listdir(os.path.dirname(live)) if "_step" in f)
        res["train"]["snapshots"] = snaps
        if (res["train"]["steps"] != [2, 4] or snaps != ["train_state_step2.pt", "train_state_step4.pt"]
                or not all(math.isfinite(v) for v in res["train"]["losses"])):
            raise AssertionError(f"tools: train and snapshots {res['train']}")

        # 3. the quality curve over the two snapshots and the live file
        approx = ["-c", conf, "-F", "multi_obj", "-D", data, "-P", "0", "-B", "1", "--device", str(dev)]
        curve, _, seconds["quality_curve"], launches = run_app(
            quality_curve_torch, ["-n", "tools", "--checkpoints_path", ck] + approx)
        res["quality_curve"] = {"curve": curve}
        expect("quality_curve", launches, {**none, "gather_bilerp_field": 2 * 3})
        if [p["step"] for p in curve] != [2, 4, 4] or not all(math.isfinite(p["psnr"]) for p in curve):
            raise AssertionError(f"tools: quality curve {curve}")

        # 4. the exported bf16 checkpoint, and eval_approx on it
        demo = os.path.join(tmp, "demo")
        t0 = time.time()
        quiet(export_demo_checkpoint_torch.main, ["--src", os.path.dirname(live), "--dst", os.path.join(demo, "tools")])
        seconds["export_demo_checkpoint"] = time.time() - t0
        sizes = [os.path.getsize(live), os.path.getsize(os.path.join(demo, "tools", CKPT_NAME))]
        approx_demo, lines, seconds["eval_approx_demo"], launches = run_app(
            eval_approx, ["-n", "tools", "--checkpoints_path", demo] + approx)
        res["export_demo_checkpoint"] = {"bytes": sizes, "ratio": sizes[1] / sizes[0],
                                         "psnr_ssim": approx_demo, "live_psnr": curve[-1]["psnr"]}
        expect("export_demo_checkpoint", launches, {**none, "gather_bilerp_field": 2})
        if sizes[1] * 5 > sizes[0] or approx_demo is None or not all(math.isfinite(v) for v in approx_demo) \
                or not any(l.startswith("Loaded checkpoint at step 4") for l in lines):
            raise AssertionError(f"tools: export {res['export_demo_checkpoint']}")

        # 5. OBJ meshes through the software rasterizer, read back
        src, out = os.path.join(tmp, "shapenet"), os.path.join(tmp, "shapenet_ds")
        for i, col in enumerate([(0.8, 0.2, 0.1), (0.1, 0.4, 0.9)]):
            write_cube_model(os.path.join(src, f"model{i:02d}"), col)
        t0 = time.time()
        quiet(render_shapenet_objs_torch.main, [
            "--backend", "software", "--src", src, "--out", out, "--split", "train", "--n_scenes",
            str(TOOLS_MESH_SCENES), "--n_objects", "2", "--n_views", str(TOOLS_MESH_VIEWS), "--size",
            str(TOOLS_IMAGE), "--val_frac", "0", "--test_frac", "0", "--render_depth", "--render_alpha"])
        seconds["render_shapenet_objs"] = time.time() - t0
        mesh_item = MultiObjectDataset(out, stage="train")[0]
        res["render_shapenet_objs"] = {"ms_per_view": seconds["render_shapenet_objs"] * 1e3
                                       / (TOOLS_MESH_SCENES * TOOLS_MESH_VIEWS),
                                       "item_images": list(mesh_item["images"].shape),
                                       "object_share": float((mesh_item["images"] < 0.99).any(-1).mean())}
        if mesh_item["images"].shape != (TOOLS_MESH_VIEWS, TOOLS_IMAGE, TOOLS_IMAGE, 3) \
                or not 0 < res["render_shapenet_objs"]["object_share"] < 1:
            raise AssertionError(f"tools: shapenet {res['render_shapenet_objs']}")

        # 6. the SRN, DTU and NMR layouts, read by their readers
        layouts = os.path.join(tmp, "layouts")
        t0 = time.time()
        for fmt in ("srn", "dtu", "nmr"):
            quiet(make_real_layout_fixtures_torch.main, ["--out", layouts, "--format", fmt, "--objs", "2",
                                                        "--views", "3", "--size", "32"])
        seconds["make_real_layout_fixtures"] = time.time() - t0
        items = {"srn": SRNDataset(os.path.join(layouts, "cars"), stage="train", image_size=(32, 32))[0],
                 "dtu": DVRDataset(os.path.join(layouts, "rs_dtu_4"), stage="train", list_prefix="new_",
                                   sub_format="dtu", scale_focal=False, z_near=0.1, z_far=5.0)[0],
                 "nmr": DVRDataset(layouts, stage="train", list_prefix="softras_")[0]}
        res["make_real_layout_fixtures"] = {k: list(v["images"].shape) for k, v in items.items()}
        if res["make_real_layout_fixtures"] != {"srn": [3, 32, 32, 3], "dtu": [3, 32, 42, 3], "nmr": [3, 32, 32, 3]}:
            raise AssertionError(f"tools: layouts {res['make_real_layout_fixtures']}")

        # 7. the photo-like inputs against the committed ones
        res["make_real_input"] = {}
        for i in (1, 2):
            t0 = time.time()
            photo = make_real_input_torch.make_photo(seed=i)
            seconds[f"make_real_input_{i}"] = time.time() - t0
            diff = np.abs(photo.astype(int) - png.imread(os.path.join(REPO, "raw", f"photo{i}.png")))
            res["make_real_input"][f"photo{i}"] = {"differing_values": int((diff > 0).sum()),
                                                   "max_level_diff": int(diff.max())}
    res["seconds"] = seconds
    res["launches"] = {k: sum(res[s]["launches"][k] for s in ("train", "quality_curve", "export_demo_checkpoint"))
                       for k in ("gather_bilerp", "gather_bilerp_field", "gather_rows_lerp", "gather_rows_lerp_bwd")}
    res["card"] = nvidia_smi_line()
    emit(res)
    if wrong:
        raise AssertionError("tools: " + "; ".join(wrong))
    # the photos: equal on the CPU tests; another host's numpy may round a
    # float32 exp or a matrix product differently
    for name, d in res["make_real_input"].items():
        if d["max_level_diff"] > 1 or d["differing_values"] > PHOTO_DIFF_ALLOWANCE:
            raise AssertionError(f"tools: make_real_input {name} differs from raw/{name}.png: {d}")
    return res


def run_recon(dev, tmp):
    """``apps.recon`` on the card, on ``srn_workflow``'s fixture and
    checkpoint in ``tmp`` (the SRN model at full width, f32): a level from
    the library's ``eval_sigma_grid`` at 32^3 (its 95th percentile, so that
    the mesh of a briefly trained model is not empty), then the app at
    ``--reso 128`` (2,097,152 points, 32 queries of 65,536, each one launch
    of kernel A; then one launch per 65,536 vertices for the colours);
    its grid, surface, colour and write times; the mesh's counts and index
    range; its OBJ read back with the port's ``load_obj`` and rasterized to
    one 128x128 view; one grid chunk through kernel A held to the same
    chunk through its plain version."""
    import contextlib
    import io

    import numpy as np

    from pixelnerf_tpu_torch.apps import recon
    from pixelnerf_tpu_torch.apps.args import parse_args
    from pixelnerf_tpu_torch.apps.eval import load_net_and_state
    from pixelnerf_tpu_torch.data import dataset_kwargs_from_conf, get_split_dataset
    from pixelnerf_tpu_torch.utils import mesh_raster
    from pixelnerf_tpu_torch.utils.recon import eval_sigma_grid, grid_points

    smi = nvidia_smi_line()
    data = os.path.join(tmp, "data", "cars")
    out = os.path.join(tmp, "mesh_out")
    argv = ["-c", os.path.join(REPO, "conf", "exp", "srn.conf"), "-F", "srn", "-D", data, "--device", str(dev),
            "--checkpoints_path", os.path.join(tmp, "ck"), "-P", str(SRN_SOURCE), "--subset", "0"]
    args, conf = parse_args(recon.extra_args, argv=argv)
    dset = get_split_dataset("srn", data, want_split=args.split, training=False, **dataset_kwargs_from_conf(conf))
    d = dset[0]
    with contextlib.redirect_stdout(io.StringIO()):
        net = load_net_and_state(args, conf, dev)
    with torch.inference_mode():
        enc = net.encode(torch.from_numpy(d["images"][None, [SRN_SOURCE]]).to(dev),
                         torch.from_numpy(d["poses"][None, [SRN_SOURCE]]).to(dev), torch.as_tensor(d["focal"]),
                         c=torch.from_numpy(d["c"][None]))

        def query(xyz, viewdirs, coarse, use_kernels=True):
            return net.query(enc, xyz, viewdirs, coarse=coarse, use_kernels=use_kernels)

        probe = eval_sigma_grid(query, (RECON_PROBE_RESO,) * 3, (-1.0, 1.0), device=dev)
    level = float(np.percentile(probe, RECON_PERCENTILE))
    emit({"phase": "recon_level", "probe_reso": RECON_PROBE_RESO, "percentile": RECON_PERCENTILE, "level": level,
          "probe_sigma_range": [float(probe.min()), float(probe.max())]})

    res, lines, seconds, got = run_app(recon, argv + ["--reso", str(RECON_RESO), "--isosurface", repr(level),
                                                      "-O", out])
    verts, faces = res["verts"], res["faces"]
    n_grid = -(-RECON_RESO ** 3 // RECON_CHUNK)
    expect = {k: 0 for k in got}
    expect["gather_bilerp_field"] = n_grid + -(-len(verts) // RECON_CHUNK)
    rec = {"phase": "recon", "model": "conf/exp/srn.conf, float32", "reso": RECON_RESO, "points": RECON_RESO ** 3,
           "queries": n_grid, "level": level, "vertices": len(verts), "faces": len(faces),
           "ms": res["ms"], "app_seconds": seconds, "obj_bytes": os.path.getsize(res["path"]),
           "launches": got, "expected_launches": expect, "printed": lines[-2:], "card": smi}
    if got != expect:
        raise AssertionError(f"recon: launch counts {got} != expected {expect}")
    if not (len(verts) and len(faces)) or faces.min() < 0 or faces.max() >= len(verts):
        raise AssertionError(f"recon: an empty mesh or a face index out of range: {rec}")
    if not (np.isfinite(verts).all() and np.isfinite(res["colors"]).all()):
        raise AssertionError("recon: non-finite vertices or colours")

    # the OBJ read back and rasterized from the object's first view
    t0 = time.perf_counter()
    v, f, c = mesh_raster.load_obj(res["path"])
    rec["load_obj_ms"] = (time.perf_counter() - t0) * 1e3
    if not (np.array_equal(v, verts) and np.array_equal(f, faces)):
        raise AssertionError("recon: the OBJ does not read back to the mesh the app made")
    t0 = time.perf_counter()
    rgb, depth, alpha = mesh_raster.rasterize(v, f, c, d["poses"][0], IMAGE, IMAGE, float(np.mean(d["focal"])))
    rec["rasterize_ms"] = (time.perf_counter() - t0) * 1e3
    rec["rasterized_pixels"] = int(alpha.sum())
    if not alpha.any():
        raise AssertionError(f"recon: the rasterized view covers no pixel: {rec}")

    # one grid chunk (the middle one) through kernel A and through its plain version
    pts = torch.from_numpy(grid_points((RECON_RESO,) * 3, (-1.0, 1.0))[None, n_grid // 2 * RECON_CHUNK:
                                                                        (n_grid // 2 + 1) * RECON_CHUNK]).to(dev)
    dirs = torch.zeros_like(pts)
    with torch.inference_mode():
        k_out = query(pts, dirs, True)
        p_out = query(pts, dirs, True, use_kernels=False)
    err = (k_out - p_out).abs().max().item()
    rec["chunk_kernel_vs_plain"] = {"points": RECON_CHUNK, "max_abs_err": err, "tolerance": 1e-6}
    if err > 1e-6 or not torch.isfinite(k_out).all():
        raise AssertionError(f"recon: the grid chunk through kernel A differs from plain: {err}")
    emit(rec)
    return rec


def run_preproc(dev, tmp):
    """``apps.preproc --backend grabcut`` on the committed 420x420 photos
    ``raw/photo1.png`` and ``raw/photo2.png``, GrabCut's per-pixel work on
    the card, then the same app with ``--cpu``: the card's
    ``*_normalize.png`` held to the CPU's (equal, or a foreground IoU of
    at least 0.99 with the count of differing pixels printed, where the
    float64 densities round differently on the two devices); per photo the
    ms of each step (read, each GrabCut pass's per-pixel work and host cut,
    cleanup, ellipse, resize, write), the mask's foreground share, the
    ellipse and the crop radius; a non-empty mask and a 128x128x3 output
    with white and non-white pixels. Then ``apps.eval_real --debug_nans``
    on the card's outputs (the SRN workflow's checkpoint in ``tmp``, f32,
    ``REAL_VIEWS`` views each; kernel A, its launches counted). The photos
    are ``raw/photo1.png``, ``raw/photo2.png``, the committed JPEG of photo1
    and a PNG of that JPEG's expected decode: the JPEG's outputs (card and
    CPU) must equal the decoded PNG's. Last, ``apps.eval_real`` on the
    420x420 JPEG itself (``read_input`` decodes and area-resizes it, equal
    to its decoded PNG's array; kernel A, its launches counted)."""
    import shutil

    import numpy as np

    from pixelnerf_tpu_torch.apps import eval_real, preproc
    from pixelnerf_tpu_torch.apps.args import parse_args
    from pixelnerf_tpu_torch.utils import png

    smi = nvidia_smi_line()
    raw = os.path.join(tmp, "preproc_raw")
    os.makedirs(raw)
    for name in PREPROC_PHOTOS[:2]:
        shutil.copy(os.path.join(REPO, "raw", name), raw)
    jpg = os.path.join(raw, PREPROC_PHOTOS[2])
    shutil.copy(os.path.join(JPEG_FIXTURES, "photo1.jpg"), jpg)
    png.imwrite(os.path.join(raw, PREPROC_PHOTOS[3]), np.load(os.path.join(JPEG_FIXTURES, "expected.npz"))["photo1"])
    outs = {"card": os.path.join(tmp, "preproc_card"), "cpu": os.path.join(tmp, "preproc_cpu")}
    runs = {}
    for where, flags in (("card", ["--device", str(dev)]), ("cpu", ["--cpu"])):
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        report, _, seconds, got = run_app(preproc, ["--input", raw, "--output", outs[where], "--backend",
                                                    "grabcut", "--size", str(IMAGE)] + flags)
        runs[where] = {"report": report, "seconds": seconds, "launches": got,
                       "peak_memory_mb": (torch.cuda.max_memory_allocated() - before) / 1e6}
        if any(got.values()):
            raise AssertionError(f"preproc ({where}) launched a kernel: {got}")
    # the card's run works on the card, the CPU's does not touch it
    if runs["card"]["peak_memory_mb"] <= 0 or runs["cpu"]["peak_memory_mb"] != 0:
        raise AssertionError(f"preproc: device memory of the card's and the CPU's runs: "
                             f"{[runs[w]['peak_memory_mb'] for w in runs]} MB")
    for name in PREPROC_PHOTOS:
        path = os.path.join(raw, name)
        base = os.path.splitext(name)[0] + "_normalize.png"
        card, cpu = (png.imread(os.path.join(outs[w], base)) for w in ("card", "cpu"))
        rep = runs["card"]["report"][path]
        fg_card, fg_cpu = np.any(card < 255, -1), np.any(cpu < 255, -1)
        iou = float((fg_card & fg_cpu).sum() / max((fg_card | fg_cpu).sum(), 1))
        rec = {"phase": "preproc", "photo": name, "card": smi, "ms_card": rep["ms"],
               "ms_cpu": runs["cpu"]["report"][path]["ms"], "foreground": rep["foreground"],
               "ellipse_center": rep["center"], "ellipse_axes": rep["axes"], "crop_radius": rep["radius"],
               "foreground_cpu": runs["cpu"]["report"][path]["foreground"],
               "differing_pixels_card_vs_cpu": int(np.any(card != cpu, -1).sum()), "foreground_iou": iou,
               "output_shape": list(card.shape), "app_seconds": {w: runs[w]["seconds"] for w in runs},
               "peak_memory_mb_card": runs["card"]["peak_memory_mb"]}
        emit(rec)
        if not rep["foreground"] > 0:
            raise AssertionError(f"preproc {name}: an empty mask")
        if card.shape != (IMAGE, IMAGE, 3) or not (card == 255).all(-1).any() or fg_card.sum() == 0:
            raise AssertionError(f"preproc {name}: the output is not a 128x128x3 white composite: {rec}")
        if iou < 0.99:
            raise AssertionError(f"preproc {name}: the card's output differs from the CPU's: {rec}")
    # the JPEG photo's outputs are its decode's
    for where in outs:
        a, b = (png.imread(os.path.join(outs[where], os.path.splitext(n)[0] + "_normalize.png"))
                for n in PREPROC_PHOTOS[2:])
        emit({"phase": "preproc_jpeg_vs_decoded_png", "where": where, "differing_pixels": int(np.any(a != b, -1).sum())})
        if not np.array_equal(a, b):
            raise AssertionError(f"preproc ({where}): the JPEG photo's output differs from its decoded PNG's")

    out = os.path.join(tmp, "preproc_real_out")
    argv = ["-c", os.path.join(REPO, "conf", "exp", "srn.conf"), "--device", str(dev), "--checkpoints_path",
            os.path.join(tmp, "ck"), "--input", outs["card"], "--size", str(IMAGE), "--num_views",
            str(REAL_VIEWS), "--debug_nans", "-O", out]
    _, lines, seconds, got = run_app(eval_real, argv)
    chunk = int(parse_args(eval_real.extra_args, argv=argv)[0].ray_batch_size)
    expect = {k: 0 for k in got}
    expect["gather_bilerp_field"] = 2 * len(PREPROC_PHOTOS) * REAL_VIEWS * -(-IMAGE * IMAGE // chunk)
    frames = [png.imread(os.path.join(out, f"{os.path.splitext(n)[0]}_normalize_frames", f"{i:04}.png"))
              for n in PREPROC_PHOTOS for i in range(REAL_VIEWS)]
    rec = {"phase": "preproc_eval_real", "card": smi, "seconds": seconds,
           "ms_per_view_app": seconds * 1e3 / (len(PREPROC_PHOTOS) * REAL_VIEWS), "launches": got,
           "expected_launches": expect, "printed": lines}
    emit(rec)
    if got != expect:
        raise AssertionError(f"preproc eval_real: launch counts {got} != expected {expect}")
    if not all(f.shape == (IMAGE, IMAGE, 3) and f.std() > 0 for f in frames):
        raise AssertionError("preproc eval_real: degenerate frames")
    launches = dict(got)

    # eval_real on the 420x420 JPEG photo itself, area-resized to IMAGE
    if not np.array_equal(eval_real.read_input(jpg, IMAGE),
                          eval_real.read_input(os.path.join(raw, PREPROC_PHOTOS[3]), IMAGE)):
        raise AssertionError("eval_real: read_input of the JPEG differs from its decoded PNG's")
    out = os.path.join(tmp, "jpeg_real_out")
    at = argv.index("--input")
    argv = argv[:at] + ["--input", jpg] + argv[at + 2 : -1] + [out]
    _, lines, seconds, got = run_app(eval_real, argv)
    expect = {k: 0 for k in got}
    expect["gather_bilerp_field"] = 2 * REAL_VIEWS * -(-IMAGE * IMAGE // chunk)
    base = os.path.splitext(PREPROC_PHOTOS[2])[0]
    frames = [png.imread(os.path.join(out, f"{base}_frames", f"{i:04}.png")) for i in range(REAL_VIEWS)]
    emit({"phase": "eval_real_jpeg", "card": smi, "input": PREPROC_PHOTOS[2], "seconds": seconds,
          "ms_per_view_app": seconds * 1e3 / REAL_VIEWS, "launches": got, "expected_launches": expect,
          "printed": lines})
    if got != expect:
        raise AssertionError(f"eval_real on a JPEG: launch counts {got} != expected {expect}")
    if not all(f.shape == (IMAGE, IMAGE, 3) and f.std() > 0 for f in frames):
        raise AssertionError("eval_real on a JPEG: degenerate frames")
    launches["gather_bilerp_field"] += got["gather_bilerp_field"]
    return {"runs": runs, "launches": launches}


def run_parallel(dev, net, cfg, enc, pose):
    """The multi-GPU layer at world size 1 on this card: a process group
    over NCCL (a ``file://`` store in a temporary directory), ``make_mesh()``
    of shape 1 x 1, ``make_sharded_render(fast=True)`` and
    ``FullRenderer(mesh=)`` on one 128x128 request of the SRN model in bf16,
    each bit-equal to ``FullRenderer`` on the same draws, and one train
    step of config (a) with ``mesh=`` bit-equal, in every parameter, to the
    same step without it; the group destroyed after. One card measures no
    scaling: the collectives run over one rank."""
    import torch.distributed as dist

    from pixelnerf_tpu_torch.eval import FullRenderer
    from pixelnerf_tpu_torch.parallel import make_mesh, make_sharded_render, shard_batch, shard_rays
    from pixelnerf_tpu_torch.render import draw_noise
    from pixelnerf_tpu_torch.train import make_render_loss, make_train_step
    from pixelnerf_tpu_torch.utils import geometry

    smi = nvidia_smi_line()
    counters = {**inference_kernels(), **train_kernels()}
    rec = {"phase": "parallel", "world_size": 1, "backend": "nccl", "card": smi}
    with tempfile.TemporaryDirectory() as store:
        dist.init_process_group("nccl", init_method=f"file://{os.path.join(store, 'store')}", rank=0,
                                world_size=1)
        try:
            mesh = make_mesh()
            rec["mesh"] = dict(mesh.shape)
            if rec["mesh"] != {"data": 1, "ray": 1}:
                raise AssertionError(f"parallel: mesh {rec['mesh']}")

            # one request: the sharded render and FullRenderer(mesh=) against FullRenderer
            rays = geometry.gen_rays(pose[None], IMAGE, IMAGE, FOCAL, NEAR, FAR, device=dev).reshape(1, -1, 8)
            noise = draw_noise(rays, cfg, torch.Generator(device=dev).manual_seed(12))
            sharded = make_sharded_render(net, cfg, mesh, fast=True, staged=True)
            renders, ms, launches = {}, {}, {}
            for name, fn in (
                ("full_renderer", lambda: FullRenderer(net, cfg, ray_chunk=RAY_CHUNK, fast=True)
                 .render_batch(enc, rays, noise=[noise])),
                ("sharded_render", lambda: sharded(enc, shard_rays(mesh, rays), noise=noise)),
                ("full_renderer_mesh", lambda: FullRenderer(net, cfg, ray_chunk=RAY_CHUNK, fast=True, mesh=mesh)
                 .render_batch(enc, rays, noise=[noise])),
            ):
                # twice: the first call of the sharded render also sets up
                # NCCL's communicator
                for c in counters.values():
                    c.launches = 0
                ms[name] = []
                for _ in range(2):
                    torch.cuda.synchronize()
                    t0 = time.time()
                    renders[name] = fn()
                    torch.cuda.synchronize()
                    ms[name].append((time.time() - t0) * 1e3)
                launches[name] = {k: c.launches for k, c in counters.items()}
            ref = renders["full_renderer"]
            errs = {name: max((out[b][k].float() - ref[b][k].float()).abs().max().item()
                              for b in ref for k in ref[b]) for name, out in renders.items()}
            rec["render"] = {"rays": rays.shape[1], "ms": ms, "max_abs_err": errs, "tolerance": 0.0,
                             "launches": launches}
            expect = {k: 0 for k in counters}
            expect.update({"gather_bilerp_field": 2 * 2, "fused_resnetfc_infer": 2 * 3})
            if any(v != expect for v in launches.values()):
                raise AssertionError(f"parallel: render launch counts {launches} != {expect} each")
            if any(errs.values()):
                raise AssertionError(f"parallel: the sharded render differs from FullRenderer: {errs}")

            # one step of train config (a) with and without the mesh, from one
            # state, batch and draw seed; cuDNN's deterministic algorithms, as
            # its default backward convolutions sum in an order that varies
            # between calls (two steps without a mesh differ in the encoder)
            params, metrics, step_ms = {}, {}, {}
            deterministic = torch.backends.cudnn.deterministic
            torch.backends.cudnn.deterministic = True
            for name in ("plain", "mesh"):
                tnet, tcfg, tconf, batches = train_setup(dev, "a")
                opt = torch.optim.Adam(tnet.parameters(), lr=TRAIN_LR, betas=(0.9, 0.999), eps=1e-8)
                step = make_train_step(tnet, tcfg, opt, make_render_loss(tconf["loss"]),
                                       mesh=mesh if name == "mesh" else None)
                batch = shard_batch(mesh, batches[0]) if name == "mesh" else batches[0]
                for c in counters.values():
                    c.launches = 0
                torch.cuda.synchronize()
                t0 = time.time()
                m = step(batch, generator=torch.Generator(device=dev).manual_seed(13))
                torch.cuda.synchronize()
                step_ms[name] = (time.time() - t0) * 1e3
                launches[f"train_{name}"] = {k: c.launches for k, c in counters.items()}
                metrics[name] = {k: v.item() for k, v in m.items()}
                params[name] = {k: v.detach().clone() for k, v in tnet.state_dict().items()}
            torch.backends.cudnn.deterministic = deterministic
            unequal = [k for k in params["plain"] if not torch.equal(params["plain"][k], params["mesh"][k])]
            per_step = train_launches_per_step()["a"]
            expect_train = {k: 0 for k in counters}
            expect_train.update({"gather_rows_lerp": per_step, "gather_rows_lerp_bwd": per_step})
            rec["train"] = {"config": "a", "step_ms": step_ms, "metrics": metrics, "unequal_tensors": unequal,
                            "tensors": len(params["plain"]), "launches": launches["train_mesh"]}
            if launches["train_mesh"] != expect_train or launches["train_plain"] != expect_train:
                raise AssertionError(f"parallel: train launch counts {launches} != {expect_train}")
            if unequal or metrics["plain"] != metrics["mesh"]:
                raise AssertionError(f"parallel: the step with mesh= differs from the step without: {rec['train']}")
        finally:
            dist.destroy_process_group()
    rec["launches"] = {k: launches["sharded_render"][k] + launches["full_renderer_mesh"][k] + launches["train_mesh"][k]
                       for k in counters}
    emit(rec)
    return rec


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


def write_jpeg_nmr_objects(root):
    """Two NMR-layout objects (``-F dvr``) alike but for their views: one
    whose ``image/*.jpg`` are the committed ``tests/fixtures/jpeg/nmr_*.jpg``
    (64x64), one whose ``image/*.png`` are their expected decodes written by
    the port's PNG writer; the same PNG masks and cameras. Returns their
    ``-D`` paths."""
    import glob
    import shutil

    import numpy as np

    from pixelnerf_tpu_torch.utils import png

    expected = np.load(os.path.join(JPEG_FIXTURES, "expected.npz"))
    views = sorted(glob.glob(os.path.join(JPEG_FIXTURES, "nmr_*.jpg")))
    world = np.array([[1, 0, 0, 0], [0, 0, -1, 0], [0, 1, 0, 0], [0, 0, 0, 1]], np.float64)
    cam = np.diag([1.0, -1.0, -1.0, 1.0])
    yy, xx = np.mgrid[:64, :64]
    paths = {}
    for kind in ("jpeg", "decoded"):
        top = os.path.join(root, f"nmr_{kind}")
        obj = os.path.join(top, "02958343", "obj0")
        os.makedirs(os.path.join(obj, "image"))
        os.makedirs(os.path.join(obj, "mask"))
        cams = {}
        for v, src in enumerate(views):
            if kind == "jpeg":
                shutil.copy(src, os.path.join(obj, "image", f"{v:04d}.jpg"))
            else:
                png.imwrite(os.path.join(obj, "image", f"{v:04d}.png"),
                            expected[os.path.splitext(os.path.basename(src))[0]])
            disc = (xx - 32 - v) ** 2 + (yy - 30) ** 2 < 18 ** 2
            png.imwrite(os.path.join(obj, "mask", f"{v:04d}.png"), disc.astype(np.uint8) * 255)
            c2w = _orbit_pose(v, len(views), 2.7, 0.9)
            cams[f"world_mat_{v}"] = np.linalg.inv(np.linalg.inv(world) @ c2w @ np.linalg.inv(cam)).astype(np.float32)
            cams[f"camera_mat_{v}"] = np.diag([1.75, 1.75, 1.0, 1.0]).astype(np.float32)
        np.savez(os.path.join(obj, "cameras.npz"), **cams)
        with open(os.path.join(top, "02958343", "softras_train.lst"), "w") as f:
            f.write("obj0\n")
        paths[kind] = top
    return paths


def pull_dvr_and_multi_obj(root):
    """Pull the NMR and multi-object fixtures' items on this host through
    ``get_split_dataset`` (``-F dvr``, ``-F multi_obj``): shapes, finite
    values, host ms; the NMR object of JPEG views (``write_jpeg_nmr_objects``)
    whose item must equal, key for key and bit for bit, the item of its twin
    of decoded PNG views, with the host ms of each; and that no imaging
    library was loaded."""
    import numpy as np

    from pixelnerf_tpu_torch.data import get_split_dataset

    twins = write_jpeg_nmr_objects(root)
    items, item_ms = {}, {}
    for kind, path in twins.items():
        dset = get_split_dataset("dvr", path, "train")
        t0 = time.perf_counter()
        items[kind] = dset[0]
        item_ms[kind] = (time.perf_counter() - t0) * 1e3
    a, b = items["jpeg"], items["decoded"]
    same = set(a) == set(b) and all(
        k == "path" or (np.asarray(a[k]).dtype == np.asarray(b[k]).dtype and np.array_equal(a[k], b[k])) for k in a)
    rec = {"phase": "readers_jpeg", "card": nvidia_smi_line(), "views": int(a["images"].shape[0]),
           "image": list(a["images"].shape[1:]), "item_ms": item_ms, "equal": same}
    emit(rec)
    if not same:
        raise AssertionError(f"readers: the JPEG object's item differs from its decoded twin's: {rec}")

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
    res["jpeg_item_ms"] = item_ms
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
        expect = {"gather_rows_lerp": 2 * 2, "gather_rows_lerp_bwd": 2 * 2, "gather_bilerp": 0,
                  "gather_bilerp_field": 2 + 2 * vis_chunks, "fused_resnetfc_infer": 0,
                  "fused_gather_resnetfc_infer": 0}
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
        expect = {"gather_rows_lerp": 0, "gather_rows_lerp_bwd": 0, "gather_bilerp": 0,
                  "gather_bilerp_field": 2 * chunks, "fused_resnetfc_infer": 0, "fused_gather_resnetfc_infer": 0}
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
                       for k in ("gather_bilerp", "gather_bilerp_field", "gather_rows_lerp", "gather_rows_lerp_bwd")}
    res["launches_per"] = {"gather_bilerp_field_per_eval_view": res["eval"]["launches"]["gather_bilerp_field"] / views,
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


DTU_NEAR, DTU_FAR = 0.1, 5.0
DTU_FOCAL, DTU_C = (720.0, 718.0), (212.0, 141.0)   # fx, fy and the principal point at 400x300
DTU_RENDER_CHUNK = 40_000      # dtu.render's ray chunk
DTU_RENDER_SOURCE, DTU_RENDER_TARGET = (22, 25, 28), 10


def make_dtu_model(dev, g):
    """The DTU model (conf/exp/dtu.conf: ResNet34 to a 512-channel latent,
    ResnetFC 512 x 5 averaging its source views at block 3) in bf16 on
    ``dev``, weights from the generator ``g``. Returns (net, RenderConfig)."""
    from pixelnerf_tpu_torch.config import load_config
    from pixelnerf_tpu_torch.models import make_model
    from pixelnerf_tpu_torch.render import RenderConfig

    conf = load_config(os.path.join(REPO, "conf", "exp", "dtu.conf"))
    conf["model"]["dtype"] = "bfloat16"
    net = make_model(conf["model"], device=dev, generator=g)
    seed_field(net, g, dev)
    return net, RenderConfig.from_conf(conf["renderer"])


def run_dtu_main_path(dev, g, height=DTU_H, width=DTU_W, chunk=DTU_RENDER_CHUNK, crop_rows=(150, 156)):
    """The DTU novel-view request of ``dtu.render`` in bf16: ``encode`` of
    three 400x300 source views (22, 25, 28 of an arc), then
    ``FullRenderer(fast=True).render_image`` of one target view of 120,000
    rays in 40,000-ray chunks, staged: ``query_mlp`` -> ``ResnetFC``'s gate
    -> kernel B's multi-view mode. Every inference kernel's count is set to
    0 just before the view and read just after (kernel B: 3 launches a
    chunk, the coarse MLP and the fine MLP on the coarse and on the new
    samples' features), the spans of ``field.mlp`` held to the mode's counts
    (``kernel_b``, ``kernel_b_views`` 3 a launch, no ``dense``); the view's
    ms with the spans off, its peak memory, and a crop of ``crop_rows``
    rendered through the kernels and through their plain versions on the
    same noise."""
    import numpy as np

    from pixelnerf_tpu_torch.eval import FullRenderer
    from pixelnerf_tpu_torch.render import draw_noise
    from pixelnerf_tpu_torch.utils import geometry, profiling

    net, cfg = make_dtu_model(dev, g)
    rng = np.random.default_rng(5)
    images = np.stack([_smooth_image(rng, height, width, 3, v) for v in DTU_RENDER_SOURCE])
    images = torch.from_numpy(images).float().div(127.5).sub(1.0)[None].to(dev)
    poses = torch.stack([torch.from_numpy(_orbit_pose(v, DTU_VIEWS, 2.4, 0.8)).float()
                         for v in DTU_RENDER_SOURCE])[None].to(dev)
    focal = torch.tensor([DTU_FOCAL], device=dev)
    c = torch.tensor([DTU_C], device=dev)
    target = _orbit_pose(DTU_RENDER_TARGET, DTU_VIEWS, 2.4, 0.8)
    kernels = inference_kernels()
    fr = FullRenderer(net, cfg, ray_chunk=chunk, fast=True)
    with torch.inference_mode():
        enc = net.encode(images, poses, focal, c)
        rays = geometry.gen_rays(target[None], width, height, DTU_FOCAL, DTU_NEAR, DTU_FAR, c=DTU_C, device=dev)[0]
        fr.render_image(enc, rays, torch.Generator(device=dev).manual_seed(3))     # warm-up
        torch.cuda.synchronize()
        for fn in kernels.values():
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats()
        profiling.enable()
        try:
            rgb, depth = fr.render_image(enc, rays, torch.Generator(device=dev).manual_seed(4))
            torch.cuda.synchronize()
        finally:
            profiling.disable()
        launches = {name: fn.launches for name, fn in kernels.items()}
        spans = {}
        records = profiling.take()
        for rec in records:
            if rec.name == "field.mlp":
                for k, v in rec.counts.items():
                    if k != "rows":
                        spans[k] = spans.get(k, 0) + v
        feature_spans = field_features_counts(records)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        view_ms = time_ms(lambda: fr.render_image(enc, rays, torch.Generator(device=dev).manual_seed(4)),
                          reps=3, warmup=0)
        crop = rays[crop_rows[0]:crop_rows[1]]
        noise = [draw_noise(crop.reshape(1, -1, 8), cfg, torch.Generator(device=dev).manual_seed(6))]
        rgb_k, depth_k = fr.render_image(enc, crop, noise=noise)
        rgb_p, depth_p = FullRenderer(net, cfg, ray_chunk=chunk, fast=True, use_kernels=False).render_image(
            enc, crop, noise=noise)
        with separate_feature_stage():
            rgb_s, depth_s = fr.render_image(enc, crop, noise=noise)
    chunks = -(-height * width // chunk)
    expect = {"gather_bilerp": 0, "gather_bilerp_field": 2 * chunks, "fused_resnetfc_infer": 3 * chunks,
              "fused_gather_resnetfc_infer": 0}
    expect_spans = {"kernel_b": 3 * chunks, "kernel_b_views": 3 * 3 * chunks}
    expect_feature_spans = {"inputs_fused": 2 * chunks}
    e2e = {"rgb": (rgb_k - rgb_p).abs().max().item(), "depth": (depth_k - depth_p).abs().max().item()}
    sep = {"rgb": (rgb_k - rgb_s).abs().max().item(), "depth": (depth_k - depth_s).abs().max().item()}
    # kernel_vs_plain_e2e's tolerance for rgb; for depth, scaled from the
    # SRN scene's depth range (1.0) to this one's (4.9)
    tol = {"rgb": 2e-2, "depth": 2e-2 * (DTU_FAR - DTU_NEAR)}
    res = {
        "phase": "dtu_main_path", "config": "conf/exp/dtu.conf, bf16, 3 source views of 400x300, 64+32 samples",
        "image": [width, height], "ray_chunk": chunk, "chunks": chunks, "view_ms": view_ms,
        "rays_per_s": height * width / (view_ms / 1e3), "peak_memory_gb": peak_gb,
        "launches": launches, "expected_launches": expect, "field_mlp_spans": spans, "expected_spans": expect_spans,
        "field_features_spans": feature_spans, "expected_feature_spans": expect_feature_spans,
        "kernel_vs_plain_crop": {"rays": crop.shape[0] * crop.shape[1], "max_abs_err": e2e, "tolerance": tol},
        "field_vs_separate_crop": {"max_abs_err": sep, "tolerance": tol},
        "rgb_range": [rgb.min().item(), rgb.max().item()], "depth_range": [depth.min().item(), depth.max().item()],
        "rgb_std": rgb.float().std().item(),
    }
    emit(res)
    if spans != expect_spans:
        raise AssertionError(f"dtu_main_path: field.mlp's spans {spans} != expected {expect_spans}")
    if feature_spans != expect_feature_spans:
        raise AssertionError(f"dtu_main_path: field.features' spans {feature_spans} != {expect_feature_spans}")
    if launches != expect:
        raise AssertionError(f"dtu_main_path: launch counts {launches} != expected {expect}")
    if not (torch.isfinite(rgb).all() and torch.isfinite(depth).all() and rgb.shape == (height, width, 3)
            and rgb.min() >= 0 and rgb.max() <= 1 + 1e-5 and rgb.float().std() > 1e-3
            and depth.min() >= DTU_NEAR * (1 - 1e-3) and depth.max() <= DTU_FAR):
        raise AssertionError(f"dtu_main_path: render out of range: {res}")
    if any(e2e[k] > tol[k] for k in tol):
        raise AssertionError(f"dtu_main_path: kernel and plain renders disagree: {e2e}")
    if any(sep[k] > tol[k] for k in tol):
        raise AssertionError(f"dtu_main_path: the field instance's and the separate stage's renders disagree: {sep}")
    return res


@contextlib.contextmanager
def separate_feature_stage():
    """Inside the block every feature stage is composed in PyTorch around
    kernel A, as before kernel A's field instance took it
    (``PixelNeRFNet.fuses_inputs`` answers no): the stage that the
    instance's renders are held to."""
    from pixelnerf_tpu_torch.models.pixelnerf import PixelNeRFNet

    fuses = PixelNeRFNet.fuses_inputs
    PixelNeRFNet.fuses_inputs = lambda self, *args, **kwargs: False
    try:
        yield
    finally:
        PixelNeRFNet.fuses_inputs = fuses


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
    from pixelnerf_tpu_torch.ops.gather import gather_bilerp, gather_bilerp_field

    return {"gather_bilerp": gather_bilerp, "gather_bilerp_field": gather_bilerp_field,
            "fused_resnetfc_infer": fused_resnetfc_infer, "fused_gather_resnetfc_infer": fused_gather_resnetfc_infer}


def field_features_counts(records):
    """The ``inputs_fused`` and ``separate`` counts of the ``field.features``
    spans among ``records``: which path each feature stage took."""
    out = {}
    for r in records:
        if r.name == "field.features":
            for k in ("inputs_fused", "separate"):
                if k in r.counts:
                    out[k] = out.get(k, 0) + r.counts[k]
    return out


def run_path(phase, render, targets, dev, rgen, per_request, extra, spans_per_request=None):
    """Drive one inference path for one request per target, with every
    inference kernel's count set to 0 just before and read just after, and
    hold the counts to ``per_request`` launches per request and the
    renders to the render checks; then, with ``spans_per_request``, one
    more request with the program's spans on, its ``field.features``
    counts held to them. Returns the phase's record."""
    from pixelnerf_tpu_torch.utils import profiling

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
    spans = None
    if spans_per_request is not None:
        profiling.enable()
        try:
            run_requests(render, targets[:1], dev, rgen)
        finally:
            profiling.disable()
        spans = field_features_counts(profiling.take())
        want = {k: v * -(-IMAGE * IMAGE // RAY_CHUNK) for k, v in spans_per_request.items()}
        if spans != want:
            raise AssertionError(f"{phase}: field.features spans {spans} != expected {want}")
    steady = request_ms[1:]
    res = {
        "phase": phase, "config": "conf/exp/srn.conf, bf16, 128x128, 64+32 samples",
        "requests": len(targets), "ray_chunk": RAY_CHUNK, **extra,
        "request_ms": request_ms,
        "rays_per_s_steady": IMAGE * IMAGE * len(steady) / (sum(steady) / 1e3),
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": launches, "expected_launches": expect, "field_features_spans": spans,
        "rgb_std": [r.float().std().item() for r, _ in renders],
        "depth_range": [min(d.min().item() for _, d in renders), max(d.max().item() for _, d in renders)],
    }
    emit(res)
    return res


# ---- the model variants ----------------------------------------------------

# A's and B's launches per request of each variant's staged render (one
# 16,384-ray chunk: A gathers the coarse and the new fine samples, B runs
# the coarse MLP and the fine MLP on the cached and on the new features).
# A's field instance takes the feature stage from a 512-channel latent (the
# global encoder's vector put in front after it), A itself the custom conv
# encoder's 128-channel map (rows A serves narrower than a warp a point).
# SPADE and softplus fields, and ImplicitNet, take the dense chain (the
# kernel's gate, read from the config); the quad gather is a plain row
# gather.
VARIANT_REQUEST_LAUNCHES = {
    "global": {"gather_bilerp_field": 2, "fused_resnetfc_infer": 3},
    "custom": {"gather_bilerp": 2, "fused_resnetfc_infer": 3},
    "spade_softplus": {"gather_bilerp_field": 2},
    "implicit": {"gather_bilerp_field": 2},
    "quad": {"fused_resnetfc_infer": 3},
}
VARIANT_SETTINGS = {
    "global": "use_global_encoder, global_encoder { backbone = resnet34, latent_size = 128 }",
    "custom": "encoder.backbone = custom",
    "spade_softplus": "use_spade, beta = 10 in both MLPs, encoder.feature_scale = 0.5",
    "implicit": "both MLPs { type = mlp, dims = [512] x 5, skip_in = [3], combine_layer = 3, "
                "dim_excludes_skip = True }",
    "quad": "quad_gather = True",
}
IMPLICIT_MLP = {"type": "mlp", "dims": [512] * 5, "skip_in": [3], "combine_layer": 3, "dim_excludes_skip": True}


def variant_conf(name, dtype):
    """conf/exp/srn.conf (full width and depth) with the settings of
    variant ``name`` (None: as it is) and the model's ``dtype``."""
    from pixelnerf_tpu_torch.config import load_config

    conf = load_config(os.path.join(REPO, "conf", "exp", "srn.conf"))
    m = conf["model"]
    if dtype:
        m["dtype"] = dtype
    if name == "global":
        m["use_global_encoder"] = True
        m["global_encoder"] = {"backbone": "resnet34", "latent_size": 128}
    elif name == "custom":
        m["encoder"]["backbone"] = "custom"
    elif name == "spade_softplus":
        for mlp in ("mlp_coarse", "mlp_fine"):
            m[mlp]["use_spade"] = True
            m[mlp]["beta"] = 10.0
        m["encoder"]["feature_scale"] = 0.5
    elif name == "implicit":
        m["mlp_coarse"] = dict(IMPLICIT_MLP)
        m["mlp_fine"] = dict(IMPLICIT_MLP)
    elif name == "quad":
        m["quad_gather"] = True
    elif name is not None:
        raise ValueError(f"unknown variant {name!r}")
    return conf


def make_variant_model(dev, g, name):
    """Variant ``name`` of the SRN model in bf16 on ``dev``, weights from
    ``g``, made opaque as ``make_srn_model`` makes it; the density of a
    softplus, SPADE or ImplicitNet field is its bias alone (their hidden
    values are not bounded as a ReLU ResnetFC's are). Returns (net,
    RenderConfig)."""
    from pixelnerf_tpu_torch.models import ResnetFC, make_model
    from pixelnerf_tpu_torch.render import RenderConfig

    conf = variant_conf(name, "bfloat16")
    net = make_model(conf["model"], device=dev, generator=g, image_size=(IMAGE, IMAGE))
    with torch.no_grad():
        for mlp in (net.mlp_coarse, net.mlp_fine):
            if isinstance(mlp, ResnetFC):
                for blk in mlp.blocks:
                    blk.fc_1.weight.copy_(torch.randn(blk.fc_1.weight.shape, generator=g).to(dev) * 0.02)
                    blk.fc_1.bias.copy_(torch.randn(blk.fc_1.bias.shape, generator=g).to(dev) * 0.02)
                last = mlp.lin_out
            else:
                last = getattr(mlp, f"lin{mlp.num_layers - 2}")
            last.bias[3] = 10.0
            last.weight[:3] *= 0.1
            last.weight[3] *= 0.0 if name in ("spade_softplus", "implicit") else 0.01
    return net, RenderConfig.from_conf(conf["renderer"])


VARIANT_TRAIN_STEPS = 3


def run_variant_train_step(dev, name):
    """f32 train steps of variant ``name`` at the reference train config
    (4 objects x 128 rays, unchunked) after one warm-up step: each step's ms
    (host clock ending in a synchronize), the last loss, and the launches of
    every kernel in them (reset just before)."""
    from pixelnerf_tpu_torch.train import make_render_loss, make_train_step

    net, cfg, conf, batches = train_setup(dev, "a", variant=name)
    opt = torch.optim.Adam(net.parameters(), lr=TRAIN_LR, betas=(0.9, 0.999), eps=1e-8)
    step = make_train_step(net, cfg, opt, make_render_loss(conf["loss"]), remat=False)
    gen = torch.Generator(device=dev).manual_seed(3)
    step(batches[0], generator=gen)
    counters = {**inference_kernels(), **train_kernels()}
    for fn in counters.values():
        fn.launches = 0
    step_ms = []
    for _ in range(VARIANT_TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.time()
        m = step(batches[0], generator=gen)
        torch.cuda.synchronize()
        step_ms.append((time.time() - t0) * 1e3)
    launches = {k: fn.launches for k, fn in counters.items()}
    # the spatial latent's bilinear/border gather: C for the coarse and the
    # new fine samples, each with its backward; the quad gather launches
    # neither
    per = 0 if name == "quad" else train_launches_per_step()["a"] * VARIANT_TRAIN_STEPS
    expect = {k: 0 for k in counters}
    expect.update({"gather_rows_lerp": per, "gather_rows_lerp_bwd": per})
    if launches != expect:
        raise AssertionError(f"variant {name} train step: launch counts {launches} != expected {expect}")
    loss = m["t"].item()
    if not (math.isfinite(loss) and math.isfinite(m["gnorm"].item())):
        raise AssertionError(f"variant {name} train step: non-finite loss or gnorm {loss}, {m['gnorm'].item()}")
    return {"config": name, "model": f"conf/exp/srn.conf + {VARIANT_SETTINGS[name]}, float32",
            "objects": TRAIN_SB, "rays_per_object": TRAIN_CONFIGS["a"]["rays"], "step_ms": step_ms, "loss": loss,
            "gnorm": m["gnorm"].item(), "launches": launches}


def check_c_at_custom_table(dev, g):
    """Kernels C and C-bwd at the custom conv encoder's f32 train table
    (4 objects x 128x128 x 128 channels) and the reference train config's
    coarse gather (4 x 128 rays x 64 samples): C bit-equal to its plain
    version, C-bwd's grad_table bit-equal to its mirror and two of its
    launches bit-equal; C timed against its bound (the output, the records
    and the table rows the points touch), its plain version and
    ``F.grid_sample`` on the NCHW map. At ~25 us a launch, back-to-back
    calls are paced by the host, so C and ``F.grid_sample`` are timed
    queued on the device (``queued_ms``); the back-to-back time and the
    host's time to enqueue one call are kept beside them."""
    import torch.nn.functional as F

    sys.path.insert(0, os.path.join(REPO, "scripts"))
    from bench_gather_rows_bwd_torch import host_us

    from pixelnerf_tpu_torch.ops.gather_rows import gather_rows_lerp, gather_rows_lerp_plain
    from pixelnerf_tpu_torch.ops.grid_sample import bilinear_corners

    views, hl, wl, c = TRAIN_SB, IMAGE, IMAGE, 128
    per_view = TRAIN_CONFIGS["a"]["rays"] * 64
    table = torch.randn((views * hl * wl, c), generator=g).to(dev)
    ix = (torch.rand((views, per_view), generator=g) * (wl - 1)).to(dev)
    iy = (torch.rand((views, per_view), generator=g) * (hl - 1)).to(dev)
    idx, w = bilinear_corners(ix, iy, hl, wl)
    idx = (idx + (torch.arange(views, device=dev, dtype=torch.int32) * (hl * wl))[:, None, None]).reshape(-1, 4)
    idx, w = idx.contiguous(), w.reshape(-1, 4).contiguous()
    out = gather_rows_lerp(table, idx, w, torch.float32)
    torch.cuda.synchronize()
    err = (out - gather_rows_lerp_plain(table, idx, w, torch.float32)).abs().max().item()
    grad_out = torch.randn((idx.shape[0], c), generator=g).to(dev)
    det = c_bwd_deterministic(table, idx, w, grad_out)
    if err != 0.0 or not all(det.values()):
        raise AssertionError(f"kernel C or C-bwd at the custom table: C err {err}, C-bwd {det}")
    n = idx.shape[0]

    def call():
        return gather_rows_lerp(table, idx, w, torch.float32)

    # the record's ms and library_ms are device times (queued); the
    # back-to-back time is the host's pace at this size
    ms = queued_ms(call)
    back_to_back_ms = time_ms(call, reps=50)
    fmap = table.reshape(views, hl, wl, c).permute(0, 3, 1, 2).contiguous()
    grid = torch.stack([ix / (wl - 1) * 2 - 1, iy / (hl - 1) * 2 - 1], dim=-1)[:, None]
    library_ms = queued_ms(
        lambda: F.grid_sample(fmap, grid, mode="bilinear", padding_mode="border", align_corners=True))
    bound_ms, bound_by = bound(n * c * 4 + n * (16 + 16) + rows_read(idx) * c * 4, 7 * n * c, PEAK_F32_FLOPS)
    return {"name": "gather_rows_lerp[custom table]", "route": "cuda",
            "source": "pixelnerf_tpu_torch/csrc/gather_rows.cu", "replaces": "pixelnerf_tpu/ops/gather_pallas.py:172",
            "table": list(table.shape), "points": n, "rows_read": rows_read(idx), "max_abs_err": err, **det,
            "ms": ms, "back_to_back_ms": back_to_back_ms,
            "plain_ms": time_ms(lambda: gather_rows_lerp_plain(table, idx, w, torch.float32), reps=10),
            "bound_ms": bound_ms, "bound_by": bound_by, "bound_share": bound_ms / ms, "host_us": host_us(call),
            "library_ms": library_ms, "library_call": "F.grid_sample(NCHW f32, bilinear, border)",
            "launches_per_step": train_launches_per_step()["a"]}


def run_variants(dev, g, targets, rgen, smi, main_request_ms, crop, noise):
    """The model variants on the card: each variant's staged bf16 render of
    the three requests (A and B launches asserted per request), kernel B at
    the global (640) and custom (128) latent widths and kernel A on the
    custom encoder's 128-channel map against their plain versions, the
    global variant's crop through the kernels against the plain versions,
    three f32 train steps each of global, custom and quad (C and C-bwd
    launches asserted), C and C-bwd at the custom table."""
    t_phase = time.time()
    paths, kernels = {}, {}
    for name, per_request in VARIANT_REQUEST_LAUNCHES.items():
        net, cfg = make_variant_model(dev, g, name)
        images, pose = source_view(g, dev)
        torch.cuda.synchronize()
        t0 = time.time()
        with torch.inference_mode():
            enc = net.encode(images, pose, FOCAL)
        torch.cuda.synchronize()
        extra = {"variant": name, "settings": VARIANT_SETTINGS[name], "d_latent": net.d_latent,
                 "latent_shape": list(enc.latent.shape), "encode_ms": (time.time() - t0) * 1e3, "card": smi}
        stage = "inputs_fused" if "gather_bilerp_field" in per_request else "separate"
        paths[name] = run_path(f"variant_{name}", make_request("staged", net, cfg, enc), targets, dev, rgen,
                               per_request, extra, {stage: 2})
        with torch.inference_mode():
            if name in ("global", "custom"):
                kernels[f"b_{name}"] = check_kernel_b(dev, g, net.mlp_fine, phase=f"variant_kernel_b_{name}",
                                                      more_shapes=False)
            if name == "global":
                rgb_k, depth_k = make_request("staged", net, cfg, enc)(crop, noise=noise)
                rgb_p, depth_p = make_request("plain", net, cfg, enc)(crop, noise=noise)
                err = {"rgb": (rgb_k - rgb_p).abs().max().item(), "depth": (depth_k - depth_p).abs().max().item()}
                # kernel B's tolerance, composited along 96 samples (as main_path's crop)
                emit({"phase": "variant_global_kernel_vs_plain_e2e", "rays": crop.shape[0] * crop.shape[1],
                      "max_abs_err": err, "tolerance": 2e-2})
                if max(err.values()) > 2e-2:
                    raise AssertionError(f"global variant: kernel and plain renders disagree: {err}")
            if name == "custom":
                rec, _ = kernel_a_record(dev, g, IMAGE, IMAGE, 128)
                emit({"phase": "variant_kernel_a_custom", **rec})
                kernels["a_custom"] = rec
        del net, enc
        torch.cuda.empty_cache()
    train = {name: run_variant_train_step(dev, name) for name in ("global", "custom", "quad")}
    for rec in train.values():
        emit({"phase": "variant_train_step", **rec})
    c_custom = check_c_at_custom_table(dev, g)
    summary = {
        "phase": "variants", "card": smi,
        "request_ms": {k: v["request_ms"] for k, v in paths.items()},
        "main_path_request_ms": main_request_ms,
        "launches": {k: v["launches"] for k, v in paths.items()},
        "kernel_b_ms": {k: kernels[f"b_{k}"]["ms"] for k in ("global", "custom")},
        "kernel_b_ring_stages": {k: kernels[f"b_{k}"]["ring_stages"] for k in ("global", "custom")},
        "train_step_ms": {k: v["step_ms"] for k, v in train.items()},
        "c_at_custom_table": c_custom, "seconds": time.time() - t_phase,
    }
    emit(summary)
    return {"paths": paths, "kernels": {**kernels, "c_custom": c_custom}, "train": train}


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

    phase_seconds = {}

    def timed(name, fn, *args):
        t0 = time.time()
        out = fn(*args)
        phase_seconds[name] = time.time() - t0
        return out

    t0 = time.time()
    logs = _build.build(["gather", "fused_mlp", "gather_rows", "fused_field", "gather_study"])
    phase_seconds["build"] = time.time() - t0
    emit({"phase": "build", "seconds": phase_seconds["build"],
          "ptxas": {k: [l.strip() for l in v.splitlines() if "Used" in l or "spill" in l]
                    for k, v in logs.items()}})

    with tempfile.TemporaryDirectory() as jpeg_tmp:
        timed("jpeg", run_jpeg, jpeg_tmp)

    g = torch.Generator().manual_seed(0)
    net, cfg = make_srn_model(dev, g)

    with torch.inference_mode():
        res_a = timed("kernel_a", check_kernel_a, dev, g)
        res_a_field = timed("kernel_a_field", check_kernel_a_field, dev)
        res_b = timed("kernel_b", check_kernel_b, dev, g, net.mlp_fine)
        res_b_views = timed("kernel_b_views", check_kernel_b_views, dev, g, net.mlp_fine)

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
    main_res = timed("main_path", run_path, "main_path", make_request("staged", net, cfg, enc), targets, dev, rgen,
                     {"gather_bilerp_field": 2, "fused_resnetfc_infer": 3}, {"encode_ms": encode_ms, "card": smi},
                     {"inputs_fused": 2})
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
    # the same crop with the feature stage composed around kernel A (the
    # path before the field instance): the rotations' sums in cuBLAS's
    # order may flip a bf16 rounding of an x or latent row (kernel B's
    # tolerance, as above)
    with torch.inference_mode(), separate_feature_stage():
        rgb_s, depth_s = make_request("staged", net, cfg, enc)(crop, noise=noise)
    sep = {"rgb": (rgb_k - rgb_s).abs().max().item(), "depth": (depth_k - depth_s).abs().max().item()}
    emit({"phase": "field_vs_separate_e2e", "rays": crop.shape[0] * crop.shape[1], "max_abs_err": sep,
          "tolerance": e2e_tol})
    if max(sep.values()) > e2e_tol:
        raise AssertionError(f"the field instance's and the separate stage's renders disagree: {sep}")

    # the DTU request at three source views: kernel B's multi-view mode
    dtu_main = timed("dtu_main_path", run_dtu_main_path, dev, torch.Generator().manual_seed(10))

    # the training path's kernels at its own shapes
    inputs_c = kernel_c_inputs(dev, g)
    res_c = timed("kernel_c", check_kernel_c, dev, inputs_c)
    res_c_bwd = timed("kernel_c_bwd", check_kernel_c_bwd, dev, g, inputs_c)
    del inputs_c
    train_launches = {"gather_rows_lerp": 0, "gather_rows_lerp_bwd": 0}
    train_runs = {key: timed(f"train_{key}", run_train, dev, key) for key in TRAIN_CONFIGS}
    for res in list(train_runs.values()) + [timed("train_app", run_train_app, dev)]:
        for k in train_launches:
            train_launches[k] += res["launches"][k]
    timed("train_kernel_vs_plain", train_kernel_vs_plain, dev)

    # the SRN evaluation workflow: train, eval, resume, eval_approx; the
    # apps that consume its model; then the DTU workflow at NS = 3 and 400x300
    with tempfile.TemporaryDirectory() as srn_tmp:
        srn = timed("srn_workflow", run_srn_workflow, dev, srn_tmp)
        apps = timed("apps_workflow", run_apps_workflow, dev, srn_tmp, train_runs["b"])
        preproc = timed("preproc", run_preproc, dev, srn_tmp)
        recon = timed("recon", run_recon, dev, srn_tmp)
    dtu = timed("dtu_workflow", run_dtu_workflow, dev)
    tools = timed("tools", run_tools, dev)
    for k in train_launches:
        train_launches[k] += srn["launches"][k] + dtu["launches"][k] + apps["launches"][k] + tools["launches"][k]

    # the fused and baked field paths: their kernels at the paths' shapes
    with torch.inference_mode():
        res_b_tz = timed("kernel_b_tz", check_kernel_b_tz, dev, g, net.mlp_fine)
        res_d = timed("kernel_d", check_kernel_d, dev, g, net.mlp_fine)
        study = timed("gather_study", check_gather_study, dev)

    with torch.inference_mode():
        penc = pack_encoding(net, enc)
    fused_res = timed("fused_path", run_path, "fused_path", make_request("fused", net, cfg, penc), targets, dev,
                      rgen, {"fused_gather_resnetfc_infer": 2}, {"card": smi})
    torch.cuda.synchronize()
    t0 = time.time()
    with torch.inference_mode():
        baked = bake_encoding(net, enc)
    torch.cuda.synchronize()
    bake_ms = (time.time() - t0) * 1e3
    baked_res = timed("baked_path", run_path, "baked_path", make_request("baked", net, cfg, baked), targets, dev,
                      rgen, {"gather_bilerp": 2, "fused_resnetfc_infer": 2},
                      {"bake_encoding_ms": bake_ms, "tz_map_shape": list(baked.tz_coarse.shape), "card": smi},
                      {"separate": 2})

    # the crop again: fused against staged and plain, baked against unbaked
    with torch.inference_mode():
        rgb_f, depth_f = make_request("fused", net, cfg, penc)(crop, noise=noise)
        rgb_b, depth_b = make_request("baked", net, cfg, baked)(crop, noise=noise)
    pairs = {"fused_vs_staged": ((rgb_f, depth_f), (rgb_s, depth_s)),
             "fused_vs_plain": ((rgb_f, depth_f), (rgb_p, depth_p)),
             "baked_vs_unbaked": ((rgb_b, depth_b), (rgb_s, depth_s))}
    errs = {name: {"rgb": (a[0] - b[0]).abs().max().item(), "depth": (a[1] - b[1]).abs().max().item()}
            for name, (a, b) in pairs.items()}
    # fused against staged (its feature stage composed around kernel A, as
    # query_fused composes it): kernel D is bit-equal to B fed by A, and a
    # sample's value does not depend on its place in the batch, so only the
    # order of equal depths could differ; against plain, kernel B's
    # tolerance as above; baked against unbaked (the same staged render),
    # the injections are rounded to bf16 once more (~1 bf16 ulp of each),
    # carried through the MLP and composited along 96 samples
    tols = {"fused_vs_staged": 1e-5, "fused_vs_plain": e2e_tol, "baked_vs_unbaked": 3e-2}
    emit({"phase": "fused_vs_staged_e2e", "rays": crop.shape[0] * crop.shape[1], "max_abs_err": errs,
          "tolerance": tols})
    for name, err in errs.items():
        if max(err.values()) > tols[name]:
            raise AssertionError(f"{name}: renders disagree: {err} > {tols[name]}")

    # the multi-GPU layer at world size 1: the sharded render and train step
    parallel = timed("parallel", run_parallel, dev, net, cfg, enc, targets[0])
    for k in train_launches:
        train_launches[k] += parallel["launches"][k]

    variants = timed("variants", run_variants, dev, g, targets, rgen, smi, main_res["request_ms"], crop, noise)
    for rec in variants["train"].values():
        for k in train_launches:
            train_launches[k] += rec["launches"][k]

    keys = ("name", "route", "source", "replaces", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    # launches: A's field instance over the staged inference path, the SRN
    # and DTU workflows (with eval --scale 2), the video and real-image
    # apps, eval_real on preproc's outputs, recon, the sharded render and
    # the tools (the multi-object train app, the quality curve, eval_approx
    # on the export) and the DTU request, A itself over the baked path, B
    # over the staged path and the sharded render, B's multi-view mode over
    # the DTU request, B's z_is_tz variant over the baked path, D over the
    # fused path, C and C-bwd over both training configs, the train app,
    # the two workflows, the "dots" run, the profiled train app, the
    # sharded train step and the tools' multi-object train app, the study's
    # formulations over its bench script
    for k in ("gather_bilerp", "gather_bilerp_field"):
        launches[k] += sum(r["launches"][k] for r in (srn, dtu, apps, preproc, recon, parallel, tools, dtu_main))
    launches["gather_bilerp"] += baked_res["launches"]["gather_bilerp"]
    launches["fused_resnetfc_infer"] += parallel["launches"]["fused_resnetfc_infer"]
    launches.update(train_launches)
    launches["fused_resnetfc_infer[z_is_tz]"] = baked_res["launches"]["fused_resnetfc_infer"]
    launches["fused_gather_resnetfc_infer"] = fused_res["launches"]["fused_gather_resnetfc_infer"]
    ported = [{**{k: r[k] for k in keys}, "launches": launches[r["name"]]}
              for r in (res_a, res_a_field, res_b, res_b_tz, res_c, res_c_bwd, res_d)]
    ported.append({**{k: res_b_views[k] for k in keys},
                   "launches": dtu_main["launches"]["fused_resnetfc_infer"]})
    ported += [dict(r) for r in study]   # with their float32 table's time and shares
    # the same kernels at the variants' widths, launched by their paths
    vp = variants["paths"]
    ported += [
        {**{k: variants["kernels"]["b_global"][k] for k in keys}, "name": "fused_resnetfc_infer[d_latent=640]",
         "launches": vp["global"]["launches"]["fused_resnetfc_infer"]},
        {**{k: variants["kernels"]["b_custom"][k] for k in keys}, "name": "fused_resnetfc_infer[d_latent=128]",
         "launches": vp["custom"]["launches"]["fused_resnetfc_infer"]},
        {**{k: variants["kernels"]["a_custom"][k] for k in keys}, "name": "gather_bilerp[128 channels]",
         "launches": vp["custom"]["launches"]["gather_bilerp"]},
        {**{k: variants["kernels"]["c_custom"][k] for k in keys},
         "launches": variants["train"]["custom"]["launches"]["gather_rows_lerp"]},
    ]
    if any(k["launches"] < 1 for k in ported):
        raise AssertionError(f"a kernel was not launched on its path: {ported}")
    emit({"phase": "phase_seconds", "seconds": phase_seconds, "total": time.time() - t_start})
    emit({"kernels": ported, "card": smi, "seconds": time.time() - t_start})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
