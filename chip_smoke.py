#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one NVIDIA GPU and check them.

Two paths at the full width of the SRN model (``conf/exp/srn.conf``:
ResNet34 to a 512-channel latent, ResnetFC 512 x 5 blocks, 64 coarse + 32
fine samples), weights random from a seed:

- inference, in bf16: ``make_model`` -> ``encode`` of one 128^2 source
  view -> ``FullRenderer(fast=True).render_image`` of three 128x128 novel
  views (three requests);
- training: ``make_train_step`` steps on batches of the port's synthetic
  scenes at SRN geometry (128^2, focal 131.25, near 0.8, far 1.8), at the
  reference config (f32, 4 objects x 128 rays, unchunked, 20 steps on one
  batch) and at the chip-filling config (bf16 compute, f32 parameters and
  Adam, 4 objects x 2048 rays, 256-ray chunks, ``remat="features"``,
  5 steps); and the training app itself for a few steps.

Phases, one JSON line each:

1. device: ``nvidia-smi`` name and power limit, torch and CUDA versions
2. build: the three CUDA sources of ``pixelnerf_tpu_torch/csrc`` for
   sm_90a, one nvcc each, in parallel
3. kernel A (gather) and 4. kernel B (fused MLP) against their plain
   PyTorch versions at the inference path's shapes, with times, the bound
   and a library call's time
5. main_path: the inference path, with A's and B's launch counts read
   around it
6. kernel_vs_plain_e2e: a 2048-ray crop rendered through the kernels and
   through their plain versions, on the same noise
7. kernel_c and 8. kernel_c_bwd: kernel C (weighted 4-row gather) and its
   backward against their plain versions at the training path's shapes
9. train: both training configs, with C's and C-bwd's launch counts read
   around each
10. train_app: ``apps.train.main`` for 2 x 2 batches (f32, 4 x 128 rays),
    eval and checkpoints included, with the launch counts read around it
11. train_kernel_vs_plain: one step of the reference config (a) at its
    full shape through the kernels and through their plain versions, from
    one state, batch and noise

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

# published H100 SXM peaks (NVIDIA data sheet): dense bf16 tensor-core rate
# and HBM3 bandwidth
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

# SRN geometry (the SRN dataset's cameras, conf/exp/srn.conf renderer)
IMAGE = 128
FOCAL = 131.25
NEAR, FAR = 0.8, 1.8
RAY_CHUNK = IMAGE * IMAGE   # one image per chunk
N_REQUESTS = 3
PEAK_F32_FLOPS = 67e12      # off the tensor cores

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
    bound_ms, bound_by = bound(bytes_moved, 6 * n * c, 67e12)   # f32 lerp off the tensor cores
    res = {
        "name": "gather_bilerp", "route": "cuda",
        "source": "pixelnerf_tpu_torch/csrc/gather.cu",
        "replaces": "pixelnerf_tpu/ops/gather_pallas.py:110",
        "shape": {"table": [hl * wl, c], "points": n, "out_dtype": "bfloat16"},
        "max_abs_err": err, "tolerance": tol,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms, "library_call": "F.grid_sample(NCHW bf16, bilinear, border)",
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
    diff = (out - ref).abs()
    err = diff.max().item()
    # both accumulate bf16 products in float32, in other orders: one
    # flipped bf16 rounding is carried by the later layers (the tolerance
    # of tests/test_fused_mlp.py), and nearly all entries agree closely
    atol = rtol = 5e-2
    bad = (diff > atol + rtol * ref.abs()).sum().item()
    close = (diff < 1e-2).float().mean().item()
    if bad or close < 0.95 or not torch.isfinite(out).all():
        raise AssertionError(f"kernel B disagrees with its plain version: max {err}, {bad} outside, {close} close")
    ms = time_ms(lambda: fused_resnetfc_infer(z, x, weights, mlp.n_blocks, mlp.combine_layer), reps=5)
    plain_ms = time_ms(
        lambda: fused_resnetfc_infer_plain(z, x, weights, mlp.n_blocks, mlp.combine_layer), reps=2, warmup=1
    )
    # yardstick: the same chain as bf16 torch.matmul calls (cuBLAS), the
    # dense path of ResnetFC outside the kernel's gate
    library_ms = time_ms(lambda: mlp((z, x), combine_inner_dims=(1, n), fast=False), reps=3, warmup=1)
    dh, d_in_pad = weights[0].shape
    n_lin_z = min(mlp.combine_layer, mlp.n_blocks)
    # operations padded as fused_mlp.py:130-134 counts them
    flops = 2 * n * dh * (d_in_pad + n_lin_z * dh + 2 * mlp.n_blocks * dh + 128)
    bytes_moved = n * (mlp.d_in + mlp.d_latent) * 2 + n * 4 * 4 + sum(w.numel() * 2 for w in weights)
    bound_ms, bound_by = bound(bytes_moved, flops, PEAK_BF16_FLOPS)
    res = {
        "name": "fused_resnetfc_infer", "route": "cuda",
        "source": "pixelnerf_tpu_torch/csrc/fused_mlp.cu",
        "replaces": "pixelnerf_tpu/ops/fused_mlp.py:68",
        "shape": {"rows": n, "d_hidden": dh, "d_latent": mlp.d_latent, "d_in": mlp.d_in,
                  "n_blocks": mlp.n_blocks, "n_lin_z": n_lin_z},
        "max_abs_err": err, "tolerance": {"atol": atol, "rtol": rtol}, "frac_within_1e-2": close,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms, "library_call": "bf16 torch.matmul chain (ResnetFC fast=False)",
        "tflops": flops / ms / 1e9,
    }
    emit({"phase": "kernel_b", **res})
    return res


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


def check_kernel_c_bwd(dev, g, inputs):
    import torch.nn.functional as F

    from pixelnerf_tpu_torch.ops.gather_rows import gather_rows_lerp_bwd, gather_rows_lerp_bwd_plain

    table, idx, w, fmap, grid = inputs
    n, c = idx.shape[0], table.shape[1]
    grad_out = torch.randn((n, c), generator=g).to(torch.bfloat16).to(dev)
    gt, gw = gather_rows_lerp_bwd(table, idx, w, grad_out)
    torch.cuda.synchronize()
    rt, rw = gather_rows_lerp_bwd_plain(table, idx, w, grad_out)
    err_t = (gt.float() - rt.float()).abs().max().item()
    err_w = (gw - rw).abs().max().item()
    # float32 sums in another order (atomics; a warp's shuffle tree): a
    # few float32 ulps of the largest entry, plus one bf16 rounding of the
    # table gradient that may fall the other way (2^-8 of the entry)
    tol_t = 8e-3 * rt.float().abs().max().item()
    tol_w = 1e-5 * rw.abs().max().item()
    if not (err_t <= tol_t and err_w <= tol_w):
        raise AssertionError(f"kernel C-bwd disagrees with its plain version: {err_t} > {tol_t} or {err_w} > {tol_w}")
    ms = time_ms(lambda: gather_rows_lerp_bwd(table, idx, w, grad_out), reps=20)
    plain_ms = time_ms(lambda: gather_rows_lerp_bwd_plain(table, idx, w, grad_out), reps=5)
    # yardstick: torch's grid-sampler backward for the same points, both
    # gradients (map and grid), timed on a retained graph
    fmap_g = fmap.detach().requires_grad_()
    grid_g = grid.detach().requires_grad_()
    out = F.grid_sample(fmap_g, grid_g, mode="bilinear", padding_mode="border", align_corners=True)
    gout = grad_out.reshape(TRAIN_SB, -1, c).permute(0, 2, 1)[:, :, None].contiguous()
    library_ms = time_ms(
        lambda: torch.autograd.grad(out, (fmap_g, grid_g), gout, retain_graph=True), reps=10
    )
    bytes_moved = n * c * 2 + table.numel() * 2 + n * 32 + table.numel() * 2 + n * 16
    bound_ms, bound_by = bound(bytes_moved, 16 * n * c, PEAK_F32_FLOPS)
    res = {
        "name": "gather_rows_lerp_bwd", "route": "cuda",
        "source": "pixelnerf_tpu_torch/csrc/gather_rows.cu",
        "replaces": "XLA gather transpose (pixelnerf_tpu/ops/grid_sample.py:126-133); no Pallas counterpart",
        "shape": {"table": list(table.shape), "points": n, "grad_out_dtype": "bfloat16"},
        "max_abs_err": max(err_t, err_w), "max_abs_err_by_output": {"grad_table": err_t, "grad_w": err_w},
        "tolerance": {"grad_table": tol_t, "grad_w": tol_w},
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms,
        "library_call": "torch.autograd.grad through F.grid_sample (NCHW bf16 map and grid)",
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


def run_train_app(dev):
    """The user's entry point, ``python -m pixelnerf_tpu_torch.apps.train``,
    on the card: the SRN model in f32, 4 objects x 128 rays of the
    synthetic scenes (128^2, cameras at radius 1.3), 2 epochs x 2 batches,
    with the trainer's eval (kernel A's gather) and checkpoints, written to
    a temporary directory. Its printed metrics are captured, not echoed."""
    import contextlib
    import io
    import tempfile

    from pixelnerf_tpu_torch.apps import train as train_app
    from pixelnerf_tpu_torch.ops.fused_mlp import fused_resnetfc_infer
    from pixelnerf_tpu_torch.ops.gather import gather_bilerp
    from pixelnerf_tpu_torch.ops.gather_rows import gather_rows_lerp, gather_rows_lerp_bwd
    from pixelnerf_tpu_torch.train import load_variables

    os.environ["PIXELNERF_NO_TB"] = "1"
    epochs, batches = 2, 2
    with tempfile.TemporaryDirectory() as tmp:
        argv = [
            "-n", "chip_smoke", "-c", os.path.join(REPO, "conf", "exp", "srn.conf"), "-F", "synthetic",
            "--epochs", str(epochs), "--epoch_batches", str(batches), "--device", str(dev), "--workers", "1",
            "--checkpoints_path", os.path.join(tmp, "ck"), "--logs_path", os.path.join(tmp, "logs"),
            "--override", f"data.image_size=[{IMAGE}, {IMAGE}]", "--override", f"data.num_objects={TRAIN_SB}",
            "--override", "data.radius=1.3",
        ]
        for fn in (gather_rows_lerp, gather_rows_lerp_bwd, gather_bilerp, fused_resnetfc_infer):
            fn.launches = 0
        out = io.StringIO()
        t0 = time.time()
        with contextlib.redirect_stdout(out):
            trainer = train_app.main(argv)
        torch.cuda.synchronize()
        seconds = time.time() - t0
        launches = {"gather_rows_lerp": gather_rows_lerp.launches,
                    "gather_rows_lerp_bwd": gather_rows_lerp_bwd.launches,
                    "gather_bilerp": gather_bilerp.launches,
                    "fused_resnetfc_infer": fused_resnetfc_infer.launches}
        saved = load_variables(os.path.join(tmp, "ck", "chip_smoke"))
    lines = out.getvalue().splitlines()
    losses = [float(l.split(" t:")[1].split()[0]) for l in lines if l.startswith("E")]
    evals = [l for l in lines if l.startswith("*** eval:")]
    steps = epochs * batches
    # unchunked train steps: 2 gathers and 2 backwards each; the trainer's
    # eval (batch 1 of each epoch) renders through kernel A, 2 launches
    expect = {"gather_rows_lerp": 2 * steps, "gather_rows_lerp_bwd": 2 * steps,
              "gather_bilerp": 2 * epochs, "fused_resnetfc_infer": 0}
    res = {"phase": "train_app", "argv": argv[2:], "seconds": seconds, "steps": trainer.step,
           "printed_losses": losses, "evals": len(evals), "checkpoint_step": saved and saved["step"],
           "launches": launches, "expected_launches": expect}
    emit(res)
    if launches != expect:
        raise AssertionError(f"train app: launch counts {launches} != expected {expect}")
    if trainer.step != steps or not saved or saved["step"] != steps or len(evals) != epochs:
        raise AssertionError(f"train app: steps {trainer.step}, checkpoint {saved and saved['step']}, "
                             f"evals {len(evals)}")
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


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from pixelnerf_tpu_torch.eval import FullRenderer
    from pixelnerf_tpu_torch.ops import _build
    from pixelnerf_tpu_torch.ops.fused_mlp import fused_resnetfc_infer
    from pixelnerf_tpu_torch.ops.gather import gather_bilerp
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
    logs = _build.build(["gather", "fused_mlp", "gather_rows"])
    emit({"phase": "build", "seconds": time.time() - t0,
          "ptxas": {k: [l.strip() for l in v.splitlines() if "registers" in l or "spill" in l]
                    for k, v in logs.items()}})

    g = torch.Generator().manual_seed(0)
    net, cfg = make_srn_model(dev, g)

    with torch.inference_mode():
        res_a = check_kernel_a(dev, g)
        res_b = check_kernel_b(dev, g, net.mlp_fine)

    # the main path: encode one source view, answer three render requests
    images, src_pose = source_view(g, dev)
    targets = target_poses()
    renderer = FullRenderer(net, cfg, ray_chunk=RAY_CHUNK, fast=True)
    rgen = torch.Generator(device=dev).manual_seed(1)
    gather_bilerp.launches = 0
    fused_resnetfc_infer.launches = 0
    torch.cuda.synchronize()
    t0 = time.time()
    with torch.inference_mode():
        enc = net.encode(images, src_pose, FOCAL)
        torch.cuda.synchronize()
        encode_ms = (time.time() - t0) * 1e3
        request_ms, renders = [], []
        for pose in targets:
            t1 = time.time()
            rays = geometry.gen_rays(pose[None], IMAGE, IMAGE, FOCAL, NEAR, FAR, device=dev)[0]
            rgb, depth = renderer.render_image(enc, rays, generator=rgen)
            torch.cuda.synchronize()
            request_ms.append((time.time() - t1) * 1e3)
            renders.append((rgb, depth))
    launches = {"gather_bilerp": gather_bilerp.launches, "fused_resnetfc_infer": fused_resnetfc_infer.launches}
    chunks = -(-IMAGE * IMAGE // RAY_CHUNK) * N_REQUESTS
    expect = {"gather_bilerp": 2 * chunks, "fused_resnetfc_infer": 3 * chunks}
    if launches != expect:
        raise AssertionError(f"launch counts {launches} != expected {expect}")
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
    steady = request_ms[1:]
    emit({
        "phase": "main_path", "config": "conf/exp/srn.conf, bf16, 128x128, 64+32 samples",
        "requests": N_REQUESTS, "ray_chunk": RAY_CHUNK, "encode_ms": encode_ms,
        "request_ms": request_ms,
        "rays_per_s_steady": IMAGE * IMAGE * len(steady) / (sum(steady) / 1e3),
        "launches": launches, "expected_launches": expect,
        "rgb_std": [r.float().std().item() for r, _ in renders],
        "depth_range": [min(d.min().item() for _, d in renders), max(d.max().item() for _, d in renders)],
        "card": smi,
    })

    # kernels vs their plain versions, end to end, on the same noise
    crop = geometry.gen_rays(targets[0][None], IMAGE, IMAGE, FOCAL, NEAR, FAR, device=dev)[0, 48:64]
    noise = [draw_noise(crop.reshape(1, -1, 8), cfg, torch.Generator(device=dev).manual_seed(2))]
    with torch.inference_mode():
        rgb_k, depth_k = FullRenderer(net, cfg, ray_chunk=2048, fast=True).render_image(enc, crop, noise=noise)
        rgb_p, depth_p = FullRenderer(net, cfg, ray_chunk=2048, fast=True, use_kernels=False).render_image(
            enc, crop, noise=noise)
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

    keys = ("name", "route", "source", "replaces", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    # launches: A and B over the inference path, C and C-bwd over both
    # training configs and the train app
    launches.update(train_launches)
    emit({"kernels": [{**{k: r[k] for k in keys}, "launches": launches[r["name"]]}
                      for r in (res_a, res_b, res_c, res_c_bwd)],
          "card": smi, "seconds": time.time() - t_start})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
