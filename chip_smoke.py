#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

The main path is SRN single-view novel-view inference at the full SRN
width (``conf/exp/srn.conf``: ResNet34 to a 512-channel latent, ResnetFC
512 x 5 blocks, 64 coarse + 32 fine samples) in bf16: ``make_model`` ->
``encode`` of one 128^2 source view -> ``FullRenderer(fast=True)
.render_image`` of three 128x128 novel views (three requests), weights
random from a seed. Phases, one JSON line each:

1. device: ``nvidia-smi`` name and power limit, torch and CUDA versions
2. build: both CUDA kernels from ``pixelnerf_tpu_torch/csrc`` for sm_90a,
   one nvcc each, in parallel
3. kernel A (gather) and 4. kernel B (fused MLP) against their plain
   PyTorch versions at the main path's shapes, with times, the bound and a
   library call's time
5. the main path, with both kernels' launch counts read around it
6. the same render of a 2048-ray crop through the kernels and through
   their plain versions, on the same noise

then the ``kernels`` line, the card's name and power limit, and
``{"ok": true, ...}`` as the last line. Any failure raises and exits
non-zero; without a GPU it exits non-zero before printing anything.

Usage: ``python3 chip_smoke.py`` from the root of the repository.
"""
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
    logs = _build.build(["gather", "fused_mlp"])
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

    keys = ("name", "route", "source", "replaces", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    emit({"kernels": [{**{k: r[k] for k in keys}, "launches": launches[r["name"]]} for r in (res_a, res_b)],
          "card": smi, "seconds": time.time() - t_start})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
