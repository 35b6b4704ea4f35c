#!/usr/bin/env python3
"""Where one training step's time goes in the PyTorch/CUDA port.

For each training config of ``chip_smoke.py`` (``a``: the reference
config, f32, 4 objects x 128 rays, unchunked; ``b``: the chip-filling
config, bf16, 4 x 2048 rays, 256-ray chunks, ``remat="features"``) it
builds the seeded SRN model and the config's synthetic batch, takes two
warm-up steps, times three more with the host clock around
``synchronize()``, then profiles one under ``torch.profiler`` and prints
one JSON line: the step's wall time, the device time summed over its
kernels, and the device time grouped (kernel C, its backward, the cuBLAS
GEMMs, the cuDNN convolutions, then the rest by name). The device's idle
share is the benchmark's (``portbench/``, ``idle_share.*``).

``--remat`` replaces the configs' remat policy (``dots``: the matrix
products' outputs kept, the rest recomputed), on the same weights,
batches and draws.

Usage, on a machine with one NVIDIA GPU, from the repository root:
``python3 scripts/profile_torch_train.py [--configs a b] [--remat dots] [--trace-dir DIR]``
"""
import argparse
import json
import os
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _group(name: str) -> str:
    # the backward's launches: count, scan, fill, owner, combine, and the
    # point-major kernel of the weight gradient alone
    if "gather_rows_bwd" in name:
        return "gather_rows_lerp_bwd (kernel C-bwd)"
    if "gather_rows_kernel" in name:
        return "gather_rows_lerp (kernel C)"
    low = name.lower()
    if "conv" in low or "cudnn" in low or "implicit_convolve" in low or "wgrad" in low or "dgrad" in low:
        return "convolutions (cuDNN)"
    if "gemm" in low or "xmma" in low or "cutlass" in low or "nvjet" in low:
        return "matrix products (cuBLAS)"
    return name


def profile_config(key, dev, cs, trace_dir=None, remat=None):
    from pixelnerf_tpu_torch.train import make_render_loss, make_train_step

    tc = cs.TRAIN_CONFIGS[key] if remat is None else {**cs.TRAIN_CONFIGS[key], "remat": remat}
    net, cfg, conf, batches = cs.train_setup(dev, key)
    opt = torch.optim.Adam(net.parameters(), lr=cs.TRAIN_LR, betas=(0.9, 0.999), eps=1e-8)
    step = make_train_step(net, cfg, opt, make_render_loss(conf["loss"]),
                           ray_chunk=tc["ray_chunk"], remat=tc["remat"])
    gen = torch.Generator(device=dev).manual_seed(3)

    def one(i):
        step(batches[i % len(batches)], generator=gen)
        torch.cuda.synchronize()

    for i in range(2):
        one(i)
    wall = []
    for i in range(3):
        t0 = time.time()
        one(i)
        wall.append((time.time() - t0) * 1e3)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.time()
        one(0)
        prof_wall_ms = (time.time() - t0) * 1e3

    groups = {}
    device_ms = 0.0
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = ev.self_device_time_total / 1e3
        if ms <= 0:
            continue
        device_ms += ms
        entry = groups.setdefault(_group(ev.key), {"ms": 0.0, "calls": 0})
        entry["ms"] += ms
        entry["calls"] += ev.count
    top = sorted(groups.items(), key=lambda kv: -kv[1]["ms"])
    if trace_dir:
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(trace_dir, f"train_{key}_{tc['remat']}.json"))
    return {
        "config": key, "objects": cs.TRAIN_SB, "rays_per_object": tc["rays"], "ray_chunk": tc["ray_chunk"],
        "remat": tc["remat"], "dtype": tc["dtype"] or "float32",
        "wall_ms_unprofiled": wall,
        "wall_ms_profiled": prof_wall_ms,
        "device_ms": device_ms,
        "kernels": [{"name": k, "ms": v["ms"], "calls": v["calls"], "share": v["ms"] / device_ms}
                    for k, v in top[:25]],
    }


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--configs", nargs="+", default=["a", "b"], choices=["a", "b"])
    ap.add_argument("--remat", default=None, choices=["true", "false", "features", "dots"],
                    help="the remat policy in place of each config's own")
    ap.add_argument("--trace-dir", default=None, help="write each config's chrome trace here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke as cs

    # the float32 settings chip_smoke.py runs under
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    for key in args.configs:
        remat = {"true": True, "false": False}.get(args.remat, args.remat)
        print(json.dumps({"card": smi, **profile_config(key, dev, cs, args.trace_dir, remat)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
