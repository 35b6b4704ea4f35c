#!/usr/bin/env python3
"""Where one render request's time goes in the PyTorch/CUDA port.

Builds the seeded bf16 SRN model and scene of ``chip_smoke.py``, answers
two warm-up requests (one 128x128 novel view each, one ray chunk per
image), times three more with the host clock around ``synchronize()``,
then runs one under ``torch.profiler`` and prints one JSON line: the
request's wall time, the device time summed over its kernels, and the
device time of the kernels grouped (the CUDA kernels of the port, then the
rest by name). The device's idle share is the benchmark's (``portbench/``,
``idle_share.*``).

``--path`` picks the render path: ``staged`` (kernel A's gather, kernel
B's MLP; the default), ``fused`` (the unstaged renderer on ``query_fused``:
kernel D) or ``baked`` (a ``bake_encoding``'d scene: kernel A on the
injection maps, kernel B with ``z_is_tz``). ``--variant`` builds one of
``chip_smoke.py``'s model variants instead (e.g. ``custom``: the custom conv
encoder's 128-channel map), staged.

Usage, on a machine with one NVIDIA GPU, from the repository root:
``python3 scripts/profile_torch_render.py [--path staged|fused|baked] [--variant NAME] [--trace PATH]``
(``--trace`` also writes the profiler's chrome trace).
"""
import argparse
import json
import os
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--path", default="staged", choices=("staged", "fused", "baked"))
    ap.add_argument("--variant", default=None, choices=("global", "custom", "spade_softplus", "implicit", "quad"),
                    help="a model variant of chip_smoke.py, rendered staged")
    ap.add_argument("--trace", default=None, help="write the chrome trace here")
    args = ap.parse_args()
    if args.variant and args.path != "staged":
        ap.error("--variant renders the staged path")
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from pixelnerf_tpu_torch.models import bake_encoding, pack_encoding
    from pixelnerf_tpu_torch.utils import geometry

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    g = torch.Generator().manual_seed(0)
    net, cfg = cs.make_variant_model(dev, g, args.variant) if args.variant else cs.make_srn_model(dev, g)
    images, src_pose = cs.source_view(g, dev)
    pose = cs.target_poses()[0]
    rgen = torch.Generator(device=dev).manual_seed(1)

    def request():
        rays = geometry.gen_rays(pose[None], cs.IMAGE, cs.IMAGE, cs.FOCAL, cs.NEAR, cs.FAR, device=dev)[0]
        rgb, depth = render(rays, generator=rgen)
        torch.cuda.synchronize()
        return rgb, depth

    with torch.inference_mode():
        enc = net.encode(images, src_pose, cs.FOCAL)
        if args.path != "staged":
            enc = (pack_encoding if args.path == "fused" else bake_encoding)(net, enc)
        render = cs.make_request(args.path, net, cfg, enc)
        for _ in range(2):
            request()
        wall = []
        for _ in range(3):
            t0 = time.time()
            request()
            wall.append((time.time() - t0) * 1e3)
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.time()
            request()
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
        name = ev.key
        if "gather_bilerp" in name:
            name = "gather_bilerp (kernel A)"
        elif "fused_mlp_kernel" in name:
            name = "fused_resnetfc_infer (kernel B)"
        elif "fused_field_kernel" in name:
            name = "fused_gather_resnetfc_infer (kernel D)"
        entry = groups.setdefault(name, {"ms": 0.0, "calls": 0})
        entry["ms"] += ms
        entry["calls"] += ev.count
    top = sorted(groups.items(), key=lambda kv: -kv[1]["ms"])
    if args.trace:
        os.makedirs(os.path.dirname(os.path.abspath(args.trace)), exist_ok=True)
        prof.export_chrome_trace(args.trace)
    print(json.dumps({
        "card": smi,
        "path": args.path,
        "variant": args.variant,
        "request": "one 128x128 view, conf/exp/srn.conf bf16, fast=True, one ray chunk",
        "wall_ms_unprofiled": wall,
        "wall_ms_profiled": prof_wall_ms,
        "device_ms": device_ms,
        "kernels": [{"name": k, "ms": v["ms"], "calls": v["calls"], "share": v["ms"] / device_ms}
                    for k, v in top[:25]],
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
