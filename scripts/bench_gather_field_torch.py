#!/usr/bin/env python3
"""Time kernel A's field instance (``gather_bilerp_field``,
``csrc/gather.cu``): the whole feature stage of ``PixelNeRFNet.query_features``
in one launch, beside the stage it replaces on the card (the separate
stage: ``_point_inputs``, ``index_latent`` through kernel A, the casts).

Two shapes, 512-channel latents, bf16 tables into bf16 (the render cells'
pair) and float32 into float32 (the eval apps' pair):

- ``dtu``: one ``dtu.render`` coarse chunk, 40,000 rays x 64 samples of a
  400x300 target view against three source views (a 150x200 latent each):
  7,680,000 rows;
- ``srn``: one ``srn.render`` view's samples, 16,384 rays x 96 against one
  128x128 source view (a 64x64 latent): 1,572,864 rows.

The rays are ``utils/geometry.py`` ``gen_rays`` of a target camera on the
sources' orbit, sampled ray-major, evenly between near and far with a
seeded jitter. Each reading: ms a call by CUDA events, the instance's
bound (``bound_ms``: kernel A's bytes, the latent table once and a 16-byte
record and an output row a row, plus the x row a row and 24 bytes of point
and direction a point, at 3.35 TB/s) and its share, whether the instance
equals its plain mirror bit for bit (``gather_bilerp_field_plain``,
compared in slices of 262,144 points), the mirror's ms (the sum of the
slices'), and the separate stage's ms and its largest differences from
the instance.

Usage, on a machine with one NVIDIA GPU, from the repository root:
``python3 scripts/bench_gather_field_torch.py [--shapes dtu,srn]
[--pairs bf16,f32] [--json out.json]``.
"""
import argparse
import json
import math
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PEAK_BYTES = 3.35e12
CHANNELS = 512
COMPARE_SLICE = 262144
# shape -> (source views, image (W, H), latent (hl, wl), focal, principal
# point, orbit radius, near, far, rays, samples)
SHAPES = {
    "dtu": (3, (400, 300), (150, 200), (720.0, 718.0), (212.0, 141.0), 2.4, 0.1, 5.0, 40000, 64),
    "srn": (1, (128, 128), (64, 64), (131.25, 131.25), (64.0, 64.0), 1.3, 0.8, 1.8, 16384, 96),
}
PAIRS = {"bf16": torch.bfloat16, "f32": torch.float32}


def time_ms(fn, reps=10, warmup=2):
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


def orbit_pose(angle, radius, height):
    from pixelnerf_tpu_torch.utils import geometry

    eye = (radius * math.sin(angle), height, radius * math.cos(angle))
    return torch.from_numpy(geometry.look_at(eye, (0.0, 0.0, 0.0)))


def stage_inputs(shape, dtype, device, seed=0):
    """The shape's ``SceneEncoding`` (random latent maps in ``dtype``) and its
    request's points and view directions, (1, rays * samples, 3) each."""
    from pixelnerf_tpu_torch.models.pixelnerf import SceneEncoding
    from pixelnerf_tpu_torch.utils import geometry

    views, (w, h), (hl, wl), (fx, fy), (cx, cy), radius, near, far, rays, samples = SHAPES[shape]
    g = torch.Generator().manual_seed(seed)
    c2w = torch.stack([orbit_pose(0.25 * v, radius, 0.4 * radius) for v in range(views)])
    w2c = geometry.invert_pose(c2w).to(device)
    latent = torch.randn((views, hl, wl, CHANNELS), generator=g).to(dtype).to(device)
    enc = SceneEncoding(latent, w2c, torch.tensor([[fx, -fy]], device=device), torch.tensor([[cx, cy]], device=device),
                        torch.tensor([float(w), float(h)], device=device), views)
    target = orbit_pose(0.1, radius, 0.3 * radius)[None]
    r = geometry.gen_rays(target, w, h, (fx, fy), near, far, c=(cx, cy), device=device).reshape(-1, 8)[:rays]
    t = (torch.arange(samples, dtype=torch.float32) + torch.rand((rays, samples), generator=g)) / samples
    z = (near + (far - near) * t).to(device)
    xyz = (r[:, None, :3] + z[..., None] * r[:, None, 3:6]).reshape(1, -1, 3)
    dirs = r[:, None, 3:6].expand(rays, samples, 3).reshape(1, -1, 3).contiguous()
    return enc, xyz, dirs


def stage_net(dtype, device):
    """An SRN-conf model (the published flags) whose MLPs compute in
    ``dtype``; its encoder and MLPs are cut small, as only the feature
    stage runs."""
    from pixelnerf_tpu_torch.config import load_config
    from pixelnerf_tpu_torch.models import make_model

    conf = load_config(os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "conf", "exp",
                                    "srn.conf"))
    conf["model"]["encoder"]["num_layers"] = 1
    for mlp in ("mlp_coarse", "mlp_fine"):
        conf["model"][mlp]["d_hidden"] = 32
    conf["model"]["dtype"] = "bfloat16" if dtype == torch.bfloat16 else "float32"
    return make_model(conf["model"], device=device)


def bound_ms(rows, points, table_rows, out_bytes, d_x):
    moved = table_rows * CHANNELS * out_bytes + rows * (16 + CHANNELS * out_bytes) + rows * d_x * out_bytes + points * 24
    return moved / PEAK_BYTES * 1e3


def measure(shape, pair, device):
    from pixelnerf_tpu_torch.ops.gather import gather_bilerp_field, gather_bilerp_field_plain

    dtype = PAIRS[pair]
    net = stage_net(dtype, device)
    enc, xyz, dirs = stage_inputs(shape, dtype, device)
    freqs, phases = net.code.device_tables(device, torch.float32)
    views, hl, wl = enc.num_views, *enc.latent.shape[1:3]
    rows, points = views * xyz.shape[1], xyz.shape[1]
    rec = {"shape": shape, "pair": pair, "rows": rows, "points": points, "channels": CHANNELS}
    with torch.inference_mode():
        before = gather_bilerp_field.launches
        lat, x = net.query_features(enc, xyz, dirs)
        torch.cuda.synchronize()
        if gather_bilerp_field.launches != before + 1:
            raise AssertionError("query_features did not take the field instance")
        rec["ms"] = time_ms(lambda: net.query_features(enc, xyz, dirs))
        rec["bound_ms"] = bound_ms(rows, points, views * hl * wl, dtype.itemsize, x.shape[-1])
        rec["bound_share"] = rec["bound_ms"] / rec["ms"]
        equal, plain_ms = True, 0.0
        for s in range(0, points, COMPARE_SLICE):
            part = (xyz[:, s:s + COMPARE_SLICE], dirs[:, s:s + COMPARE_SLICE])
            args = (enc.latent, *part, enc.poses, enc.focal, enc.c, enc.image_shape, freqs, phases, dtype)
            pl, px = gather_bilerp_field_plain(*args)
            n = part[0].shape[1]
            equal &= bool(torch.equal(pl, lat[:, s:s + n]) and torch.equal(px, x[:, s:s + n]))
            plain_ms += time_ms(lambda: gather_bilerp_field_plain(*args), reps=2, warmup=0)
            del pl, px
        rec["bit_equal_to_plain"], rec["plain_ms"] = equal, plain_ms

        def separate():
            return net._separate_features(enc, xyz, dirs, use_kernels=True, differentiable=False, coarse=True)

        rec["separate_ms"] = time_ms(separate)
        lat0, x0 = separate()
        rec["separate_max_abs_diff"] = {"latent": (lat.float() - lat0.float()).abs().max().item(),
                                        "x": (x.float() - x0.float()).abs().max().item()}
        del lat0, x0
    del lat, x, enc, xyz, dirs
    torch.cuda.empty_cache()
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shapes", default="dtu,srn")
    ap.add_argument("--pairs", default="bf16,f32")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    device = torch.device("cuda")
    out = {"device": torch.cuda.get_device_name(0), "records": []}
    for shape in args.shapes.split(","):
        for pair in args.pairs.split(","):
            rec = measure(shape, pair, device)
            print(json.dumps(rec), flush=True)
            out["records"].append(rec)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
