#!/usr/bin/env python3
"""Time kernel A (``gather_bilerp``, ``csrc/gather.cu``) across the widths
the port gives it and two distributions of points, full scale.

Widths (channels on an h x w map): 64 and 256 on 64x64 (the ResNet
encoder's latent at ``num_layers`` 1 and 3), 128 on 128x128 (the custom conv
encoder's map), 512 on 64x64 (the SRN latent) and 1536 on 64x64 (a baked
injection map); each from a bf16 table into bf16 (the render path's pair)
and from a float32 table into float32 (the eval apps' pair). Two sets of
1,048,576 points:

- ``uniform``: x and y uniform over the map, as ``chip_smoke.py``'s
  ``kernel_a_record`` draws them;
- ``request``: one staged request's coarse pass, 16,384 rays x 64
  stratified samples, ray-major, at the SRN geometry of ``chip_smoke.py``
  (128^2 target view, focal 131.25, near 0.8, far 1.8; source camera at
  (0, 0.5, 1.2)), projected and scaled as ``models/pixelnerf.py``
  ``_point_inputs`` and ``models/encoder.py`` ``index_latent`` do.

Each reading: ms a launch by CUDA events, whether the output equals the
plain version bit for bit (compared in slices of 131,072 points), the
bound (the output written once, the 16-byte records and the table rows
that the points touch read once at 3.35 TB/s, or 6 flops a channel at 67 TFLOP/s, whichever is
longer), the bound's share of the time, the plain version's ms
(``gather_bilerp_plain`` over the same points in slices of 131,072, whose
float32 copies stay small; the sum of the slices' times), and
``F.grid_sample``'s ms on the NCHW map at the same points.

Usage, on a machine with one NVIDIA GPU, from the repository root:
``python3 scripts/bench_gather_a_torch.py [--widths 128,512] [--json out.json]``.
To compare with a parent commit in one call, copy this script into the
parent's unpacked tree and run it there and here in turns.
"""
import argparse
import json
import math
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

# channels -> (map height, map width)
MAPS = {64: (64, 64), 128: (128, 128), 256: (64, 64), 512: (64, 64), 1536: (64, 64)}
RAYS, SAMPLES = 16384, 64
POINTS = RAYS * SAMPLES
IMAGE, FOCAL, NEAR, FAR = 128, 131.25, 0.8, 1.8
SOURCE_EYE = (0.0, 0.5, 1.2)
TARGET_ANGLE = 0.6
COMPARE_SLICE = 131072
# the table dtype and the output dtype of each pair
PAIRS = {"bf16": (torch.bfloat16, torch.bfloat16), "f32": (torch.float32, torch.float32)}


def time_ms(fn, reps=20, warmup=2):
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


def uniform_points(hl, wl, device, seed=0, n=POINTS):
    """Points uniform over an hl x wl map: (base, w, grid), grid (n, 2) in
    [-1, 1] for ``F.grid_sample``."""
    from pixelnerf_tpu_torch.ops.grid_sample import bilinear_pair_bases

    g = torch.Generator().manual_seed(seed)
    ix = (torch.rand(n, generator=g) * (wl - 1)).to(device)
    iy = (torch.rand(n, generator=g) * (hl - 1)).to(device)
    base, w = bilinear_pair_bases(ix, iy, hl, wl)
    grid = torch.stack([ix / (wl - 1) * 2 - 1, iy / (hl - 1) * 2 - 1], dim=-1)
    return base, w, grid


def request_points(hl, wl, device, seed=0):
    """One staged request's coarse points on an hl x wl latent of a 128^2
    source view: 16,384 rays x 64 stratified samples, ray-major. Returns
    (base, w, grid) as :func:`uniform_points`."""
    from pixelnerf_tpu_torch.models.encoder import latent_scaling
    from pixelnerf_tpu_torch.ops.grid_sample import _compute_source_index, bilinear_pair_bases
    from pixelnerf_tpu_torch.utils import geometry

    target = geometry.look_at([1.3 * math.sin(TARGET_ANGLE), 0.3, 1.3 * math.cos(TARGET_ANGLE)], [0.0, 0.0, 0.0])
    rays = geometry.gen_rays(target[None], IMAGE, IMAGE, FOCAL, NEAR, FAR, device=device).reshape(-1, 8)
    g = torch.Generator().manual_seed(seed)
    u = torch.rand((RAYS, SAMPLES), generator=g).to(device)
    t = (torch.arange(SAMPLES, device=device, dtype=torch.float32) + u) / SAMPLES
    z = NEAR * (1 - t) + FAR * t
    xyz = rays[:, None, :3] + z[..., None] * rays[:, None, 3:6]               # (RAYS, SAMPLES, 3)
    w2c = geometry.invert_pose(torch.from_numpy(geometry.look_at(SOURCE_EYE, [0.0, 0.0, 0.0])).to(device))
    xyz_cam = xyz.reshape(-1, 3) @ w2c[:3, :3].T + w2c[:3, 3]
    image_shape = torch.tensor([IMAGE, IMAGE], dtype=torch.float32, device=device)
    focal = torch.tensor([FOCAL, -FOCAL], device=device)                    # image y is down
    uv = -xyz_cam[:, :2] / xyz_cam[:, 2:3] * focal + image_shape * 0.5
    grid = uv * (latent_scaling(hl, wl, device) / image_shape) - 1.0
    ix = _compute_source_index(grid[:, 0], wl, "border", True)
    iy = _compute_source_index(grid[:, 1], hl, "border", True)
    base, w = bilinear_pair_bases(ix, iy, hl, wl)
    return base.contiguous(), w.contiguous(), grid


def rows_read(base, width):
    """The table rows that the points' four corners touch, each counted
    once: the rows at ``base`` and their right neighbours."""
    b = base.to(torch.int64)
    right = (torch.remainder(b[:, 0], width) < width - 1).to(torch.int64)
    return torch.unique(torch.cat([b[:, 0], b[:, 1], b[:, 0] + right, b[:, 1] + right])).numel()


def bound_ms(base, table, width, out_dtype):
    """The least time of one launch: (ms, "bytes" or "operations")."""
    n, c = base.shape[0], table.shape[1]
    out_size = torch.empty((), dtype=out_dtype).element_size()
    t_bytes = (n * c * out_size + n * 16 + rows_read(base, width) * c * table.element_size()) / PEAK_BYTES * 1e3
    t_ops = 6 * n * c / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err_against_plain(out, table, base, w, wl, out_dtype):
    """Largest absolute difference of ``out`` from the plain version, taken
    in slices of points so that the plain version's float32 copies stay
    small."""
    from pixelnerf_tpu_torch.ops.gather import gather_bilerp_plain

    err = 0.0
    for s in range(0, base.shape[0], COMPARE_SLICE):
        ref = gather_bilerp_plain(table, base[s:s + COMPARE_SLICE], w[s:s + COMPARE_SLICE], wl, out_dtype)
        err = max(err, (out[s:s + COMPARE_SLICE].float() - ref.float()).abs().max().item())
    return err


def reading(table, base, w, grid, hl, wl, out_dtype, reps=20, library=True):
    """Kernel A on one table and set of points: ms, max_abs_err against the
    plain version (0 is bit-equal), bound_ms, bound_by, bound_share, the
    plain version's plain_ms and ``F.grid_sample``'s library_ms (None when
    ``library`` is false)."""
    import torch.nn.functional as F

    from pixelnerf_tpu_torch.ops.gather import gather_bilerp, gather_bilerp_plain

    n, c = base.shape[0], table.shape[1]
    out = gather_bilerp(table, base, w, wl, out_dtype)
    torch.cuda.synchronize()
    err = max_err_against_plain(out, table, base, w, wl, out_dtype)
    del out
    ms = time_ms(lambda: gather_bilerp(table, base, w, wl, out_dtype), reps)
    b_ms, b_by = bound_ms(base, table, wl, out_dtype)
    plain_ms = time_ms(lambda: [gather_bilerp_plain(table, base[s:s + COMPARE_SLICE], w[s:s + COMPARE_SLICE], wl,
                                                    out_dtype) for s in range(0, n, COMPARE_SLICE)], max(2, reps // 4))
    res = {"points": n, "table": [table.shape[0], c], "max_abs_err": err, "ms": ms,
           "bound_ms": b_ms, "bound_by": b_by, "bound_share": b_ms / ms, "plain_ms": plain_ms, "library_ms": None}
    if library:
        fmap = table.reshape(1, hl, wl, c).permute(0, 3, 1, 2).contiguous()
        g4 = grid.to(table.dtype).reshape(1, 1, n, 2)
        res["library_ms"] = time_ms(lambda: F.grid_sample(
            fmap, g4, mode="bilinear", padding_mode="border", align_corners=True), max(2, reps // 2))
        del fmap
    return res


def run(device, widths=tuple(MAPS), pairs=tuple(PAIRS), reps=20):
    """Every reading: a list of dicts with channels, map, pair, points
    ("uniform" or "request") and :func:`reading`'s keys."""
    results = []
    for c in widths:
        hl, wl = MAPS[c]
        sets = {"uniform": uniform_points(hl, wl, device), "request": request_points(hl, wl, device)}
        for pair in pairs:
            table_dtype, out_dtype = PAIRS[pair]
            g = torch.Generator().manual_seed(c)
            table = torch.randn((hl * wl, c), generator=g).to(table_dtype).to(device)
            for kind, (base, w, grid) in sets.items():
                res = reading(table, base, w, grid, hl, wl, out_dtype, reps)
                results.append({"channels": c, "map": [hl, wl], "pair": pair, "points_kind": kind, **res})
            del table
        del sets
        torch.cuda.empty_cache()
    return results


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--widths", default=",".join(str(c) for c in MAPS),
                        help="comma-separated channel counts, of " + ", ".join(str(c) for c in MAPS))
    parser.add_argument("--pairs", default=",".join(PAIRS), help="comma-separated of bf16, f32")
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--json", help="also write the readings to this file")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    device = torch.device("cuda")
    widths = [int(c) for c in args.widths.split(",")]
    results = run(device, widths, args.pairs.split(","), args.reps)
    print(f"device: {torch.cuda.get_device_name(0)}")
    for r in results:
        lib = f"{r['library_ms']:8.4f}" if r["library_ms"] is not None else "    none"
        print(f"A {r['channels']:5d} ch {r['map'][0]}x{r['map'][1]} {r['pair']:4s} {r['points_kind']:8s}: "
              f"{r['ms']:8.4f} ms  bound {r['bound_ms']:.4f} ({r['bound_by']})  share {r['bound_share']:.3f}  "
              f"max_abs_err {r['max_abs_err']}  plain {r['plain_ms']:.4f}  grid_sample {lib} ms")
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"device": torch.cuda.get_device_name(0), "readings": results}, f, indent=1)
    bad = [r for r in results if r["max_abs_err"] != 0.0]
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
