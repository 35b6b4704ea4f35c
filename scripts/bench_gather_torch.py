#!/usr/bin/env python3
"""Time the CUDA formulations of the weighted 4-row gather, full scale.

The counterpart, for the PyTorch/CUDA port, of
``scripts/bench_gather_pallas.py``: a 64 x 64 x 512 feature map, 393,216
points (4096 rays x 96 samples) drawn over [-1.1, 1.1]^2, float32 output.
Timed by CUDA events, each against the plain version on the same table:

- kernel C (``gather_rows_lerp``, the port's training gather)
- the four formulations of ``csrc/gather_study.cu`` (tiles of 512 points),
  ``block_stage`` being the block-mask kernel's counterpart
- the library calls: ``F.grid_sample`` on the NCHW map and, for a float32
  table, ``F.embedding_bag(mode="sum", per_sample_weights=w)``

from a float32 and a bf16 table. A formulation that fails is a printed line.

Usage, on a machine with one NVIDIA GPU, from the repository root:
``python3 scripts/bench_gather_torch.py``
"""
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

H = W = 64
C = 512
P = 4096 * 96
TILE = 512


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


def inputs(device):
    """The map (1, H, W, C) float32, the grid (1, P, 2), and the corner rows
    and weights of every point."""
    from pixelnerf_tpu_torch.ops.grid_sample import _compute_source_index, bilinear_corners

    rng = np.random.default_rng(0)
    grid = torch.from_numpy(rng.uniform(-1.1, 1.1, (1, P, 2)).astype(np.float32)).to(device)
    feats = torch.from_numpy(rng.normal(size=(1, H, W, C)).astype(np.float32)).to(device)
    ix = _compute_source_index(grid[0, :, 0], W, "border", True)
    iy = _compute_source_index(grid[0, :, 1], H, "border", True)
    idx, w = bilinear_corners(ix, iy, H, W)
    return feats, grid, idx.contiguous(), w.contiguous()


def run(device, reps=20):
    """All timings: a list of dicts (name, table, ms or error, max_abs_err
    against the plain version on the same table, err_vs_f32 against the
    float32 map's bilinear samples)."""
    import torch.nn.functional as F

    from pixelnerf_tpu_torch.ops.gather_rows import gather_rows_lerp
    from pixelnerf_tpu_torch.ops.gather_study import FORMULATIONS, gather_study, gather_study_plain
    from pixelnerf_tpu_torch.ops.grid_sample import grid_sample

    feats, grid, idx, w = inputs(device)
    ref32 = grid_sample(feats, grid)[0]
    results = []

    def record(name, dtn, fn, plain=None):
        res = {"name": name, "table": dtn}
        try:
            out = fn()
            torch.cuda.synchronize()
            if plain is not None:
                res["max_abs_err"] = (out - plain).abs().max().item()
            res["err_vs_f32"] = (out.float().reshape(ref32.shape) - ref32).abs().max().item()
            res["ms"] = time_ms(fn, reps)
        except Exception as e:   # a failed formulation is a finding here
            res["error"] = f"{type(e).__name__}: {str(e).splitlines()[0][:140]}"
        results.append(res)

    for dtype, dtn in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        table = feats[0].reshape(H * W, C).to(dtype).contiguous()
        plain = gather_study_plain(table, idx, w)
        record("gather_rows_lerp (kernel C)", dtn, lambda: gather_rows_lerp(table, idx, w, torch.float32), plain)
        for formulation in FORMULATIONS:
            record(formulation, dtn, lambda f=formulation: gather_study(table, idx, w, f, tile=TILE), plain)
        res = {"name": "plain version", "table": dtn, "ms": time_ms(lambda: gather_study_plain(table, idx, w), 3, 1)}
        results.append(res)
        fmap = feats.to(dtype).permute(0, 3, 1, 2).contiguous()
        g4 = grid.to(dtype)[:, None]
        record("F.grid_sample (NCHW)", dtn, lambda: F.grid_sample(
            fmap, g4, mode="bilinear", padding_mode="border", align_corners=True)[0, :, 0].t())
        if dtype == torch.float32:
            idx64 = idx.long()
            record("F.embedding_bag (sum, per_sample_weights)", dtn, lambda: F.embedding_bag(
                idx64, table, mode="sum", per_sample_weights=w), plain)
        del table, plain, fmap
    return results


def main():
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    for res in run(torch.device("cuda")):
        head = f"{res['name']:42s} {res['table']:4s}:"
        if "error" in res:
            print(f"{head} FAIL {res['error']}")
            continue
        errs = "".join(f"  {k}={res[k]:.5f}" for k in ("max_abs_err", "err_vs_f32") if k in res)
        print(f"{head} {res['ms']:7.3f} ms{errs}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
