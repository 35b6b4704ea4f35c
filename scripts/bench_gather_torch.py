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

from a float32 and a bf16 table, each with a modelled count of the bytes it
reads through L2 and their rate over the measured time (the model, not a
counter: see ``modelled_l2_bytes``), ``block_stage``'s binning held to its
plain mirror, and a write of the output's bytes alone (``Tensor.zero_``).
Apart from the timed calls, the device time of each of ``block_stage``'s
five launches (``torch.profiler``, ``block_stage_launches``). A
formulation that fails is a printed line.

Usage, on a machine with one NVIDIA GPU, from the repository root:
``python3 scripts/bench_gather_torch.py``
"""
import os
import re
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


def inputs(device, h=H, w=W, c=C, points=P):
    """The map (1, h, w, c) float32, the grid (1, points, 2), and the corner
    rows and weights of every point."""
    from pixelnerf_tpu_torch.ops.grid_sample import _compute_source_index, bilinear_corners

    rng = np.random.default_rng(0)
    grid = torch.from_numpy(rng.uniform(-1.1, 1.1, (1, points, 2)).astype(np.float32)).to(device)
    feats = torch.from_numpy(rng.normal(size=(1, h, w, c)).astype(np.float32)).to(device)
    ix = _compute_source_index(grid[0, :, 0], w, "border", True)
    iy = _compute_source_index(grid[0, :, 1], h, "border", True)
    idx, wts = bilinear_corners(ix, iy, h, w)
    return feats, grid, idx.contiguous(), wts.contiguous()


def modelled_l2_bytes(formulation, table, idx, plan=None):
    """The bytes a formulation reads through L2 for ``idx`` (N, 4) from
    ``table``, by a model: for the first three formulations every tap's row
    and each point's idx and w, once (L1 hits not subtracted, so more than
    L2 serves where rows repeat within an SM); for ``block_stage`` with its
    ``plan``, each non-empty bin's slab once (each block that enters a bin
    stages it again, so less than L2 serves), the rows of the points not
    served from their slab, each point's idx three times in the binning and
    once more with its w and perm entry in the serving."""
    from pixelnerf_tpu_torch.ops.gather_study import block_stage_served, slab_rows

    (rows, c), n, size = table.shape, idx.shape[0], table.element_size()
    if formulation != "block_stage":
        return n * (4 * c * size + 32)
    offsets = plan.offsets.to(torch.int64)
    bases = torch.nonzero(offsets[1:] > offsets[:-1])[:, 0] * plan.step
    staged = int((rows - bases).clamp(max=slab_rows(c, size)).sum()) * c * size
    unserved = int((~block_stage_served(idx, plan, c, size)).sum())
    return staged + unserved * 4 * c * size + n * (3 * 16 + 16 + 16 + 4)


def block_stage_launches(device, launches=10):
    """Device microseconds of each kernel (and memset) of one
    ``block_stage`` call on the bench's inputs, per table dtype, from
    ``torch.profiler`` over ``launches`` calls."""
    from pixelnerf_tpu_torch.ops.gather_study import gather_study

    feats, _, idx, w = inputs(device)
    results = []
    for dtype, dtn in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        table = feats[0].reshape(H * W, C).to(dtype).contiguous()
        gather_study(table, idx, w, "block_stage")
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(launches):
                gather_study(table, idx, w, "block_stage")
            torch.cuda.synchronize()
        us = {}
        for e in prof.key_averages():
            if e.device_time_total > 0:
                name = re.search(r"\w+_kernel(<[\w ]+>)?", e.key)
                us[name.group(0) if name else e.key] = e.device_time_total / e.count
        results.append({"name": "block_stage's launches", "table": dtn, "us": us})
    return results


def run(device, reps=20):
    """All timings: a list of dicts (name, table, ms or error, max_abs_err
    against the plain version on the same table, err_vs_f32 against the
    float32 map's bilinear samples; for the study's formulations
    modelled_l2_bytes and modelled_l2_tb_s, those bytes over the measured
    time), and per table dtype ``block_stage``'s binning against its plain
    mirror (matches_mirror, step, bins, served_share)."""
    import torch.nn.functional as F

    from pixelnerf_tpu_torch.ops.gather_rows import gather_rows_lerp
    from pixelnerf_tpu_torch.ops.gather_study import (
        FORMULATIONS,
        block_stage_plan,
        block_stage_plan_plain,
        block_stage_served,
        gather_study,
        gather_study_plain,
    )
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
        plan = block_stage_plan(table, idx)
        mirror = block_stage_plan_plain(idx.cpu(), H * W, C, table.element_size())
        results.append({"name": "block_stage's binning", "table": dtn, "step": plan.step,
                        "bins": plan.offsets.shape[0] - 1,
                        "matches_mirror": plan.step == mirror.step and torch.equal(plan.offsets.cpu(), mirror.offsets)
                        and torch.equal(plan.perm.cpu(), mirror.perm),
                        "served_share": block_stage_served(idx, plan, C, table.element_size()).float().mean().item()})
        record("gather_rows_lerp (kernel C)", dtn, lambda: gather_rows_lerp(table, idx, w, torch.float32), plain)
        for formulation in FORMULATIONS:
            record(formulation, dtn, lambda f=formulation: gather_study(table, idx, w, f, tile=TILE), plain)
            res = results[-1]
            res["modelled_l2_bytes"] = modelled_l2_bytes(formulation, table, idx, plan)
            if "ms" in res:
                res["modelled_l2_tb_s"] = res["modelled_l2_bytes"] / (res["ms"] * 1e9)
        out = torch.empty_like(plain)
        results.append({"name": "write of the output (Tensor.zero_)", "table": dtn, "ms": time_ms(out.zero_, reps)})
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
        del table, plain, fmap, out
    return results


def main():
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    device = torch.device("cuda")
    for res in run(device) + block_stage_launches(device):
        head = f"{res['name']:42s} {res['table']:4s}:"
        if "error" in res:
            print(f"{head} FAIL {res['error']}")
        elif "us" in res:
            print(f"{head} " + ", ".join(f"{k} {v:.2f} us" for k, v in res["us"].items()))
        elif "matches_mirror" in res:
            print(f"{head} step {res['step']}, {res['bins']} bins, served from the slab "
                  f"{res['served_share']:.4f}, matches its plain mirror: {res['matches_mirror']}")
        else:
            errs = "".join(f"  {k}={res[k]:.5f}" for k in ("max_abs_err", "err_vs_f32") if k in res)
            l2 = (f"  modelled L2 reads {res['modelled_l2_bytes'] / 1e9:.3f} GB, {res['modelled_l2_tb_s']:.2f} TB/s"
                  if "modelled_l2_tb_s" in res else "")
            print(f"{head} {res['ms']:7.3f} ms{errs}{l2}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
