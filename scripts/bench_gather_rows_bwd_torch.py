#!/usr/bin/env python3
"""Time kernel C's backward (``gather_rows_lerp_bwd``) at the training
path's inputs, each held against its plain version.

The first three inputs' table is the chip-filling train config's: SB=4
latents of 64x64x512 bf16 folded into 16,384 rows; grad_out is bf16:

- ``uniform``: the coarse gather of one 256-ray chunk, 4 x 256 x 64 =
  65,536 points drawn uniformly over each view;
- ``fine``: the fine gather of the same chunk, 4 x 256 x 32 = 32,768
  points;
- ``skewed``: the uniform input with a quarter of its points (16,384, all
  of view 0) moved into one cell, so that four rows take 16,384 taps each;
- ``dtu``: the DTU train step's coarse gather (``conf/exp/dtu.conf``, f32
  as the train app runs it, ``-V 3``): 4 objects x 3 source views of
  150x200x512 latents folded into 360,000 float32 rows, 4 x 128 rays x 64
  samples x 3 views = 98,304 points drawn uniformly over each view,
  float32 grad_out.

One JSON line per input: the kernel's and the plain version's device time
(CUDA events), whether two launches give the same bits, the largest error
of each output, the bound (bytes: grad_out, idx, w and the table rows
that a tap reads read once, grad_table and grad_w written once, at 3.35
TB/s), the device launches of one call with the time of each
(``torch.profiler``), and the host's time to enqueue one call (no
synchronisation: when it exceeds the device time, back-to-back calls are
timed by the host).

Usage, on a machine with one NVIDIA GPU, from the repository root:
``python3 scripts/bench_gather_rows_bwd_torch.py``
"""
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

C = 512
# per input: views, latent height and width, points per view, table and grad_out dtype
INPUTS = {
    "uniform": (4, 64, 64, 256 * 64, torch.bfloat16),
    "fine": (4, 64, 64, 256 * 32, torch.bfloat16),
    "skewed": (4, 64, 64, 256 * 64, torch.bfloat16),
    "dtu": (12, 150, 200, 128 * 64, torch.float32),
}
PEAK_BYTES = 3.35e12


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


def make_inputs(dev, g, kind):
    """(table, idx, w, grad_out) of input ``kind`` from generator ``g``."""
    from pixelnerf_tpu_torch.ops.grid_sample import bilinear_corners

    views, hl, wl, per_view, dtype = INPUTS[kind]
    table = torch.randn((views * hl * wl, C), generator=g).to(dtype).to(dev)
    ix = torch.rand((views, per_view), generator=g) * (wl - 1)
    iy = torch.rand((views, per_view), generator=g) * (hl - 1)
    if kind == "skewed":
        # view 0's points all fall in the cell whose top-left pixel is (20, 30)
        ix[0] = 20 + torch.rand(per_view, generator=g) * 0.999
        iy[0] = 30 + torch.rand(per_view, generator=g) * 0.999
    idx, w = bilinear_corners(ix.to(dev), iy.to(dev), hl, wl)
    idx = idx + (torch.arange(views, device=dev, dtype=torch.int32) * (hl * wl))[:, None, None]
    grad_out = torch.randn((views * per_view, C), generator=g).to(dtype).to(dev)
    return table, idx.reshape(-1, 4).contiguous(), w.reshape(-1, 4).contiguous(), grad_out


def bound_ms(table, idx, grad_out):
    """Bytes: grad_out, idx and w read once, the table rows that some tap
    reads (their ``grad_w`` dots need them) read once; grad_table and
    grad_w written once."""
    n = grad_out.shape[0]
    row_bytes = table.shape[1] * table.element_size()
    touched = torch.unique(idx).numel()
    return (grad_out.numel() * grad_out.element_size() + touched * row_bytes + table.shape[0] * row_bytes
            + n * 32 + n * 16) / PEAK_BYTES * 1e3


def same_bits(a, b):
    """Whether two tensors of one dtype hold the same bits."""
    view = {torch.bfloat16: torch.int16, torch.float32: torch.int32}[a.dtype]
    return bool(torch.equal(a.view(view), b.view(view)))


def host_us(fn, reps=20):
    """Host microseconds to enqueue one call of ``fn``, the device left to run."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return us


def device_launches(fn):
    """The device activities (kernels, memsets) of one call of ``fn``, by
    name: count and device time in microseconds, from ``torch.profiler``."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [{"name": ev.key[:80], "count": ev.count, "us": ev.self_device_time_total}
            for ev in prof.key_averages() if ev.device_type == torch.autograd.DeviceType.CUDA]


def run_one(dev, g, kind):
    from pixelnerf_tpu_torch.ops.gather_rows import gather_rows_lerp_bwd, gather_rows_lerp_bwd_plain

    table, idx, w, grad_out = make_inputs(dev, g, kind)
    gt, gw = gather_rows_lerp_bwd(table, idx, w, grad_out)
    gt2, gw2 = gather_rows_lerp_bwd(table, idx, w, grad_out)
    torch.cuda.synchronize()
    rt, rw = gather_rows_lerp_bwd_plain(table, idx, w, grad_out)
    res = {
        "input": kind, "table": list(table.shape), "table_dtype": str(table.dtype), "points": idx.shape[0],
        "two_launches_bit_equal": same_bits(gt, gt2) and same_bits(gw, gw2),
        "max_abs_err": {"grad_table": (gt.float() - rt.float()).abs().max().item(),
                        "grad_w": (gw - rw).abs().max().item()},
        "max_abs_ref": {"grad_table": rt.float().abs().max().item(), "grad_w": rw.abs().max().item()},
        "ms": time_ms(lambda: gather_rows_lerp_bwd(table, idx, w, grad_out)),
        "plain_ms": time_ms(lambda: gather_rows_lerp_bwd_plain(table, idx, w, grad_out), reps=5),
        "bound_ms": bound_ms(table, idx, grad_out), "bound_by": "bytes",
    }
    launches = device_launches(lambda: gather_rows_lerp_bwd(table, idx, w, grad_out))
    res["device_launches_per_call"] = sum(x["count"] for x in launches)
    res["device_us_per_call"] = sum(x["us"] for x in launches)
    res["device_launches"] = launches
    res["host_us_per_call"] = host_us(lambda: gather_rows_lerp_bwd(table, idx, w, grad_out))
    return res


def run(dev):
    from pixelnerf_tpu_torch.ops import _build

    _build.build(["gather_rows"])
    g = torch.Generator().manual_seed(0)
    return [run_one(dev, g, kind) for kind in INPUTS]


def main():
    if not torch.cuda.is_available():
        print("bench_gather_rows_bwd_torch: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    for res in run(torch.device("cuda")):
        print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
