#!/usr/bin/env python3
"""Repeated launches of the fused MLP kernels (B, B with ``z_is_tz``, D, B's
multi-view mode) on one NVIDIA GPU: every launch must reproduce the first
bit for bit, and the first must agree with the plain PyTorch version.

The kernels' body (``pixelnerf_tpu_torch/csrc/mlp_body.cuh``) orders a
producer and two consumer warpgroups with ``mbarrier``s; a fault in that
ordering shows as a rare launch whose output differs in whole 64-row tiles,
or as a launch failure, and only under load (late weight slabs, several
tiles per block). The comparison with the plain version of
``chip_smoke.py`` and the ``cuda`` tests does not see a fault of one launch
in a hundred; this does. Run it after any edit of the body's barriers.

Against the plain version a kernel is held to
``ops.fused_mlp.disagreement_with_plain``: a few elements among millions may
lie outside the tolerance where a bf16 rounding fell the other way. To show
what such flips alone do, the plain version is also held against itself with
the hidden units permuted (the same function, its float32 sums in another
order): ``plain_vs_reordered_plain`` is measured as the kernel is.

Usage: ``python3 scripts/stress_fused_mlp_torch.py [--mode b|tz|d|mv|all]
[--d_hidden 64 128 256 512] [--rows 1048576] [--launches 200]
[--fc1_scale 0.1]``. ``mv`` is B's multi-view mode: the rows as one scene
of 3 views of ``rows // 3`` points (the DTU model's 3 source views). Prints
one JSON line per mode and width (launches that differ, the disagreement
with the plain version, mean ms) and exits non-zero if any launch differs
or disagrees.
"""
import argparse
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

N_BLOCKS, N_LIN_Z = 5, 3
VIEWS = 3          # the multi-view mode's source views
MODES = ["b", "tz", "d", "mv"]


def make_case(mode, dh, n, dev, g, fc1_scale=0.1):
    """(wrapper, plain version, arguments) of one kernel at ``n`` rows of a
    5-block MLP ``dh`` wide with 3 injections, weights from ``g``; in the
    multi-view mode ``n`` is rounded down to whole points of its views."""
    import functools

    from pixelnerf_tpu_torch.models.resnetfc import ResnetFC
    from pixelnerf_tpu_torch.ops import fused_field, fused_mlp
    from pixelnerf_tpu_torch.ops.grid_sample import bilinear_pair_bases

    torch.manual_seed(0)      # the layers' own initialisation
    mlp = ResnetFC(d_in=42, d_latent=dh, d_hidden=dh, n_blocks=N_BLOCKS, combine_layer=N_LIN_Z,
                   dtype=torch.bfloat16)
    with torch.no_grad():
        for blk in mlp.blocks:    # fc_1 starts at zero: move it off, so that every block counts
            blk.fc_1.weight.copy_(torch.randn(blk.fc_1.weight.shape, generator=g) * fc1_scale)
    mlp = mlp.to(dev)

    def rows(width):
        return torch.randn((n, width), generator=g).to(torch.bfloat16).to(dev)

    if mode == "mv":
        n -= n % VIEWS
        kw = dict(views=VIEWS, points=n // VIEWS)
        return (functools.partial(fused_mlp.fused_resnetfc_infer, **kw),
                functools.partial(fused_mlp.fused_resnetfc_infer_plain, **kw),
                (rows(dh), rows(42), fused_mlp.pack_weights(mlp), N_BLOCKS, N_LIN_Z))
    x = rows(42)
    if mode == "b":
        return (fused_mlp.fused_resnetfc_infer, fused_mlp.fused_resnetfc_infer_plain,
                (rows(dh), x, fused_mlp.pack_weights(mlp), N_BLOCKS, N_LIN_Z))
    if mode == "tz":
        return (fused_mlp.fused_resnetfc_infer, fused_mlp.fused_resnetfc_infer_plain,
                (rows(N_LIN_Z * dh), x, fused_mlp.pack_weights(mlp, with_wz=False), N_BLOCKS, N_LIN_Z, True))
    side = 64
    table = torch.randn((side * side, dh), generator=g).to(torch.bfloat16).to(dev)
    ix, iy = ((torch.rand(n, generator=g) * (side - 1)).to(dev) for _ in range(2))
    base, wg = bilinear_pair_bases(ix, iy, side, side)
    return (fused_field.fused_gather_resnetfc_infer, fused_field.fused_gather_resnetfc_infer_plain,
            (table, base, wg, x, fused_mlp.pack_weights(mlp), N_BLOCKS, N_LIN_Z, side))


def mlp_inputs(mode, args):
    """``(z, x, weights, z_is_tz)`` of the MLP inside a case: kernel D's
    latents are its plain gather's."""
    from pixelnerf_tpu_torch.ops.gather import gather_bilerp_plain

    if mode == "d":
        table, base, wg, x, weights = args[:5]
        return gather_bilerp_plain(table, base, wg, args[7], torch.bfloat16), x, weights, False
    return args[0], args[1], args[2], mode == "tz"


def reordered(z, weights, z_is_tz, perm):
    """The same MLP with its hidden units in the order ``perm``: every
    output is the same sum with its terms in another order. Returns the
    weight tuple and z (with ``z_is_tz`` the injections follow the units)."""
    win, bin_, wz, bz, w0, b0, w1, b1, wout, bout = weights
    dh = perm.numel()

    def by_block(t):      # (n_lin_z*dh, ...) stacked per injection
        return None if t is None else t.reshape(N_LIN_Z, dh, *t.shape[1:])[:, perm].reshape(t.shape)

    w = (win[perm], bin_[perm], by_block(wz), by_block(bz), w0[:, perm][:, :, perm], b0[:, perm],
         w1[:, perm][:, :, perm], b1[:, perm], wout[:, perm], bout)
    if z_is_tz:
        z = z.reshape(-1, N_LIN_Z, dh)[:, :, perm].reshape(z.shape)
    return tuple(None if t is None else t.contiguous() for t in w), z.contiguous()


def against_plain(mode, args, first, chunk=131072):
    """The kernel's first output, and the reordered plain version's, against
    the plain version on every row (by chunks: the plain version holds
    float32 copies of its hidden values)."""
    from pixelnerf_tpu_torch.ops.fused_mlp import disagreement_with_plain, fused_resnetfc_infer_plain

    z, x, weights, tz = mlp_inputs(mode, args)
    perm = torch.randperm(weights[0].shape[0], generator=torch.Generator().manual_seed(1)).to(z.device)
    w_perm, z_perm = reordered(z, weights, tz, perm)
    refs, peaks, others = [], [], []
    views = VIEWS if mode == "mv" else 1
    points = z.shape[0] // views
    for lo in range(0, points, chunk // views):
        hi = min(lo + chunk // views, points)

        def part(t):    # the points lo..hi of every view
            return t.reshape(views, points, -1)[:, lo:hi].reshape(views * (hi - lo), -1)

        kw = dict(views=views, points=hi - lo)
        ref, peak = fused_resnetfc_infer_plain(part(z), part(x), weights, N_BLOCKS, N_LIN_Z, tz, hidden_max=True,
                                               **kw)
        refs.append(ref)
        peaks.append(peak)
        others.append(fused_resnetfc_infer_plain(part(z_perm), part(x), w_perm, N_BLOCKS, N_LIN_Z, tz, **kw))
    ref, peak = torch.cat(refs), torch.cat(peaks)
    return (disagreement_with_plain(first, ref, peak), disagreement_with_plain(torch.cat(others), ref, peak),
            peak.max().item())


def stress(mode, dh, n, launches, dev, fc1_scale):
    from pixelnerf_tpu_torch.ops.fused_mlp import agrees_with_plain

    run, _, args = make_case(mode, dh, n, dev, torch.Generator().manual_seed(0), fc1_scale)
    with torch.inference_mode():
        first = run(*args)
        torch.cuda.synchronize()
        kernel, plain_reordered, peak = against_plain(mode, args, first)
        differ = 0
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        done = 0
        while done < launches:
            outs = [run(*args) for _ in range(min(4, launches - done))]   # back to back, then compared
            done += len(outs)
            differ += sum(int(not torch.equal(o, first)) for o in outs)
        end.record()
        torch.cuda.synchronize()
    return {"mode": mode, "d_hidden": dh, "rows": n, "launches": launches, "launches_that_differ": differ,
            "agrees_with_plain": agrees_with_plain(kernel), "kernel_vs_plain": kernel,
            "plain_vs_reordered_plain": plain_reordered, "largest_hidden_magnitude": peak,
            "ms_with_compare": start.elapsed_time(end) / launches}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", default="all", choices=MODES + ["all"])
    ap.add_argument("--d_hidden", type=int, nargs="+", default=[64, 128, 256, 512])
    ap.add_argument("--rows", type=int, default=1048576)
    ap.add_argument("--launches", type=int, default=200)
    ap.add_argument("--fc1_scale", type=float, default=0.1, help="standard deviation of the fc_1 weights")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("stress_fused_mlp_torch: this needs an NVIDIA GPU", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    failed = False
    for dh in a.d_hidden:
        for mode in (MODES if a.mode == "all" else [a.mode]):
            res = stress(mode, dh, a.rows, a.launches, torch.device("cuda"), a.fc1_scale)
            print(json.dumps({**res, "card": card}), flush=True)
            failed |= bool(res["launches_that_differ"]) or not res["agrees_with_plain"]
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
