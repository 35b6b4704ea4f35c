#!/usr/bin/env python3
"""Probe the CUDA formulations of the weighted 4-row gather.

The counterpart, for the PyTorch/CUDA port, of
``scripts/probe_gather_kernels.py``: builds ``csrc/gather_study.cu``,
reports each kernel's registers and spills from ``ptxas``, runs every
formulation on small shapes (a 256 x 512 table, 512 points of 4 taps, tiles
of 128) from a float32 and a bf16 table, and checks it against the einsum
reference (tolerance 1e-4 for float32, 0.02 for bf16, as in the original).
A formulation that fails to launch or disagrees is a printed line, not an
error.

Usage, on a machine with one NVIDIA GPU, from the repository root:
``python3 scripts/probe_gather_kernels_torch.py``
"""
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

R, C = 256, 512
TILE = 128
N = 512

# the original's probes and the formulation that reads each on Hopper:
# (name, formulation, where the original kept idx and w)
PROBES = [
    ("loop_ds", "warp_direct", "smem"),
    ("loop_ds", "warp_direct", "vmem"),
    ("take", "thread_global_idx", "vmem"),
    ("adv_index", "thread_global_idx", "vmem"),
    ("take", "thread_smem_idx", "smem"),
    ("block_mask", "block_stage", "smem"),
]
# a piece of each formulation's kernel name in the compiler's log
# (block_stage: its serving kernel, after the binning passes; thread_*: the
# kernel for C <= 1024, the probe's width)
KERNEL_OF = {
    "warp_direct": "warp_direct_kernelI{t}E",
    "thread_global_idx": "thread_per_group_kernelI{t}Lb0ELb0EE",
    "thread_smem_idx": "thread_per_group_kernelI{t}Lb1ELb0EE",
    "block_stage": "block_stage_serve_kernelI{t}E",
}
MANGLED_TYPE = {torch.float32: "f", torch.bfloat16: "13__nv_bfloat16"}


def resources(entries, formulation, dtype):
    """ptxas' registers and spill bytes of one formulation's kernel."""
    piece = KERNEL_OF[formulation].format(t=MANGLED_TYPE[dtype])
    for name, res in entries.items():
        if piece in name:
            return res
    return {}


def inputs(dtype, device):
    rng = np.random.default_rng(0)
    table = torch.from_numpy(rng.normal(size=(R, C)).astype(np.float32)).to(dtype)
    idx = rng.integers(0, R, (N, 4)).astype(np.int32)
    w = rng.uniform(0, 1, (N, 4)).astype(np.float32)
    ref = np.einsum("nk,nkc->nc", w, table.float().numpy()[idx])
    return table.to(device), torch.from_numpy(idx).to(device), torch.from_numpy(w).to(device), ref


def run(device):
    """Every probe on both table dtypes: a list of result dicts."""
    from pixelnerf_tpu_torch.ops import _build
    from pixelnerf_tpu_torch.ops.gather_study import gather_study

    entries = _build.ptxas_entries(_build.ptxas_log("gather_study"))
    results = []
    for dtype, dtn in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        table, idx, w, ref = inputs(dtype, device)
        tol = 0.02 if dtype == torch.bfloat16 else 1e-4
        for name, formulation, space in PROBES:
            res = {"name": f"{name} {dtn} idx={space}", "formulation": formulation, "table": dtn,
                   "tolerance": tol, **resources(entries, formulation, dtype)}
            try:
                out = gather_study(table, idx, w, formulation, tile=TILE)
                torch.cuda.synchronize()
                res["max_abs_err"] = float(np.max(np.abs(out.cpu().numpy() - ref)))
                res["ok"] = res["max_abs_err"] < tol
            except Exception as e:   # a failed formulation is a finding here
                res["ok"] = False
                res["error"] = f"{type(e).__name__}: {str(e).splitlines()[0][:140]}"
            results.append(res)
    return results


def main():
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    for res in run(torch.device("cuda")):
        regs = f"{res.get('registers', '?')} regs, {res.get('spill_stores', '?')}+{res.get('spill_loads', '?')} B spilled"
        if "error" in res:
            print(f"{res['name']} [{res['formulation']}]: FAIL {res['error']}")
        else:
            status = "OK " if res["ok"] else "WRONG"
            print(f"{res['name']} [{res['formulation']}]: {status} max|err|={res['max_abs_err']:.5f} ({regs})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
