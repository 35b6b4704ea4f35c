#!/usr/bin/env python3
"""Readings that a cell's correctness limits are set from, in one process:
the program's numbers on ``--seeds`` seeds (each a short window at the
cell's own load and sizes), its control's (the reference one precision
step below the configuration's, in the program's place) on the first
``--controls`` of them, and each planted fault's (``portbench/faults.py``)
on the first ``--faults``. One JSON line a reading.

    python3 portbench/calibrate.py --workload srn.render --seeds 12 --controls 3 --faults 3 --seconds 3
"""
import argparse
import gc
import json
import os
import sys
import time

CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if CHECKOUT not in sys.path:
    sys.path.insert(0, CHECKOUT)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--controls", type=int, default=3)
    p.add_argument("--faults", type=int, default=3)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--first_seed", type=int, default=3_000_000_017)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    import torch

    from portbench import faults
    from portbench.harness import device as dev_mod, render_cell, spec, train_cell

    dev_mod.set_caches(CHECKOUT)
    cell = spec.Cell(spec.known(spec.benchmark()), args.workload)
    if args.device == "cuda":
        dev_mod.require_cards(cell.chips)
    kind = cell.traffic["kind"]
    runner = {"render": render_cell, "train": train_cell}[kind]
    for i in range(args.seeds):
        seed = args.first_seed + 7919 * i
        controls = (cell.traffic["control"],) if i < args.controls else ()
        t0 = time.perf_counter()
        out = runner.run(cell, seed, args.seconds, False, args.device, controls=controls)
        print(json.dumps({"workload": cell.name, "seed": seed, "side": "program", "numbers": out["numbers"],
                          "attempted": out["attempted"], "failed": out["failed"], "look": out.get("look"),
                          "seconds": time.perf_counter() - t0}), flush=True)
        for c, numbers in out["controls"].items():
            print(json.dumps({"workload": cell.name, "seed": seed, "side": f"control.{c}", "numbers": numbers}),
                  flush=True)
        del out
        gc.collect()
        if args.device == "cuda":
            torch.cuda.empty_cache()
        if i < args.faults:
            for fault in (faults.RENDER if kind == "render" else faults.TRAIN):
                if not faults.applies(kind, fault, cell.config):
                    continue
                with faults.planted(kind, fault):
                    out = runner.run(cell, seed, min(args.seconds, 1.0), False, args.device)
                print(json.dumps({"workload": cell.name, "seed": seed, "side": f"fault.{fault}",
                                  "numbers": out["numbers"], "failed": out["failed"]}), flush=True)
                del out
                gc.collect()
    return 0


if __name__ == "__main__":
    sys.exit(main())
