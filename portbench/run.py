#!/usr/bin/env python3
"""Run one cell of the benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything a cell needs is found by name from ``BENCHMARK.json``: its
configuration (``configs/``), traffic (``traffic/``), limits
(``workloads/``) and, with ``--trace 1``, its per-layer metrics'
readers (``metrics/``). The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device``, ``breakdown`` (traced runs) and ``checks`` (each compared
number beside its limit, also the last lines of standard error). Exits
non-zero with no result line where no card is visible, where the cell
needs more cards than there are, where the program is missing, or where
JAX or the JAX package was loaded.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if CHECKOUT not in sys.path:
    sys.path.insert(0, CHECKOUT)


def execute(cell, seed: int, seconds: float, traced: bool, device, t0: float):
    """Run ``cell`` on ``device``: its result, and the window's kernel
    launches by the program's counters and the seconds of each phase of the
    run (not printed here)."""
    from portbench.harness import checks, record, render_cell, spec, train_cell

    runner = {"render": render_cell, "train": train_cell}[cell.traffic["kind"]]
    out = runner.run(cell, seed, seconds, traced, device)
    out["e2e"]["setup_s"] -= t0
    correct, table = checks.judge(out["numbers"], cell.limits, out["failed"])
    if traced:
        rec = record.RunRecord(cell, out)
        metrics = {}
        for m in cell.per_layer:
            value = spec.load_reader(m["name"])(rec)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": out["e2e"][m["name"]], "unit": m["unit"]} for m in cell.end_to_end}
    from portbench.harness import device as dev_mod

    desc = dev_mod.describe(device)
    desc["memory_peak_bytes"] = out["memory"]
    result = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"], "metrics": metrics,
              "device": desc}
    if traced:
        desc["busy_s"] = out["trace"]["busy_s"]
        desc["window_s"] = out["trace"]["window_s"]
        result["breakdown"] = {"device_ops": out["trace"]["device_ops"], "idle_gaps": out["trace"]["idle_gaps"]}
    result["checks"] = table
    marks = sorted(out["phases"].items(), key=lambda kv: kv[1])
    phases = {b[0]: b[1] - a[1] for a, b in zip([("start", t0)] + marks, marks)}
    counts = {"launches": out["launches"], "phase_s": phases}
    if traced:
        # the profiler's cost: the profiled window's rate against the
        # unprofiled one's, the same work counted in each
        tw = out["trace"]["window_work"]
        counts["profiled_over_unprofiled_rate"] = (tw["rays"] / out["trace"]["host_window_s"]) / (
            out["work"]["rays"] / out["window_s"])
    return result, counts


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from portbench.harness import checks, device as dev_mod, spec

    dev_mod.set_caches(CHECKOUT)
    cell = spec.Cell(spec.known(spec.benchmark()), args.workload)
    try:
        import pixelnerf_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"portbench: the program pixelnerf_tpu_torch is not in the checkout ({e}); no result", file=sys.stderr)
        return 2
    dev_mod.require_cards(cell.chips)
    result, counts = execute(cell, args.seed, args.seconds, bool(args.trace), "cuda", T0)
    found = dev_mod.forbidden_modules()
    if found:
        print(f"portbench: loaded {found}, which the benchmark may not; no result", file=sys.stderr)
        return 3
    print(json.dumps(counts))
    checks.print_limits(result["checks"], result["failed"])
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
