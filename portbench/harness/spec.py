"""``BENCHMARK.json`` and the files it names, found by name: a
configuration ``configs/<config>.json``, a traffic mix
``traffic/<traffic>.json``, a cell's limits ``workloads/<cell>.json`` and a
per-layer metric's reader ``metrics/<metric>.py``."""
from __future__ import annotations

import importlib.util
import json
import os
import re

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))     # portbench/
CHECKOUT = os.path.dirname(ROOT)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(path: str = None) -> dict:
    return load_json(path or os.path.join(CHECKOUT, "BENCHMARK.json"))


def known(bench: dict) -> dict:
    """``bench`` with the cells of ``shelved.json`` beside its own: cells
    written and checked on the card but left out of ``BENCHMARK.json``
    (PERF.md, Open questions), in its layout, with their own metrics. A run
    names either kind; only ``BENCHMARK.json``'s are measured."""
    shelved = load_json(os.path.join(ROOT, "shelved.json"))
    return dict(bench, **{k: bench[k] + shelved[k] for k in ("workloads", "end_to_end", "per_layer")})


def _named(kind: str, name: str, suffix: str) -> str:
    if not NAME.match(name):
        raise ValueError(f"{kind} name {name!r} is not a valid name")
    return os.path.join(ROOT, kind, name + suffix)


def config_file(name: str) -> str:
    return _named("configs", name, ".json")


def traffic_file(name: str) -> str:
    return _named("traffic", name, ".json")


def limits_file(cell: str) -> str:
    return _named("workloads", cell, ".json")


def metric_file(name: str) -> str:
    return _named("metrics", name, ".py")


class Cell:
    """One entry of ``workloads`` with everything it names."""

    def __init__(self, bench: dict, name: str):
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json (has {sorted(cells)})")
        self.entry = cells[name]
        self.name = name
        self.chips = int(self.entry["chips"])
        self.config = load_json(config_file(self.entry["config"]))
        self.traffic = load_json(traffic_file(self.entry["traffic"]))
        path = limits_file(name)
        # a cell not yet measured has no limits: its numbers are printed, and
        # held to none, so the run is not correct
        self.limits = load_json(path).get("limits", {}) if os.path.exists(path) else {}
        self.end_to_end = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
        self.per_layer = [m for m in bench["per_layer"] if name in m.get("workloads", [name])]


def load_reader(metric: str):
    """The ``read(run)`` function of ``metrics/<metric>.py``."""
    path = metric_file(metric)
    spec = importlib.util.spec_from_file_location("portbench_metric_" + metric.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
