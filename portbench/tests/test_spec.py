"""BENCHMARK.json holds to its contract, and the harness finds every file
it names by name."""
import os
import re

import pytest
from small_cells import CHECKOUT, spec

from portbench.harness import record

BENCH = spec.benchmark()
KNOWN = spec.known(BENCH)
TOP = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
TEXT = re.compile(r"^[^\t\n]{1,200}$")


def test_top_level_keys_and_command():
    assert set(BENCH) == TOP
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_each_config_file_loads_and_names_its_cuts(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert entry["file"] == os.path.relpath(spec.config_file(entry["name"]), CHECKOUT)
    cfg = spec.load_json(os.path.join(CHECKOUT, entry["file"]))
    assert cfg["reduced"] == entry["reduced"] and cfg["source"] == entry["source"]
    for key in entry["reduced"]:
        assert spec.NAME.match(key) and key in cfg["published"]
        assert not key.endswith(("_dim", "_rank", "_size")), "a width is never cut"


@pytest.mark.parametrize("cell", [w["name"] for w in KNOWN["workloads"]])
def test_each_cell_loads_its_files_and_reports_what_it_must(cell):
    c = spec.Cell(KNOWN, cell)
    assert set(c.entry) == {"name", "config", "traffic", "chips", "why"} and c.chips in (1, 4)
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer
    assert os.path.exists(spec.limits_file(cell)), "each cell carries its correctness limits"
    for m in c.per_layer:
        assert m["moves"] in names, f"{m['name']} moves {m['moves']}, which {cell} does not report"


@pytest.mark.parametrize("metric", KNOWN["per_layer"], ids=lambda m: m["name"])
def test_each_per_layer_metric_has_a_reader_that_returns_nothing_on_an_empty_trace(metric):
    read = spec.load_reader(metric["name"])
    cell = spec.Cell(KNOWN, metric["workloads"][0])
    empty = record.RunRecord(cell, {"work": {}, "spans": {}, "trace": None, "window_s": 1.0})
    assert read(empty) is None


def test_names_units_and_texts_use_the_allowed_characters():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    for m in metrics:
        assert spec.NAME.match(m["name"]) and spec.UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert TEXT.match(m["layer"])
    for w in BENCH["workloads"]:
        assert spec.NAME.match(w["name"]) and spec.NAME.match(w["traffic"]) and TEXT.match(w["why"])
    for group in (BENCH["configs"], BENCH["workloads"], metrics):
        assert len({e["name"] for e in group}) == len(group)
    layers = {}
    for m in BENCH["per_layer"]:
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values()), "one layer, one spelling"


def test_shelved_cells_stay_apart_from_the_measured_ones():
    shelved = spec.known({"workloads": [], "end_to_end": [], "per_layer": []})
    names = {e["name"] for group in shelved.values() for e in group}
    assert not names & {e["name"] for k in ("workloads", "end_to_end", "per_layer") for e in BENCH[k]}
    assert all(m.get("workloads") for m in shelved["end_to_end"] + shelved["per_layer"]), \
        "a shelved metric names its cells, so no measured cell takes it"


def test_every_file_under_paths_is_named_from_name_characters():
    for dirpath, _, files in os.walk(os.path.join(CHECKOUT, "portbench")):
        if "__pycache__" in dirpath:
            continue
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), CHECKOUT)
            assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel
