"""With the timed path broken underneath, a run comes out not correct: once
for each fault a cell can have (``portbench/faults.py``), and for the
control, the reference one precision step below the configuration's in the
program's place. The harness's look for a card is skipped; the rest of a
run is driven at a size a CPU test holds."""
import time

import pytest
from small_cells import SEED, small_cell, spec

from portbench import faults, run
from portbench.harness import checks, render_cell, train_cell

CELLS = [w["name"] for w in spec.known(spec.benchmark())["workloads"]]
CASES = [(c, f) for c in CELLS
         for f in (faults.RENDER if small_cell(c).traffic["kind"] == "render" else faults.TRAIN)
         if faults.applies(small_cell(c).traffic["kind"], f, small_cell(c).config)]


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    c = small_cell(cell)
    result, _ = run.execute(c, SEED, 0.2, False, "cpu", time.perf_counter())
    assert result["correct"], result["checks"]


@pytest.mark.parametrize("cell,fault", CASES)
def test_a_planted_fault_is_not_correct(cell, fault):
    c = small_cell(cell)
    with faults.planted(c.traffic["kind"], fault):
        result, _ = run.execute(c, SEED, 0.2, False, "cpu", time.perf_counter())
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    c = small_cell(cell)
    runner = render_cell if c.traffic["kind"] == "render" else train_cell
    out = runner.run(c, SEED, 0.2, False, "cpu", controls=(c.traffic["control"],))
    ok, table = checks.judge(out["controls"][c.traffic["control"]], c.limits, 0)
    assert not ok, table
