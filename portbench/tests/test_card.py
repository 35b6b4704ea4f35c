"""On the card, at the cells' own sizes: a short run of each cell is
correct, and its control (the reference one precision step below the
configuration's, in the program's place) is not. Skips without a GPU;
run on the card with ``python -m pytest -m cuda portbench/tests/test_card.py``."""
import pytest
from small_cells import SEED, spec

from portbench.harness import checks, render_cell, train_cell

CELLS = [w["name"] for w in spec.known(spec.benchmark())["workloads"]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_is_correct_and_its_control_is_not(card, cell):
    c = spec.Cell(spec.known(spec.benchmark()), cell)
    runner = render_cell if c.traffic["kind"] == "render" else train_cell
    out = runner.run(c, SEED, 2.0, False, card, controls=(c.traffic["control"],))
    ok, table = checks.judge(out["numbers"], c.limits, out["failed"])
    assert ok, table
    ok, table = checks.judge(out["controls"][c.traffic["control"]], c.limits, 0)
    assert not ok, table
