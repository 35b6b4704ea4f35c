"""On the card, in each render cell's profiled window with the program's
spans on (``harness/program_spans.py``): kernel B's device time goes to
``field.mlp``, kernel A's to ``field.features``, every launch is linked to
its runtime call, and the spans' device seconds with ``(outside)`` sum to
the window's. Skips without a GPU; run on the card with
``python -m pytest -m cuda portbench/tests/test_card_spans.py``."""
import pytest
from small_cells import SEED, spec

from portbench.harness import program_spans

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return "cuda"


def _share(spans, part, span):
    """The share of the device time of the kernels named with ``part`` that
    went to ``span``."""
    t = {n: sum(s for k, s in v["kernels"].items() if part in k) for n, v in spans.items()}
    return t.get(span, 0.0) / sum(t.values())


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_each_kernel_goes_to_its_layers_span(card, cell):
    c = spec.Cell(spec.benchmark(), cell)
    if c.traffic["kind"] != "render":
        pytest.skip("the program's spans are read in the render cells")
    out = program_spans.measure(c, SEED, 2.0, card)
    spans = out["detail"]["spans"]
    assert program_spans.UNLINKED not in spans and out["dropped"] == 0
    assert sum(v["device_s"] for v in spans.values()) == pytest.approx(out["detail"]["device_s"], rel=1e-9)
    assert _share(spans, "gather_bilerp", "field.features") >= 0.99
    if c.config["source_views"] == 1:
        assert _share(spans, "fused_mlp_kernel", "field.mlp") >= 0.99
    else:
        assert not any("fused_mlp_kernel" in k for v in spans.values() for k in v["kernels"])
        assert out["mlp_ms"] > out["renderer_ms"]
