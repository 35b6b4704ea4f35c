"""Device ms a view of the work launched under the program's ``field.mlp``
spans (``PixelNeRFNet.query_mlp``): at three source views the dense bf16
chain (cuBLAS products and elementwise work), kernel B being gated to one
view; in a profiled window with the program's spans on
(``harness/program_spans.py``)."""
from portbench.harness import program_spans


def read(run):
    return program_spans.read(run, "mlp_ms")
