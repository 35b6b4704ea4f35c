"""Device ms a view of the work launched from the renderer's self time:
the program's ``render_rays`` spans less their ``field.*`` children, and
``render_rays.merge`` (sampling, the sort, compositing, the ``torch.cat``
copies), in a profiled window with the program's spans on
(``harness/program_spans.py``)."""
from portbench.harness import program_spans


def read(run):
    return program_spans.read(run, "renderer_ms")
