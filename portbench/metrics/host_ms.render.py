"""Mean host ms a view inside the program's ``request`` and ``rays`` spans
(``FullRenderer.render_image``, ``utils/geometry.gen_rays``): the request's
host side, waits on the device included, in an unprofiled window with the
program's spans on (``harness/program_spans.py``)."""
from portbench.harness import program_spans


def read(run):
    return program_spans.read(run, "host_ms")
