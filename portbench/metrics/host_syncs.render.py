"""The host's waits on the device a view (``cudaStreamSynchronize``,
``cudaDeviceSynchronize``, ``cudaEventSynchronize``, synchronous
``cudaMemcpy``) made inside the program's ``request`` and ``rays`` spans,
in a profiled window with the program's spans on
(``harness/program_spans.py``). Each drains the queue that hides the
host's Python behind the device's work."""
from portbench.harness import program_spans


def read(run):
    return program_spans.read(run, "host_syncs")
