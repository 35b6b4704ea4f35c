"""The share of the profiled render window in which no operation ran on
the device, from the trace's own timeline."""


def read(run):
    return run.idle_share()
