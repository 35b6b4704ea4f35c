"""The share of the profiled training window in which no operation ran on
the device, from the trace's own timeline."""


def read(run):
    return run.idle_share()
