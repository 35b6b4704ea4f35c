"""Mean ms of the train step's call (``train/step.py``) in the unprofiled
window, a span ended by a synchronize."""


def read(run):
    return run.mean_ms("step")
