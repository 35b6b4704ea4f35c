"""Mean ms a step waits on the input pipeline's ``next()`` (the readers:
``data/srn.py`` decode, ``data/pipeline.py`` sampling and prefetch) in the
unprofiled window."""


def read(run):
    return run.mean_ms("batch_wait")
