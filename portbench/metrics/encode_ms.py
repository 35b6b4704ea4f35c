"""Mean ms of ``net.encode`` (the encoder layer) in the unprofiled window,
a span ended by a synchronize, over the window's sessions."""


def read(run):
    return run.mean_ms("encode")
