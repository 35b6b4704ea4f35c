"""The whole training step's share of the float32 peak in the unprofiled
window: the model's forward and backward operations of the window's steps
over the window's length."""
from portbench.accounting import peaks


def read(run):
    if not run.work.get("steps"):
        return None
    return 100.0 * run.work["steps"] * run.work["step_flops"] / (run.window_s * peaks.F32_FLOPS)
