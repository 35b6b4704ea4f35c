"""Kernel B's (``csrc/fused_mlp.cu``) share of its roofline in the
profiled window: the field operations of every MLP row its views need, at
the bf16 peak, over B's device time in the trace. Operations bound it
(7 MFLOP a row against ~1 KB of inputs)."""
from portbench.accounting import mlp, peaks


def read(run):
    t = run.kernel_seconds("fused_mlp_kernel")
    if not t:
        return None
    flops = run.traced_work["field_rows"] * mlp.config_point_flops(run.config["model"], run.config["source_views"])
    return 100.0 * flops / peaks.BF16_FLOPS / t
