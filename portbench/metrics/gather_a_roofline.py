"""Kernel A's (``csrc/gather.cu``) share of its roofline in the profiled
window: the bytes its points must move (a record and an output row a
point, and for each of A's launches in the trace the latent map's rows
once: the whole map, an upper bound on the rows a launch touches) at the
HBM bandwidth, or its lerps at the float32 peak if that is longer, over
A's device time in the trace. Bytes bound it."""
from portbench.accounting import encoder, gather, peaks


def read(run):
    t = run.kernel_seconds("gather_bilerp")
    if not t:
        return None
    h, w = run.config["camera"]["image_size"]
    enc = run.config["model"]["encoder"]
    _, _, _, hl, wl = encoder.conv_layers(enc["backbone"], enc["num_layers"], h, w)[0]
    table = run.config["source_views"] * hl * wl
    c = enc["latent_size"]
    points, launches = run.traced_work["gather_points"], run.kernel_launches("gather_bilerp")
    moved = gather.gather_bytes(points, c, 0) + launches * gather.gather_bytes(0, c, table)
    bound = max(moved / peaks.HBM_BYTES, gather.gather_flops(points, c) / peaks.F32_FLOPS)
    return 100.0 * bound / t
