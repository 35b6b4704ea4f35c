"""The whole render's share of the bf16 peak in the unprofiled window: the
model's operations for the window's views (the field on every sample, the
layers before the views' mean once a source view; the encoder once a
session and source view) over the window's length."""
from portbench.accounting import encoder, mlp, peaks


def read(run):
    if not run.work.get("rays"):
        return None
    cfg = run.config
    h, w = cfg["camera"]["image_size"]
    ns = cfg["source_views"]
    flops = (run.work["rays"] * mlp.render_ray_flops(cfg["model"], cfg["renderer"], ns)
             + run.work["sessions"] * ns * encoder.encoder_image_flops(cfg["model"]["encoder"], h, w))
    return 100.0 * flops / (run.window_s * peaks.BF16_FLOPS)
