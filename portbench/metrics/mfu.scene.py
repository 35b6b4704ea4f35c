"""The whole render's share of the bf16 peak, in the cells that report ``scene_rays_per_s``
(multi-view scenes): read as ``mfu.render`` reads it."""
from portbench.harness.spec import load_reader

read = load_reader("mfu.render")
