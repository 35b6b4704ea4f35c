"""The device's idle share, in the cells that report ``scene_rays_per_s``
(multi-view scenes): read as ``idle_share.render`` reads it."""
from portbench.harness.spec import load_reader

read = load_reader("idle_share.render")
