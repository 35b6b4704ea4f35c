"""The renderer's device ms a view, in the cells that report ``scene_rays_per_s``
(multi-view scenes): read as ``renderer_ms.render`` reads it."""
from portbench.harness.spec import load_reader

read = load_reader("renderer_ms.render")
