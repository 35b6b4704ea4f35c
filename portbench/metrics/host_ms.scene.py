"""The request's host side a view, in the cells that report ``scene_rays_per_s``
(multi-view scenes): read as ``host_ms.render`` reads it."""
from portbench.harness.spec import load_reader

read = load_reader("host_ms.render")
