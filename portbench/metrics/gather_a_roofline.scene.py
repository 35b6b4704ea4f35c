"""Kernel A's share of its roofline, in the cells that report ``scene_rays_per_s``
(multi-view scenes): read as ``gather_a_roofline`` reads it."""
from portbench.harness.spec import load_reader

read = load_reader("gather_a_roofline")
