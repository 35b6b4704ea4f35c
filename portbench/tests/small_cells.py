"""Cells of BENCHMARK.json at a size a CPU test run can hold: the
published widths and depths, small images, few rays and views."""
import os
import sys

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if CHECKOUT not in sys.path:
    sys.path.insert(0, CHECKOUT)

from portbench.harness import spec  # noqa: E402

SEED = 4_123_456_789


def small_cell(name: str):
    cell = spec.Cell(spec.known(spec.benchmark()), name)
    cam = cell.config["camera"]
    if cell.traffic["kind"] == "render":
        h, w = cam["image_size"]
        k = 8 if cell.config["source_views"] == 1 else 12.5
        cam["image_size"] = [int(h / k), int(w / k)]
        f = cam["focal"]
        cam["focal"] = f / k if isinstance(f, (int, float)) else [v / k for v in f]
        cam["c"] = [v / k for v in cam["c"]]
        cell.traffic["trajectory"]["num_views"] = 2 if cell.traffic["trajectory"]["kind"] == "orbit" else 5
        cell.traffic.update(check_views=2, check_rays=96, ray_chunk=128)
    else:
        cam["image_size"] = [32, 32]
        cam["focal"] = cam["focal"] / 4
        cam["c"] = [v / 4 for v in cam["c"]]
        cell.config["train_data"] = {"objects": 6, "views": 5}
        cell.traffic.update(rays_per_object=16, workers=2)
    return cell
