"""The plain reference agrees with pixelnerf_tpu_torch on the same weights,
images, poses and draws, at a size a CPU test holds; it imports nothing of
the program or of JAX."""
import ast
import os

import numpy as np
import pytest
import torch
from small_cells import CHECKOUT, SEED, small_cell

from portbench.harness import dataset, render_cell, train_cell
from portbench.reference import png

PLAIN = ("reference", "accounting")


@pytest.mark.parametrize("folder", PLAIN)
def test_the_plain_parts_import_nothing_of_the_program_or_jax(folder):
    root = os.path.join(CHECKOUT, "portbench", folder)
    for f in os.listdir(root):
        if not f.endswith(".py"):
            continue
        tree = ast.parse(open(os.path.join(root, f)).read())
        for node in ast.walk(tree):
            names = [a.name for a in node.names] if isinstance(node, ast.Import) else (
                [node.module or ""] if isinstance(node, ast.ImportFrom) and node.level == 0 else [])
            for n in names:
                assert n.split(".")[0] not in ("pixelnerf_tpu_torch", "pixelnerf_tpu", "jax", "jaxlib", "flax"), (f, n)


@pytest.mark.parametrize("name", ["srn.render", "dtu.render"])
def test_render_reference_agrees_with_the_program_in_float32(name):
    torch.manual_seed(0)
    cell = small_cell(name)
    cell.traffic.update(dtype="float32", fast=False)
    out = render_cell.run(cell, SEED, 0.5, False, "cpu")
    assert out["failed"] == 0 and out["attempted"] >= 1
    n = out["numbers"]
    for k in ("latent_rel_err", "rgb_mae", "depth_mae"):
        assert n[k] < 1e-5, (k, n[k])
    # the errors over the reference's own at bf16, which is a few 1e-3
    for k in ("rgb_over_bf16", "depth_over_bf16"):
        assert n[k] < 1e-2, (k, n[k])


def test_train_reference_draws_the_same_batches_and_follows_three_steps():
    cell = small_cell("srn.train.cached")
    out = train_cell.run(cell, SEED, 0.5, False, "cpu")
    n = out["numbers"]
    assert n["reader_pixels"] == 0.0 and n["reader_geometry"] == 0.0
    assert n["loss_gap_1"] < 1e-5 and n["grad_gap_1"] < 1e-3 and n["change_gap_med"] < 1e-2, n


def test_png_writer_and_reader_round_trip_with_every_row_filter():
    rng = np.random.default_rng(3)
    yy, xx = np.mgrid[:40, :56]
    img = np.stack([(xx * 4) % 256, (yy * 6) % 256, (xx * yy) % 256], -1).astype(np.uint8)
    img[::7] = rng.integers(0, 256, img[::7].shape, dtype=np.uint8)
    path = os.path.join(os.environ.get("TMPDIR", "/tmp"), f"portbench_rt_{os.getpid()}.png")
    try:
        with open(path, "wb") as f:
            f.write(dataset.encode_png(img))
        raw = open(path, "rb").read()
        import zlib
        start = raw.index(b"IDAT") + 4
        rows = np.frombuffer(zlib.decompress(raw[start:start + int.from_bytes(raw[start - 8:start - 4], "big")]),
                             np.uint8).reshape(40, -1)
        assert len(set(rows[:, 0].tolist())) >= 3, "the heuristic chose several filters"
        np.testing.assert_array_equal(png.read(path), img)
        from pixelnerf_tpu_torch.utils import png as program_png
        np.testing.assert_array_equal(program_png.imread(path), img)
    finally:
        os.unlink(path)
