"""The port's evaluation apps and the train app's visual, end to end on the
CPU (``--device cpu``, a narrow ``--override`` model), on an SRN-layout
fixture, beside the JAX package's apps on the same fixture and weights:

- ``apps.eval``: the same files per object, the same ``finish.txt``
  format and objects, the resume, the printed lines; flags ``-L``,
  ``--include_src``, ``--multicat``, ``--no_compare_gt``, ``--scale``;
- ``apps.eval_approx``: the same seeded target per object as the JAX app;
- ``apps.train -F srn``: trains, writes the visual in the JAX layout, and
  takes ``--pretrained_encoder``;
- ``apps.train`` and ``apps.eval`` on the DTU (``-V 3``), NMR and
  multi-object readers;
- the import rule: the port's apps (these, ``gen_video``, ``eval_real``,
  ``calc_metrics`` and ``export_torch``) run with ``imageio``, ``PIL``,
  ``cv2`` and ``jax`` blocked, and no module of the port names them.
"""
import ast
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_port_utils import (
    REPO,
    SRN_CONF,
    TINY,
    TINY_OVERRIDES as OVERRIDES,
    write_dtu_fixture,
    write_jax_reference_weights as _jax_weights,
    write_multi_obj_fixture,
    write_nmr_fixture,
    write_srn_fixture,
)

@pytest.fixture(scope="module")
def work(tmp_path_factory):
    root = tmp_path_factory.mktemp("srn_apps")
    data = write_srn_fixture(str(root / "data"), num_views=4)
    _jax_weights(str(root / "ck" / "ref" / "pixel_nerf_latest"))
    return {"root": root, "data": data, "ck": str(root / "ck")}


def _common(work, device=True):
    args = ["-n", "ref", "-c", SRN_CONF, "-F", "srn", "-D", work["data"], "--checkpoints_path", work["ck"]]
    return args + (["--device", "cpu"] if device else ["--no_mesh"]) + TINY


def _objects(out_dir):
    return {d: sorted(os.listdir(os.path.join(out_dir, d)))
            for d in sorted(os.listdir(out_dir)) if os.path.isdir(os.path.join(out_dir, d))}


FINISH_LINE = re.compile(r"^(\S+) (-?[0-9.e+-]+) (-?[0-9.e+-]+) (\d+)$")


def test_eval_app_matches_jax_app_files_finish_and_resume(work, capsys):
    from pixelnerf_tpu.apps import eval as jax_eval
    from pixelnerf_tpu_torch.apps import eval as eval_app

    flags = ["-P", "1", "-R", "2048", "--write_depth", "--write_compare"]
    ours, ref = str(work["root"] / "eval_port"), str(work["root"] / "eval_jax")
    eval_app.main(_common(work) + flags + ["-O", ours])
    out_port = capsys.readouterr().out
    jax_eval.main(_common(work, device=False) + flags + ["-O", ref])
    out_jax = capsys.readouterr().out
    assert "Loaded reference torch checkpoint" in out_port and "Loaded reference torch checkpoint" in out_jax

    assert _objects(ours) == _objects(ref)
    assert _objects(ours)["test0"] == sorted(f"{v:06d}{s}" for v in (0, 2, 3)
                                             for s in (".png", "_compare.png", "_depth.exr", "_depth_norm.png"))
    finish = open(os.path.join(ours, "finish.txt")).read().splitlines()
    finish_jax = open(os.path.join(ref, "finish.txt")).read().splitlines()
    assert [FINISH_LINE.match(l).group(1, 4) for l in finish] == [FINISH_LINE.match(l).group(1, 4) for l in finish_jax]
    # the same weights, renders that differ only in their random draws
    for a, b in zip(finish, finish_jax):
        assert abs(float(a.split()[1]) - float(b.split()[1])) < 0.5, (a, b)
    shape = lambda line: re.sub(r"-?\d+\.\d+", "x", line)  # noqa: E731
    printed = [shape(l) for l in out_port.splitlines() if "psnr" in l]
    assert printed == [shape(l) for l in out_jax.splitlines() if "psnr" in l]
    assert printed[-1].startswith("FINAL psnr")

    # resume: every object is in finish.txt; nothing is rendered again
    eval_app.main(_common(work) + flags + ["-O", ours])
    again = capsys.readouterr().out
    assert open(os.path.join(ours, "finish.txt")).read().splitlines() == finish
    assert not [l for l in again.splitlines() if l.startswith("[")]
    assert [l for l in again.splitlines() if l.startswith("FINAL")] == [l for l in out_port.splitlines()
                                                                       if l.startswith("FINAL")]


def test_eval_app_flags(work, capsys, monkeypatch):
    from pixelnerf_tpu_torch.apps import eval as eval_app
    from pixelnerf_tpu_torch.utils import png

    root = work["root"]
    views = str(root / "views.txt")
    with open(views, "w") as f:
        f.write("0 3\n")
    out = str(root / "eval_half")
    eval_app.main(_common(work) + ["-P", "1", "-R", "512", "--eval_view_list", views, "--no_compare_gt",
                                   "--scale", "0.5", "--limit", "1", "-O", out])
    assert _objects(out) == {"test0": ["000000.png", "000003.png"]}
    assert png.imread(os.path.join(out, "test0", "000000.png")).shape == (16, 16, 3)
    # --scale 0.75: the ground truth's 32 -> 24 area downscale is OpenCV's, bit for bit
    import cv2

    seen = []
    real = eval_app.resize_area_like_cv2

    def recording(img, h, w):
        seen.append((img.copy(), real(img, h, w)))
        return seen[-1][1]

    monkeypatch.setattr(eval_app, "resize_area_like_cv2", recording)
    eval_app.main(_common(work) + ["-P", "1", "-R", "512", "--eval_view_list", views, "--scale", "0.75",
                                   "--limit", "1", "-O", str(root / "e75")])
    assert png.imread(os.path.join(root / "e75", "test0", "000003.png")).shape == (24, 24, 3)
    assert len(seen) == 2 and all(out.shape == (24, 24, 3) for _, out in seen)
    for img, out in seen:
        np.testing.assert_array_equal(out, cv2.resize(img, (24, 24), interpolation=cv2.INTER_AREA))
    # a per-object source list, the sources among the targets, category-named objects
    vl = str(root / "viewlist.txt")
    with open(vl, "w") as f:
        f.write("cars_test test1 2 3\n")
    out = str(root / "eval_flags")
    eval_app.main(_common(work) + ["-L", vl, "-P", "0", "--include_src", "--multicat", "--coarse", "-R", "1024",
                                   "-O", out])
    objs = _objects(out)
    assert sorted(objs) == ["cars_test_test0", "cars_test_test1"]
    assert all(files == [f"{v:06d}.png" for v in range(4)] for files in objs.values())
    lines = open(os.path.join(out, "finish.txt")).read().splitlines()
    assert [FINISH_LINE.match(l).group(1, 4) for l in lines] == [("cars_test_test0", "4"), ("cars_test_test1", "4")]
    capsys.readouterr()


def test_eval_approx_picks_the_jax_targets_and_runs(work, monkeypatch, capsys):
    import pixelnerf_tpu.apps.eval_approx as jax_approx
    from pixelnerf_tpu.data import get_split_dataset as jax_get_split_dataset
    from pixelnerf_tpu_torch.apps import eval_approx
    from pixelnerf_tpu_torch.data import get_split_dataset

    # record the target pose of every object the JAX app renders
    seen = []
    real = jax_approx.geometry.gen_rays

    class Recorder:
        def __getattr__(self, name):
            return getattr(jax_approx.geometry, name)

        @staticmethod
        def gen_rays(poses, *a, **k):
            seen.append(np.asarray(poses)[0])
            return real(poses, *a, **k)

    monkeypatch.setattr(jax_approx, "geometry", Recorder())
    seed = ["--seed", "7", "-P", "1", "-R", "4096"]
    jax_result = jax_approx.main(_common(work, device=False) + seed + ["-B", "2"])
    jdset = jax_get_split_dataset("srn", work["data"], "test", image_size=(32, 32))
    jax_targets = [int(np.argmin([np.abs(p - s).max() for p in jdset[i]["poses"]])) for i, s in enumerate(seen)]

    dset = get_split_dataset("srn", work["data"], "test", image_size=(32, 32))
    ours = [t for _, _, t, _ in eval_approx.pick_targets(dset, np.array([1]), len(dset), 7)]
    assert ours == jax_targets and len(ours) == 2
    result = eval_approx.main(_common(work) + seed + ["-B", "2"])
    out = capsys.readouterr().out
    assert "APPROX FINAL psnr" in out
    assert abs(result[0] - jax_result[0]) < 0.5 and np.isfinite(result[1])


def test_train_app_srn_visual_has_the_jax_layout(work, tmp_path, capsys, monkeypatch):
    """``apps.train -F srn`` for 2 batches with the visual at batch 1: the
    image is [source | gt | depth | rgb | alpha] per pass, as the JAX app
    writes it, and the source and gt columns are the same pixels."""
    from pixelnerf_tpu.apps import train as jax_train
    from pixelnerf_tpu_torch.apps import train
    from pixelnerf_tpu_torch.utils import png

    monkeypatch.setenv("PIXELNERF_NO_TB", "1")
    argv = ["-c", SRN_CONF, "-F", "srn", "-D", work["data"], "-B", "2", "-R", "32", "--epochs", "1",
            "--epoch_batches", "2", "--workers", "1"] + TINY
    trainer = train.main(argv + ["--device", "cpu", "--checkpoints_path", str(tmp_path / "ck"),
                                 "--logs_path", str(tmp_path / "logs"), "--visual_path", str(tmp_path / "vis")])
    out = capsys.readouterr().out
    assert trainer.step == 2 and "*** vis psnr" in out and "*** eval:" in out
    jax_train.main(argv + ["--no_mesh", "--checkpoints_path", str(tmp_path / "jck"),
                           "--logs_path", str(tmp_path / "jlogs"), "--visual_path", str(tmp_path / "jvis")])
    ours = png.imread(str(tmp_path / "vis" / "example" / "0000_0001_vis.png"))
    ref = png.imread(str(tmp_path / "jvis" / "example" / "0000_0001_vis.png"))
    assert ours.shape == ref.shape == (2 * 32, 5 * 32, 3)
    np.testing.assert_array_equal(ours[:, : 2 * 32], ref[:, : 2 * 32])
    # alpha: a gray column
    assert np.array_equal(ours[..., 4 * 32 :, 0], ours[..., 4 * 32 :, 2])


def test_train_app_takes_pretrained_encoder(work, tmp_path, capsys, monkeypatch):
    from torchvision_stub import resnet18, resnet34

    from pixelnerf_tpu_torch.apps import train

    monkeypatch.setenv("PIXELNERF_NO_TB", "1")
    torch.manual_seed(2)
    good, bad = str(tmp_path / "r34.pth"), str(tmp_path / "r18.pth")
    torch.save(resnet34().state_dict(), good)
    torch.save(resnet18().state_dict(), bad)
    argv = ["-c", SRN_CONF, "-F", "srn", "-D", work["data"], "-B", "1", "-R", "16", "--epochs", "1",
            "--epoch_batches", "1", "--workers", "1", "--device", "cpu", "--checkpoints_path", str(tmp_path / "ck"),
            "--logs_path", str(tmp_path / "logs"), "--visual_path", str(tmp_path / "vis")] + TINY
    train.main(argv + ["--pretrained_encoder", good])
    assert f"Encoder initialized from {good}" in capsys.readouterr().out
    with pytest.raises(ValueError, match="pretrained encoder missing tensor"):
        train.main(argv + ["--pretrained_encoder", bad])


# -F, its config, -V, -P, its fixture writer
READER_APPS = {
    "dvr_dtu": ("dtu.conf", "3", "0 2 4", write_dtu_fixture),
    "dvr": ("sn64.conf", "1", "0", write_nmr_fixture),
    "multi_obj": ("multi_obj.conf", "1", "0", write_multi_obj_fixture),
}


@pytest.mark.parametrize("fmt", list(READER_APPS))
def test_apps_train_and_eval_on_the_dvr_and_multi_object_readers(fmt, tmp_path, capsys, monkeypatch):
    """``apps.train`` (2 batches, its eval and visual at batch 1) and
    ``apps.eval`` on the DTU (``-V 3``, 40x30, off-centre c, (fx, fy)), NMR
    and multi-object readers, on the CPU with the TINY model: the steps run,
    the visual has the view's shape, ``finish.txt`` gets the object."""
    from pixelnerf_tpu_torch.apps import eval as eval_app
    from pixelnerf_tpu_torch.apps import train
    from pixelnerf_tpu_torch.utils import png

    monkeypatch.setenv("PIXELNERF_NO_TB", "1")
    conf, views, source, write = READER_APPS[fmt]
    data = write(str(tmp_path / "data"), np.random.default_rng(0))
    # the readers take no image size but DVR's; DTU's conf repeats an epoch 32 times
    tiny = [a for k, v in OVERRIDES.items() if k != "data.image_size" for a in ("--override", f"{k}={v}")]
    common = ["-c", os.path.join(REPO, "conf", "exp", conf), "-F", fmt, "-D", data, "--device", "cpu",
              "--checkpoints_path", str(tmp_path / "ck"), "--override", "train.num_epoch_repeats=1"] + tiny
    trainer = train.main(common + ["-B", "2", "-R", "16", "-V", views, "--epochs", "1", "--epoch_batches", "2",
                                   "--workers", "1", "--logs_path", str(tmp_path / "logs"),
                                   "--visual_path", str(tmp_path / "vis")])
    out = capsys.readouterr().out
    assert trainer.step == 2 and "*** vis psnr" in out
    vis = png.imread(str(tmp_path / "vis" / "example" / "0000_0001_vis.png"))
    h, w = {"dvr_dtu": (30, 40), "dvr": (16, 16), "multi_obj": (12, 12)}[fmt]
    assert vis.shape == (2 * h, 5 * w, 3)
    out_dir = str(tmp_path / "eval")
    eval_app.main(common + ["-P", source, "-R", "256", "--limit", "1", "-O", out_dir])
    assert "FINAL psnr" in capsys.readouterr().out
    finish = open(os.path.join(out_dir, "finish.txt")).read().splitlines()
    assert len(finish) == 1 and np.isfinite(float(finish[0].split()[1]))


BLOCKED = ("imageio", "PIL", "cv2", "jax", "jaxlib", "flax", "optax", "pixelnerf_tpu")

_BLOCKING_RUNNER = """
import importlib, importlib.abc, sys
BLOCKED = set(sys.argv[1].split(","))
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked: " + name)
        return None
sys.meta_path.insert(0, Block())
import json
for app, argv in json.loads(sys.argv[2]):
    importlib.import_module("pixelnerf_tpu_torch.apps." + app).main(argv)
print("loaded:", sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED))
"""


def test_port_apps_run_with_imaging_libraries_and_jax_blocked(work, tmp_path):
    """``apps.train``, ``apps.eval``, ``apps.gen_video``, ``apps.eval_real``,
    ``apps.calc_metrics`` (with LPIPS) and ``apps.export_torch`` in one
    process that cannot import imageio, PIL, cv2 or jax."""
    import json

    from test_lpips import _random_torch_state_dict

    from pixelnerf_tpu_torch.utils import png

    common = ["-c", SRN_CONF, "-F", "srn", "-D", work["data"], "--device", "cpu",
              "--checkpoints_path", str(tmp_path / "ck")] + TINY
    lpips_weights = str(tmp_path / "lpips.pth")
    torch.save(_random_torch_state_dict(seed=1), lpips_weights)
    (tmp_path / "real").mkdir()
    png.imwrite(str(tmp_path / "real" / "a_normalize.png"),
                png.imread(os.path.join(work["data"] + "_test", "test0", "rgb", "000000.png")))
    apps = [
        ("train", common + ["-B", "1", "-R", "16", "--epochs", "1", "--epoch_batches", "2", "--workers", "1",
                            "--logs_path", str(tmp_path / "logs"), "--visual_path", str(tmp_path / "vis")]),
        ("eval", common + ["-P", "1", "-R", "2048", "--write_depth", "--write_compare", "--limit", "1",
                           "-O", str(tmp_path / "eval")]),
        ("gen_video", common + ["-P", "1", "--num_views", "2", "-R", "1024", "-O", str(tmp_path / "video")]),
        ("eval_real", common + ["--input", str(tmp_path / "real"), "--size", "32", "--num_views", "2",
                                "-R", "1024", "-O", str(tmp_path / "real_out")]),
        ("calc_metrics", ["-D", work["data"] + "_test", "-F", "srn", "-O", str(tmp_path / "eval"), "--device", "cpu",
                          "--lpips_weights", lpips_weights, "--require_lpips"]),
        ("export_torch", ["-n", "example", "--checkpoints_path", str(tmp_path / "ck")]),
    ]
    env = dict(os.environ, PIXELNERF_NO_TB="1", PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", _BLOCKING_RUNNER, ",".join(BLOCKED), json.dumps(apps)],
                          cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "loaded: []" in proc.stdout and "FINAL psnr" in proc.stdout
    assert os.listdir(tmp_path / "vis" / "example") == ["0000_0001_vis.png"]
    assert sorted(os.listdir(tmp_path / "video")) == ["example_obj0.gif", "example_obj0_src.png"]
    assert sorted(os.listdir(tmp_path / "real_out")) == ["a_normalize.gif", "a_normalize_frames"]
    assert "lpips" in open(tmp_path / "eval" / "all_metrics.txt").read()
    assert os.path.exists(tmp_path / "ck" / "example" / "pixel_nerf_latest")


def test_port_names_no_imaging_library():
    """No module of the port, and not ``chip_smoke.py``, imports imageio,
    PIL or cv2 (``test_port_imports_nothing_of_jax`` holds the JAX rule)."""
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "pixelnerf_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    # the port's own image readers are among them
    readers = {os.path.join("pixelnerf_tpu_torch", "utils", f"{m}.py") for m in ("png", "jpeg", "image_io")}
    assert readers <= {os.path.relpath(f, REPO) for f in files}
    bad = set()
    for f in files:
        for node in ast.walk(ast.parse(open(f).read(), f)):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
                names = [node.module]
            bad |= {(os.path.relpath(f, REPO), n) for n in names if n.split(".")[0] in ("imageio", "PIL", "cv2")}
    assert not bad, bad
