"""The port's ``apps.eval --scale`` above 1 and its own dataset and
checkpoint tools, on the CPU, against the JAX side on the same inputs:

- ``utils/imgproc.py`` ``resize_area`` against ``cv2.resize(INTER_AREA)``
  for upscales and mixed resizes (bit for bit), ``gaussian_blur`` against
  ``cv2.GaussianBlur`` and ``count_components`` against
  ``cv2.connectedComponents``;
- ``apps.eval --scale 2`` and ``apps.eval_real`` on a 100x60 photo against
  the JAX apps with the JAX renderer's draws injected;
- ``scripts/make_multi_obj_dataset_torch.py``,
  ``render_shapenet_objs_torch.py --backend software`` and
  ``make_real_layout_fixtures_torch.py`` against their JAX scripts with
  the same arguments and seed (decoded pixels, EXR arrays and JSON equal),
  read back by the port's readers;
- ``make_real_input_torch.py`` against the committed ``raw/photo*.png``;
- ``snapshot_watcher_torch.py``, ``quality_curve_torch.py`` and
  ``export_demo_checkpoint_torch.py`` on the port's checkpoints.
"""
import contextlib
import io
import json
import os
import sys

import cv2
import imageio.v2 as imageio
import jax
import numpy as np
import pytest
import torch

from torch_port_utils import REPO, SRN_CONF, TINY, jax_chunk_draws, write_srn_fixture

sys.path.insert(0, os.path.join(REPO, "scripts"))

import export_demo_checkpoint_torch as export_tool  # noqa: E402
import make_multi_obj_dataset as jax_multi_obj  # noqa: E402
import make_multi_obj_dataset_torch as multi_obj  # noqa: E402
import make_real_input_torch as real_input  # noqa: E402
import make_real_layout_fixtures as jax_layouts  # noqa: E402
import make_real_layout_fixtures_torch as layouts  # noqa: E402
import quality_curve_torch as quality_curve  # noqa: E402
import render_shapenet_objs as jax_shapenet  # noqa: E402
import render_shapenet_objs_torch as shapenet  # noqa: E402
import snapshot_watcher_torch as watcher  # noqa: E402
from test_mesh_raster import _write_cube_model  # noqa: E402

from pixelnerf_tpu_torch.utils import imgproc, png  # noqa: E402
from pixelnerf_tpu_torch.utils.exr import read_exr  # noqa: E402

# ---------------------------------------------------------------------------
# resize_area, gaussian_blur, count_components against OpenCV

RESIZES = [((128, 128), (256, 256)), ((128, 128), (192, 192)), ((64, 64), (100, 100)), ((300, 400), (600, 800)),
           ((10, 13), (37, 29)), ((128, 128), (77, 300)), ((100, 60), (64, 64)), ((1, 1), (5, 7)),
           ((1, 6), (4, 3)), ((32, 32), (64, 64)), ((16, 24), (32, 48)), ((64, 64), (64, 128))]


@pytest.mark.parametrize("dtype", ["float32", "uint8"])
@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("shapes", RESIZES, ids=[f"{a[0]}x{a[1]}-{b[0]}x{b[1]}" for a, b in RESIZES])
def test_resize_area_upscales_and_mixed_resizes_are_opencvs(shapes, channels, dtype):
    """Upscales (exact 2x, odd ratios, 1-pixel images) and resizes that
    shrink one axis and grow the other, gray and RGB: bit-equal."""
    (h, w), (oh, ow) = shapes
    rng = np.random.default_rng(h * 1000 + w + channels)
    shape = (h, w) if channels == 1 else (h, w, channels)
    img = (rng.uniform(0, 1, shape).astype(np.float32) if dtype == "float32"
           else rng.integers(0, 256, shape).astype(np.uint8))
    ours = imgproc.resize_area(img, oh, ow)
    ref = cv2.resize(img, (ow, oh), interpolation=cv2.INTER_AREA)
    assert ours.dtype == ref.dtype and ours.shape == ref.shape
    np.testing.assert_array_equal(ours, ref)


def _disc_mask(h, w, cy, cx, r):
    yy, xx = np.mgrid[:h, :w]
    return (((yy - cy) ** 2 + (xx - cx) ** 2) < r * r).astype(np.float32)


@pytest.mark.parametrize("sigma", [9.6, 2.0, 0.8])
def test_gaussian_blur_is_opencvs(sigma):
    """``GaussianBlur(m, (0, 0), sigma)`` of float32 images: bit-equal on
    the photo's 240x240 mask (sigma 9.6 is the shadow's) and on noise whose
    widths are multiples of 8 or not (the kernel larger than the image
    too). At 7 taps (sigma 0.8) the last ``W mod 4`` columns may differ by
    at most 2 float32 ulps (``gaussian_blur``'s docstring)."""
    rng = np.random.default_rng(int(sigma * 10))
    cases = [_disc_mask(240, 240, 120, 110, 80), rng.uniform(0, 1, (50, 64)).astype(np.float32),
             rng.uniform(0, 1, (40, 77)).astype(np.float32), rng.uniform(0, 1, (10, 10)).astype(np.float32)]
    for img in cases:
        ref = cv2.GaussianBlur(img, (0, 0), sigma)
        ours = imgproc.gaussian_blur(img, sigma)
        assert ours.dtype == np.float32 and ours.shape == ref.shape
        exact = img.shape[1] // 4 * 4 if sigma < 1 else img.shape[1]
        np.testing.assert_array_equal(ours[:, :exact], ref[:, :exact])
        assert np.abs(ours.view(np.int32).astype(np.int64) - ref.view(np.int32)).max() <= 2   # ulps


def test_count_components_is_opencvs():
    rng = np.random.default_rng(3)
    for density in (0.2, 0.5, 0.8):
        mask = (rng.uniform(0, 1, (40, 50)) < density).astype(np.uint8)
        assert imgproc.count_components(mask) == cv2.connectedComponents(mask)[0]
    assert imgproc.count_components(np.zeros((5, 5), np.uint8)) == 1


@pytest.mark.parametrize("index", [1, 2])
def test_make_real_input_reproduces_the_committed_photos(index):
    ours = real_input.make_photo(seed=index)
    ref = png.imread(os.path.join(REPO, "raw", f"photo{index}.png"))
    np.testing.assert_array_equal(ours, ref)


# ---------------------------------------------------------------------------
# apps.eval --scale 2 and eval_real on a mixed resize, against the JAX apps


def _tiny_conf():
    from pixelnerf_tpu_torch.apps.args import parse_args

    return parse_args(lambda p: None, argv=["-c", SRN_CONF] + TINY)[1]


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """An SRN-layout fixture of two views an object and a TINY model's
    weights as a reference ``pixel_nerf_latest``, which the apps of both
    packages load: the port's seeded init, with the density bias raised so
    that the renders are not the white background."""
    from pixelnerf_tpu_torch.models import export_state_dict, make_model

    root = tmp_path_factory.mktemp("tools")
    data = write_srn_fixture(str(root / "data"), num_views=2)
    net = make_model(_tiny_conf()["model"], device="cpu", generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        for mlp in (net.mlp_coarse, net.mlp_fine):
            mlp.lin_out.bias[3] += 3.0
    os.makedirs(root / "ck" / "ref")
    torch.save(export_state_dict(net.state_dict()), str(root / "ck" / "ref" / "pixel_nerf_latest"))
    return {"root": root, "data": data, "ck": str(root / "ck")}


def _app_args(work, port=True):
    args = ["-n", "ref", "-c", SRN_CONF, "--checkpoints_path", work["ck"]] + TINY
    return args + (["--device", "cpu"] if port else ["--no_mesh"])


CHUNK, SCAN = 1024, 256      # the apps' -R and the JAX renderer's scan chunk


def jax_app_draws(key, n_rays, cfg):
    """The draws of the JAX apps' ``FullRenderer`` at ``-R CHUNK``: per ray
    chunk a key split off ``key``; inside it ``render_rays_chunked``'s key
    per scan chunk of SCAN rays (the last chunk padded, then cut)."""
    noise = []
    for start in range(0, n_rays, CHUNK):
        key, sub = jax.random.split(key)
        parts = jax_chunk_draws(sub, 1, CHUNK, cfg, ray_chunk=SCAN, train=False)
        n = min(CHUNK, n_rays - start)
        noise.append({k: torch.cat([p[k] for p in parts], 1)[:, :n] for k in parts[0]})
    return noise


def test_eval_scale_2_matches_jax_app(work, monkeypatch, capsys):
    """Source view 0, target view 1 of each object, rendered at 64x64 from
    32x32 inputs; the port renders on the JAX app's draws (a key per object
    split from ``PRNGKey(seed)``, then per ray chunk and scan chunk). The upscaled ground
    truth is OpenCV's, bit for bit; the per-object PSNR in ``finish.txt``
    agrees within 1e-3 dB, the render within 1 level of 255."""
    from pixelnerf_tpu.apps import eval as jax_eval
    from pixelnerf_tpu_torch.apps import eval as eval_app

    real_render, real_resize = eval_app.render_object, eval_app.resize_area_like_cv2
    keys = {"rng": jax.random.PRNGKey(0)}
    resized = []

    def render_on_jax_draws(renderer, data, src, targets, z_near, z_far, scale=1.0, generator=None, noise=None):
        keys["rng"], key = jax.random.split(keys["rng"])
        h, w = (int(round(s * scale)) for s in data["images"].shape[1:3])
        noise = jax_app_draws(key, len(targets) * h * w, renderer.cfg)
        return real_render(renderer, data, src, targets, z_near, z_far, scale, noise=noise)

    def recording_resize(img, h, w):
        resized.append((img.copy(), real_resize(img, h, w)))
        return resized[-1][1]

    monkeypatch.setattr(eval_app, "render_object", render_on_jax_draws)
    monkeypatch.setattr(eval_app, "resize_area_like_cv2", recording_resize)
    flags = ["-F", "srn", "-D", work["data"], "-P", "0", "-R", str(CHUNK), "--scale", "2", "--write_compare",
             "--limit", "1"]
    ours, ref = str(work["root"] / "eval2_port"), str(work["root"] / "eval2_jax")
    eval_app.main(_app_args(work) + flags + ["-O", ours])
    jax_eval.main(_app_args(work, port=False) + flags + ["-O", ref])
    capsys.readouterr()

    assert len(resized) == 1
    for img, out in resized:
        assert img.shape == (32, 32, 3) and out.shape == (64, 64, 3)
        np.testing.assert_array_equal(out, cv2.resize(img, (64, 64), interpolation=cv2.INTER_AREA))
    finish = [l.split() for l in open(os.path.join(ours, "finish.txt")).read().splitlines()]
    finish_jax = [l.split() for l in open(os.path.join(ref, "finish.txt")).read().splitlines()]
    assert [(f[0], f[3]) for f in finish] == [(f[0], f[3]) for f in finish_jax] == [("test0", "1")]
    for a, b in zip(finish, finish_jax):
        assert abs(float(a[1]) - float(b[1])) < 1e-3 and abs(float(a[2]) - float(b[2])) < 1e-4, (a, b)
    for obj in ("test0",):
        cmp_port = png.imread(os.path.join(ours, obj, "000001_compare.png"))
        cmp_jax = imageio.imread(os.path.join(ref, obj, "000001_compare.png"))
        assert cmp_port.shape == cmp_jax.shape == (64, 128, 3)
        np.testing.assert_array_equal(cmp_port[:, :64], cmp_jax[:, :64])        # the ground truth
        assert np.abs(cmp_port[:, 64:].astype(int) - cmp_jax[:, 64:]).max() <= 1
        assert float(np.std(cmp_jax[:, 64:])) > 1.0


def test_eval_real_on_a_mixed_resize_matches_jax_app(work, tmp_path, monkeypatch, capsys):
    """A 100x60 photo at ``--size 64`` (rows shrunk, columns grown): the
    encoded input is OpenCV's resize bit for bit, and the frame rendered on
    the JAX app's draws is within 1 level of 255 of the JAX app's."""
    from pixelnerf_tpu.apps import eval_real as jax_app
    from pixelnerf_tpu_torch.apps import eval_real

    inp = tmp_path / "input"
    inp.mkdir()
    photo = np.random.default_rng(7).integers(0, 256, (100, 60, 3)).astype(np.uint8)
    png.imwrite(str(inp / "p_normalize.png"), photo)
    np.testing.assert_array_equal(
        eval_real.read_input(str(inp / "p_normalize.png"), 64),
        (cv2.resize(photo, (64, 64), interpolation=cv2.INTER_AREA).astype(np.float32) / 255.0 - 0.5) / 0.5)

    keys = {"rng": jax.random.PRNGKey(0)}

    def frames_on_jax_draws(renderer, enc, rays, generator):
        for i in range(len(rays)):
            keys["rng"], key = jax.random.split(keys["rng"])
            noise = jax_app_draws(key, rays[i].shape[0] * rays[i].shape[1], renderer.cfg)
            rgb, _ = renderer.render_image(enc, rays[i], noise=noise)
            yield (np.clip(rgb.cpu().numpy(), 0, 1) * 255).astype(np.uint8)

    monkeypatch.setattr(eval_real, "render_frames", frames_on_jax_draws)
    flags = ["--input", str(inp), "--size", "64", "--num_views", "1", "-R", str(CHUNK), "--no_vid"]
    eval_real.main(_app_args(work) + flags + ["-O", str(tmp_path / "port")])
    jax_app.main(_app_args(work, port=False) + flags + ["-O", str(tmp_path / "jax")])
    capsys.readouterr()
    ours = png.imread(str(tmp_path / "port" / "p_normalize_frames" / "0000.png"))
    ref = imageio.imread(str(tmp_path / "jax" / "p_normalize_frames" / "0000.png"))
    assert ours.shape == ref.shape == (64, 64, 3)
    assert np.abs(ours.astype(int) - ref).max() <= 1 and float(np.std(ref)) > 1.0


# ---------------------------------------------------------------------------
# the dataset builders against their JAX scripts


def _assert_trees_equal(ours, ref):
    """Two output trees: the same files; PNGs equal as decoded, EXRs as
    arrays, JSON as parsed, any other file byte for byte."""
    def listing(root):
        return sorted(os.path.relpath(os.path.join(d, f), root) for d, _, fs in os.walk(root) for f in fs)

    assert listing(ours) == listing(ref)
    for rel in listing(ours):
        a, b = os.path.join(ours, rel), os.path.join(ref, rel)
        if rel.endswith(".png"):
            np.testing.assert_array_equal(png.imread(a), imageio.imread(b), err_msg=rel)
        elif rel.endswith(".exr"):
            np.testing.assert_array_equal(read_exr(a), read_exr(b), err_msg=rel)
        elif rel.endswith(".json"):
            assert json.load(open(a)) == json.load(open(b)), rel
        elif rel.endswith(".npz"):
            za, zb = np.load(a), np.load(b)
            assert sorted(za.files) == sorted(zb.files), rel
            for k in za.files:
                np.testing.assert_array_equal(za[k], zb[k], err_msg=f"{rel}:{k}")
        else:
            assert open(a, "rb").read() == open(b, "rb").read(), rel


def test_make_multi_obj_dataset_matches_jax_script(tmp_path, capsys):
    from pixelnerf_tpu_torch.data import MultiObjectDataset

    argv = ["--scenes", "4", "--views", "3", "--size", "20", "--seed", "5", "--max_objects", "3"]
    multi_obj.main(argv + ["--out", str(tmp_path / "port")])
    jax_multi_obj.main(argv + ["--out", str(tmp_path / "jax")])
    capsys.readouterr()
    _assert_trees_equal(str(tmp_path / "port"), str(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == ["test", "train", "val"]
    ds = MultiObjectDataset(str(tmp_path / "port"), stage="train")
    assert len(ds) == 2
    d = ds[0]
    assert d["images"].shape == (3, 20, 20, 3) and d["poses"].shape == (3, 4, 4)
    assert np.isfinite(d["images"]).all() and d["images"].min() < 0.9


def test_render_shapenet_objs_software_matches_jax_script(tmp_path, capsys):
    """Two cube models, two scenes of both, depth and alpha passes: the
    same split files, scene directories and passes; the dataset loads in
    the port's ``MultiObjectDataset``."""
    from pixelnerf_tpu_torch.data import MultiObjectDataset

    for side in ("port", "jax"):
        for i, col in enumerate([(0.8, 0.2, 0.1), (0.1, 0.4, 0.9)]):
            _write_cube_model(str(tmp_path / side / "src" / f"model{i:02d}"), col)
    argv = ["--backend", "software", "--split", "train", "--n_scenes", "2", "--n_objects", "2", "--n_views", "3",
            "--size", "24", "--val_frac", "0", "--test_frac", "0", "--render_depth", "--render_alpha", "--seed", "3"]
    shapenet.main(argv + ["--src", str(tmp_path / "port" / "src"), "--out", str(tmp_path / "port" / "ds")])
    jax_shapenet.software_main(jax_shapenet._parse_args(
        argv + ["--src", str(tmp_path / "jax" / "src"), "--out", str(tmp_path / "jax" / "ds")]))
    capsys.readouterr()
    _assert_trees_equal(str(tmp_path / "port"), str(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port" / "src")) == ["model00", "model01", "test_split_0.txt",
                                                           "train_split_2.txt", "val_split_0.txt"]
    d = MultiObjectDataset(str(tmp_path / "port" / "ds"), stage="train")[0]
    assert d["images"].shape == (3, 24, 24, 3) and np.isfinite(d["images"]).all()
    with pytest.raises(SystemExit, match="render_shapenet_objs.py"):
        shapenet.main(["--src", str(tmp_path), "--out", str(tmp_path / "x")])


def test_make_real_layout_fixtures_match_jax_script(tmp_path):
    """SRN, DTU and NMR layouts at small sizes: the same files and ground
    truth; the port's readers reproduce the written cameras."""
    from pixelnerf_tpu_torch.data import SRNDataset
    from pixelnerf_tpu_torch.data.dvr import DVRDataset

    calls = [("write_srn_layout", dict(stage="train", num_objs=2, num_views=3, size=24)),
             ("write_dtu_layout", dict(num_scans=2, num_views=3, hw=(18, 24))),
             ("write_nmr_layout", dict(num_cats=2, objs_per_cat=3, num_views=2, size=16))]
    truth = {}
    for name, kw in calls:
        truth[name] = getattr(layouts, name)(str(tmp_path / "port"), **kw)
        ref = getattr(jax_layouts, name)(str(tmp_path / "jax"), **kw)
        assert sorted(truth[name]) == sorted(ref)
        for obj, t in truth[name].items():
            for k, v in t.items():
                np.testing.assert_array_equal(np.asarray(v), np.asarray(ref[obj][k]))
    _assert_trees_equal(str(tmp_path / "port"), str(tmp_path / "jax"))

    srn = SRNDataset(str(tmp_path / "port" / "cars"), stage="train", image_size=(24, 24))
    for i in range(len(srn)):
        d = srn[i]
        np.testing.assert_allclose(d["poses"], truth["write_srn_layout"][os.path.basename(d["path"])]["poses"],
                                   atol=1e-5)
    dtu = DVRDataset(str(tmp_path / "port" / "rs_dtu_4"), stage="train", list_prefix="new_", sub_format="dtu",
                     scale_focal=False, z_near=0.1, z_far=5.0)
    d = dtu[0]
    np.testing.assert_allclose(d["poses"], truth["write_dtu_layout"][os.path.basename(d["path"])]["poses"], atol=1e-4)
    assert d["images"].shape == (3, 18, 24, 3)
    nmr = DVRDataset(str(tmp_path / "port"), stage="train", list_prefix="softras_")
    assert len(nmr) == 2
    for i in range(len(nmr)):
        d = nmr[i]
        np.testing.assert_allclose(d["poses"], truth["write_nmr_layout"][os.path.basename(d["path"])]["poses"],
                                   atol=1e-4)
    layouts.main(["--out", str(tmp_path / "cli"), "--format", "nmr", "--objs", "2", "--views", "2", "--size", "8"])
    assert len(DVRDataset(str(tmp_path / "cli"), stage="train", list_prefix="softras_")) == 4   # 2 categories x 2


# ---------------------------------------------------------------------------
# snapshots, the quality curve and the exporter


def _write_state(path, step):
    torch.save({"model": {"w": torch.zeros(2)}, "step": step}, path)


def test_snapshot_watcher_tags_by_the_stored_step(tmp_path):
    live = str(tmp_path / "train_state.pt")
    _write_state(live, 100)
    assert watcher.read_step(live) == 100
    last = watcher.snapshot_if_due(live, last_snap=-2000, every=2000)
    assert last == 100 and (tmp_path / "train_state_step100.pt").exists()
    _write_state(live, 1900)                 # +1800 < every: no snapshot
    assert watcher.snapshot_if_due(live, last_snap=last, every=2000) == 100
    assert not (tmp_path / "train_state_step1900.pt").exists()
    _write_state(live, 2200)                 # +2100 >= every: a snapshot, and it reads back
    assert watcher.snapshot_if_due(live, last_snap=last, every=2000) == 2200
    assert watcher.read_step(str(tmp_path / "train_state_step2200.pt")) == 2200
    assert sorted(os.listdir(tmp_path)) == ["train_state.pt", "train_state_step100.pt", "train_state_step2200.pt"]


def test_quality_curve_discovery_order_and_filter(tmp_path, monkeypatch, capsys):
    import pixelnerf_tpu_torch.apps.eval_approx as eval_approx

    ck = tmp_path / "ckpts" / "run1"
    ck.mkdir(parents=True)
    for name in ("train_state_step200.pt", "train_state_step1000.pt", "train_state_stepx.pt", "other.pt"):
        (ck / name).write_bytes(b"x")
    _write_state(str(ck / "train_state.pt"), 1500)
    calls = []

    def fake_eval(argv):
        calls.append(argv)
        return 12.5, 0.7

    monkeypatch.setattr(eval_approx, "main", fake_eval)
    curve = quality_curve.main(["-n", "run1", "--checkpoints_path", str(tmp_path / "ckpts"), "--split", "test"])
    # numbered snapshots ascending, the live file labelled by its stored step
    assert [(p["step"], p["file"]) for p in curve] == [(200, "train_state_step200.pt"),
                                                       (1000, "train_state_step1000.pt"),
                                                       (1500, "train_state.pt")]
    assert all(p["psnr"] == 12.5 and p["ssim"] == 0.7 for p in curve)
    assert all("--split" in argv and argv[:2] == ["-n", "run1"] for argv in calls)
    out = [l for l in capsys.readouterr().out.splitlines() if l.strip()]
    assert len(out) == 3 and json.loads(out[0])["step"] == 200
    assert [p["step"] for p in quality_curve.main(["-n", "run1", "--checkpoints_path", str(tmp_path / "ckpts"),
                                                   "--steps", "1000,1500"])] == [1000, 1500]
    # an unreadable live file keeps a null label, sorts last and is left out by --steps
    (ck / "train_state.pt").write_bytes(b"x")
    assert [p["step"] for p in quality_curve.main(["-n", "run1", "--checkpoints_path",
                                                   str(tmp_path / "ckpts")])] == [200, 1000, None]
    capsys.readouterr()
    with pytest.raises(SystemExit, match="no snapshots"):
        quality_curve.main(["-n", "none", "--checkpoints_path", str(tmp_path / "ckpts")])


@pytest.fixture(scope="module")
def trained(work, tmp_path_factory):
    """A TINY model trained for one step on the CPU: its checkpoint dir."""
    from pixelnerf_tpu_torch.apps import train

    root = tmp_path_factory.mktemp("trained")
    os.environ["PIXELNERF_NO_TB"] = "1"
    with contextlib.redirect_stdout(io.StringIO()):
        trainer = train.main(["-n", "tiny", "-c", SRN_CONF, "-F", "srn", "-D", work["data"], "-B", "1", "-R", "16",
                              "--epochs", "1", "--epoch_batches", "1", "--workers", "1", "--device", "cpu",
                              "--checkpoints_path", str(root / "ck"), "--logs_path", str(root / "logs"),
                              "--visual_path", str(root / "vis")] + TINY)
    assert trainer.step == 1
    return {"root": root, "ck": str(root / "ck"), "data": work["data"]}


def _approx_args(trained):
    return ["-c", SRN_CONF, "-F", "srn", "-D", trained["data"], "-P", "0", "-B", "2", "-R", "512",
            "--device", "cpu"] + TINY


def test_quality_curve_point_equals_eval_approx(trained, capsys):
    from pixelnerf_tpu_torch.apps import eval_approx

    curve = quality_curve.main(["-n", "tiny", "--checkpoints_path", trained["ck"]] + _approx_args(trained))
    direct = eval_approx.main(["-n", "tiny", "--checkpoints_path", trained["ck"]] + _approx_args(trained))
    capsys.readouterr()
    assert len(curve) == 1 and curve[0]["step"] == 1 and curve[0]["file"] == "train_state.pt"
    assert curve[0]["psnr"] == round(float(direct[0]), 4) and curve[0]["ssim"] == round(float(direct[1]), 4)
    assert np.isfinite(curve[0]["psnr"])


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_export_demo_checkpoint(trained, tmp_path, dtype, capsys):
    """Parameters cast to ``--dtype``, batch-norm statistics and counters as
    they were, no optimizer; the eval app loads it; ``load_checkpoint``
    restores the model and the step and reinitialises the optimizer,
    loudly."""
    from pixelnerf_tpu_torch.apps import eval as eval_app
    from pixelnerf_tpu_torch.models import make_model
    from pixelnerf_tpu_torch.train.state import CKPT_NAME, load_checkpoint, load_variables

    src = os.path.join(trained["ck"], "tiny")
    dst = str(tmp_path / "ck" / "tiny")
    export_tool.main(["--src", src, "--dst", dst, "--dtype", dtype])
    assert "wrote" in capsys.readouterr().out
    full, small = os.path.getsize(os.path.join(src, CKPT_NAME)), os.path.getsize(os.path.join(dst, CKPT_NAME))
    assert small < full / (5 if dtype == "bfloat16" else 2.5)
    raw = torch.load(os.path.join(dst, CKPT_NAME), weights_only=True)
    assert sorted(raw) == ["model", "step"] and raw["step"] == 1

    ref = load_variables(src)["model"]
    got = load_variables(dst)["model"]
    conf = _tiny_conf()
    net = make_model(conf["model"], device="cpu")
    params = {k for k, _ in net.named_parameters()}
    stats = {k for k, v in net.state_dict().items() if k not in params}
    assert set(got) == set(ref) and stats and all(k.rsplit(".", 1)[1] in ("running_mean", "running_var",
                                                                           "num_batches_tracked") for k in stats)
    for k, v in got.items():
        if k in params:
            assert v.dtype == getattr(torch, dtype)
            assert torch.equal(v, ref[k].to(getattr(torch, dtype))), k
        else:
            assert v.dtype == ref[k].dtype and torch.equal(v, ref[k]), k

    out = str(tmp_path / "eval")
    eval_app.main(["-n", "tiny", "--checkpoints_path", str(tmp_path / "ck"), "-c", SRN_CONF, "-F", "srn",
                   "-D", trained["data"], "-P", "0", "-R", "512", "--limit", "1", "--device", "cpu", "-O", out] + TINY)
    printed = capsys.readouterr().out
    assert "Loaded checkpoint at step 1" in printed and "FINAL psnr" in printed

    net = make_model(conf["model"], device="cpu")
    optimizer = torch.optim.Adam(net.parameters(), lr=1e-4)
    assert load_checkpoint(dst, net, optimizer) == 1
    assert "partial restore" in capsys.readouterr().out
    assert not optimizer.state
    for k, v in net.state_dict().items():
        assert torch.equal(v, got[k].to(v.dtype)), k
