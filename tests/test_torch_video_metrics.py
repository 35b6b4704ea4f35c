"""The port's video, real-image, metric and export apps against the JAX
package's on the CPU:

- the geometry helpers (quaternions, Blender axes) and the three video
  trajectories, to 1e-6;
- one ``gen_video`` frame through the port's ``FullRenderer`` with JAX's
  draws injected, against the JAX ``render_image`` frame, at the f32
  tolerance of ``tests/test_torch_eval.py`` (5e-4);
- ``gen_video.main`` and ``eval_real.main`` of both packages on one
  fixture and one checkpoint: the same files, frame counts and source
  strip, frames as far from the JAX app's as two seeds of the port are
  from each other;
- the GIF writer (``utils/gif.py``) against imageio's GIF (Pillow's);
- LPIPS against JAX ``lpips_distance``, the committed referee fixture and
  the importer's refusals;
- ``calc_metrics`` map and reduce against the JAX app on one tree;
- ``export_state_dict`` and ``apps.export_torch`` against the JAX export;
- ``--profile_dir``: the train app writes a trace on the CPU.
"""
import os
import re

import imageio.v2 as imageio
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image, ImageSequence

from pixelnerf_tpu.apps import gen_video as jax_gen_video
from pixelnerf_tpu.eval.common import FullRenderer as JaxFullRenderer
from pixelnerf_tpu.render import renderer as jr
from pixelnerf_tpu.utils import geometry as jax_geometry
from pixelnerf_tpu.utils import lpips as jax_lpips
from pixelnerf_tpu_torch.apps import gen_video
from pixelnerf_tpu_torch.eval import FullRenderer
from pixelnerf_tpu_torch.utils import geometry, gif, lpips, png

from test_lpips import _random_torch_state_dict
from test_torch_eval import jax_eval_draws
from test_torch_eval_apps import TINY, _jax_weights
from torch_port_utils import SRN_CONF, build_pair, write_srn_fixture


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    root = tmp_path_factory.mktemp("video_apps")
    data = write_srn_fixture(str(root / "data"), num_views=4)
    _jax_weights(str(root / "ck" / "ref" / "pixel_nerf_latest"))
    return {"root": root, "data": data, "ck": str(root / "ck")}


@pytest.fixture(scope="module")
def pair():
    return build_pair()


def _common(work, port=True):
    args = ["-n", "ref", "-c", SRN_CONF, "--checkpoints_path", work["ck"]] + TINY
    return args + (["--device", "cpu"] if port else ["--no_mesh"])


# ---------------------------------------------------------------------------
# geometry and trajectories


def test_geometry_helpers_match_jax():
    rng = np.random.default_rng(0)
    q = rng.normal(size=(16, 4)).astype(np.float32)
    np.testing.assert_allclose(geometry.quat_to_rot(q), np.asarray(jax_geometry.quat_to_rot(jnp.asarray(q))),
                               atol=1e-6)
    R = np.asarray(jax_geometry.quat_to_rot(jnp.asarray(q)))
    quat = geometry.rot_to_quat(R)
    np.testing.assert_allclose(quat, np.asarray(jax_geometry.rot_to_quat(jnp.asarray(R))), atol=1e-6)
    assert (quat[:, 0] > 0).all()                   # the JAX formula's branch: w = sqrt(1 + trace) / 2
    for name in ("coord_from_blender", "coord_to_blender"):
        np.testing.assert_array_equal(getattr(geometry, name)(), getattr(jax_geometry, name)())
    np.testing.assert_array_equal(geometry.coord_from_blender() @ geometry.coord_to_blender(), np.eye(4))


@pytest.mark.parametrize("num_views", [5, 12, 24])
def test_trajectories_match_jax(num_views):
    from pixelnerf_tpu.data import SyntheticSphereDataset as JaxSynthetic

    poses = JaxSynthetic(num_objects=1, num_views=6)[0]["poses"]
    pairs = {
        "spherical": (gen_video.spherical_trajectory(num_views, -10.0, 1.3),
                      jax_gen_video.spherical_trajectory(num_views, -10.0, 1.3)),
        "spline": (gen_video.spline_trajectory(poses, num_views), jax_gen_video.spline_trajectory(poses, num_views)),
        "dtu": (gen_video.dtu_trajectory(num_views), jax_gen_video.dtu_trajectory(num_views)),
    }
    for name, (ours, ref) in pairs.items():
        assert ours.shape == ref.shape and ours.dtype == np.float32, name
        np.testing.assert_allclose(ours, ref, atol=1e-6, err_msg=name)
    assert len(pairs["dtu"][0]) == num_views // 5 * 6


# ---------------------------------------------------------------------------
# one video frame against the JAX app's render


def test_gen_video_frame_matches_jax_render_f32(pair):
    """gen_video's render: its config (at least 64 coarse and 32 fine
    samples), a spherical pose, one frame through ``FullRenderer`` with
    JAX's draws, against the JAX ``render_image`` frame."""
    import types

    from pixelnerf_tpu.data import SyntheticSphereDataset as JaxSynthetic

    jnet, variables, tnet, jconf, tconf = pair
    dset = types.SimpleNamespace(lindisp=False)
    cfg = gen_video.video_render_config(tconf, dset)
    jcfg = jr.RenderConfig.from_conf(jconf["renderer"])
    jcfg = type(jcfg)(**{**jcfg.__dict__, "n_coarse": 64, "n_fine": max(jcfg.n_fine, 32)})
    assert (cfg.n_coarse, cfg.n_fine, cfg.n_fine_depth) == (jcfg.n_coarse, jcfg.n_fine, jcfg.n_fine_depth) == (64, 32, 4)
    data = JaxSynthetic(num_objects=1, num_views=2, image_size=(32, 32), radius=1.3)[0]
    pose = gen_video.spherical_trajectory(12, -10.0, 1.3)[5]
    near, far, side = 0.8, 1.8, 16
    key = jax.random.PRNGKey(4)
    enc = jnet.apply(variables, jnp.asarray(data["images"][None, :1]), jnp.asarray(data["poses"][None, :1]),
                     jnp.asarray(data["focal"]), c=jnp.asarray(data["c"][None]), method=jnet.encode)
    rays = np.asarray(jax_geometry.gen_rays(jnp.asarray(pose[None]), side, side, jnp.asarray(data["focal"] / 2),
                                            near, far, c=jnp.asarray(data["c"] / 2)))[0]
    chunk = side * side
    rgb_j, _ = JaxFullRenderer(jnet, jcfg, ray_chunk=chunk, scan_chunk=chunk).render_image(variables, enc, rays, key)
    with torch.inference_mode():
        tenc = tnet.encode(torch.from_numpy(data["images"][None, :1]), torch.from_numpy(data["poses"][None, :1]),
                           torch.as_tensor(data["focal"]), c=torch.from_numpy(data["c"][None]))
    noise = jax_eval_draws(key, 1, chunk, chunk, jcfg)
    rgb_t, _ = FullRenderer(tnet, cfg, ray_chunk=chunk).render_image(tenc, torch.from_numpy(rays), noise=noise)
    np.testing.assert_allclose(rgb_t.numpy(), np.asarray(rgb_j), atol=5e-4)
    assert float(np.std(rgb_j)) > 1e-3


# ---------------------------------------------------------------------------
# the apps against the JAX apps


def _frames_spread(a, b):
    """The largest per-frame mean absolute difference of two frame lists,
    in 8-bit levels."""
    return max(float(np.abs(x.astype(np.float64) - y).mean()) for x, y in zip(a, b))


def _gif_frames(path):
    return [np.asarray(f.convert("RGB")) for f in ImageSequence.Iterator(Image.open(path))]


# Two seeds of the port draw other stratified samples and so render other
# frames; the JAX app draws others again. Its frames may differ from the
# port's seed 0 by at most twice the spread of the port's two seeds (the
# same random process: ~1x expected, 2x leaves room for sampling noise) and
# a quarter of a level for the rounding of the two libraries' floats.
# Measured on the fixture (mean absolute difference, 8-bit levels): JAX
# against the port 0.37 / 2.50 / 2.47, the port's two seeds 0.39 / 2.48 /
# 2.34 (gen_video / eval_real's two inputs).
SPREAD_FACTOR, SPREAD_SLACK = 2.0, 0.25


def test_gen_video_matches_jax_app(work, tmp_path, capsys):
    from pixelnerf_tpu.apps import gen_video as jax_app

    flags = ["-F", "srn", "-D", work["data"], "-P", "1", "--subset", "1", "--num_views", "2", "-R", "512",
             "--traj", "spherical"]
    ours = [gen_video.main(_common(work) + flags + ["-O", str(tmp_path / f"port{s}"), "--seed", str(s)])
            for s in (0, 1)]
    printed = capsys.readouterr().out
    ref = jax_app.main(_common(work, port=False) + flags + ["-O", str(tmp_path / "jax")])
    jax_printed = capsys.readouterr().out
    assert sorted(os.listdir(tmp_path / "port0")) == sorted(os.listdir(tmp_path / "jax")) == \
        ["ref_obj1.gif", "ref_obj1_src.png"]
    assert len(ours[0]) == len(ours[1]) == len(ref) == 2
    assert [l for l in printed.splitlines() if l.startswith("frame")][:2] == \
        [l for l in jax_printed.splitlines() if l.startswith("frame")]
    assert "mp4 unavailable" in printed and "mp4 unavailable" in jax_printed
    np.testing.assert_array_equal(png.imread(str(tmp_path / "port0" / "ref_obj1_src.png")),
                                  imageio.imread(str(tmp_path / "jax" / "ref_obj1_src.png")))
    spread = _frames_spread(ours[0], ours[1])
    assert 0 < spread
    assert _frames_spread(ours[0], ref) <= SPREAD_FACTOR * spread + SPREAD_SLACK
    # the GIF holds the frames, quantized as well as imageio quantizes them
    assert len(_gif_frames(str(tmp_path / "port0" / "ref_obj1.gif"))) == 2
    assert all(len(np.unique(f.reshape(-1, 3), axis=0)) > 256 for f in ours[0])
    psnr, psnr_imageio = gif_psnr_against_imageio(tmp_path, ours[0])
    assert psnr >= psnr_imageio - 1.0


def test_eval_real_matches_jax_app(work, tmp_path, capsys):
    """A 64x64 input at ``--size 32`` (the factor-2 area resize) and a
    32x32 one; frames always, the GIF unless ``--no_vid``; a JPEG raises."""
    from pixelnerf_tpu.apps import eval_real as jax_app
    from pixelnerf_tpu_torch.apps import eval_real

    inp = tmp_path / "input"
    inp.mkdir()
    small = png.imread(os.path.join(work["data"] + "_test", "test0", "rgb", "000000.png"))
    noise = np.random.default_rng(3).integers(-20, 21, (64, 64, 3))
    big = np.clip(np.repeat(np.repeat(small, 2, 0), 2, 1) + noise, 0, 255).astype(np.uint8)
    png.imwrite(str(inp / "a_normalize.png"), big)
    png.imwrite(str(inp / "b_normalize.png"), small)
    flags = ["--input", str(inp), "--size", "32", "--num_views", "2", "-R", "512"]
    ours = {}
    for s in (0, 1):
        out = tmp_path / f"port{s}"
        eval_real.main(_common(work) + flags + ["-O", str(out), "--seed", str(s)])
        ours[s] = {b: [png.imread(str(out / f"{b}_frames" / f)) for f in sorted(os.listdir(out / f"{b}_frames"))]
                   for b in ("a_normalize", "b_normalize")}
    jax_app.main(_common(work, port=False) + flags + ["-O", str(tmp_path / "jax")])
    printed = capsys.readouterr().out
    assert printed.count("Rendered") == 6
    listing = lambda d: sorted((p, sorted(f)) for p, _, f in os.walk(d))           # noqa: E731
    assert [(os.path.relpath(p, tmp_path / "port0"), f) for p, f in listing(tmp_path / "port0")] == \
        [(os.path.relpath(p, tmp_path / "jax"), f) for p, f in listing(tmp_path / "jax")]
    assert sorted(os.listdir(tmp_path / "port0")) == ["a_normalize.gif", "a_normalize_frames",
                                                      "b_normalize.gif", "b_normalize_frames"]
    for b in ("a_normalize", "b_normalize"):
        ref = [imageio.imread(str(tmp_path / "jax" / f"{b}_frames" / f"{i:04}.png")) for i in range(2)]
        spread = _frames_spread(ours[0][b], ours[1][b])
        assert 0 < spread and _frames_spread(ours[0][b], ref) <= SPREAD_FACTOR * spread + SPREAD_SLACK, b
    # the resize is OpenCV's: the encoded input is the JAX app's
    import cv2

    from pixelnerf_tpu_torch.apps.eval_real import read_input, resize_uint8_like_cv2

    a = imageio.imread(str(inp / "a_normalize.png"))
    np.testing.assert_array_equal(read_input(str(inp / "a_normalize.png"), 32),
                                  (cv2.resize(a, (32, 32), interpolation=cv2.INTER_AREA).astype(np.float32) / 255.0
                                   - 0.5) / 0.5)
    rng = np.random.default_rng(0)
    for shape, out in (((64, 64, 3), (32, 32)), ((128, 128, 3), (32, 32)), ((64, 128, 3), (32, 32)),
                       ((64, 32, 3), (32, 32))):
        img = rng.integers(0, 256, shape).astype(np.uint8)
        np.testing.assert_array_equal(resize_uint8_like_cv2(img, *out),
                                      cv2.resize(img, out[::-1], interpolation=cv2.INTER_AREA))
    with pytest.raises(NotImplementedError, match="not a downscale by 1, 2 or 4"):
        resize_uint8_like_cv2(np.zeros((48, 48, 3), np.uint8), 32, 32)
    # --no_vid: frames only; a JPEG input raises
    eval_real.main(_common(work) + flags + ["-O", str(tmp_path / "novid"), "--no_vid"])
    assert sorted(os.listdir(tmp_path / "novid")) == ["a_normalize_frames", "b_normalize_frames"]
    (tmp_path / "c.jpg").write_bytes(b"\xff\xd8\xff")
    with pytest.raises(NotImplementedError, match="PNG files only"):
        eval_real.main(_common(work) + ["--input", str(tmp_path / "c.jpg"), "-O", str(tmp_path / "jpg")])
    capsys.readouterr()


# ---------------------------------------------------------------------------
# the GIF writer


def _smooth_frames(n=3, h=24, w=40, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    return [np.stack([(xx * 6 + 9 * k) % 256, (yy * 10 + 5 * k) % 256,
                      (xx * 3 + yy * 4 + rng.integers(0, 30, (h, w))) % 256], -1).astype(np.uint8)
            for k in range(n)]


@pytest.mark.parametrize("fps", [30, 15, 7])
def test_gif_decodes_with_imageios_timing(tmp_path, fps):
    frames = _smooth_frames()
    ours, ref = str(tmp_path / "ours.gif"), str(tmp_path / "ref.gif")
    gif.mimwrite(ours, frames, duration=1000 / fps)
    imageio.mimwrite(ref, frames, duration=1000 / fps)
    a, b = Image.open(ours), Image.open(ref)
    assert a.n_frames == b.n_frames == len(frames)
    assert a.info["duration"] == b.info["duration"] == int(1000 / fps / 10) * 10
    assert a.info.get("loop") == b.info.get("loop")
    with open(ours, "rb") as f:
        raw = f.read()
    assert raw[:6] == b"GIF89a" and raw[-1:] == b"\x3b"


def test_gif_is_exact_at_256_colours(tmp_path):
    """Frames of at most 256 colours decode bit for bit: random indices
    into a 256-colour palette (the LZW table fills and clears many times)
    and long runs (long codes, 12-bit widths)."""
    rng = np.random.default_rng(1)
    pal = rng.integers(0, 256, (256, 3)).astype(np.uint8)
    frames = [pal[rng.integers(0, 256, (96, 128))], pal[(np.arange(96 * 128) // 777 % 5).reshape(96, 128)],
              np.full((96, 128, 3), 200, np.uint8), pal[:2][rng.integers(0, 2, (96, 128))]]
    path = str(tmp_path / "exact.gif")
    gif.mimwrite(path, frames, duration=40)
    decoded = _gif_frames(path)
    assert len(decoded) == len(frames)
    for got, want in zip(decoded, frames):
        np.testing.assert_array_equal(got, want)


def gif_psnr_against_imageio(tmp_path, frames):
    """The PSNR (over all frames' pixels) of the port's GIF of ``frames`` and
    of imageio's, each decoded by Pillow."""
    def psnr(path):
        err = np.concatenate([(a.astype(np.float64) - b).reshape(-1) for a, b in zip(_gif_frames(path), frames)])
        return 10 * np.log10(255.0 ** 2 / np.mean(err ** 2))

    gif.mimwrite(str(tmp_path / "ours.gif"), frames, duration=50)
    imageio.mimwrite(str(tmp_path / "ref.gif"), frames, duration=50)
    return psnr(str(tmp_path / "ours.gif")), psnr(str(tmp_path / "ref.gif"))


def test_gif_quantizes_as_well_as_imageio(tmp_path):
    """Frames of more than 256 colours (smooth gradients with noise): the
    port's median cut reaches a PSNR at most 1 dB below that of imageio's
    GIF of the same frames (the rendered frames: ``test_gen_video_matches_jax_app``)."""
    frames = _smooth_frames(3, 64, 64)
    assert all(len(np.unique(f.reshape(-1, 3), axis=0)) > 256 for f in frames)
    ours, ref = gif_psnr_against_imageio(tmp_path, frames)
    assert ours >= ref - 1.0


# ---------------------------------------------------------------------------
# LPIPS


def _lpips_images(shape=(2, 35, 37, 3), seed=2):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1, 1, shape).astype(np.float32), rng.uniform(-1, 1, shape).astype(np.float32)


@pytest.mark.parametrize("full_format", [False, True])
def test_lpips_matches_jax(full_format):
    sd = _random_torch_state_dict(seed=1, full_lpips_format=full_format)
    a, b = _lpips_images()
    ref = np.asarray(jax_lpips.lpips_distance(jax_lpips.import_lpips_state_dict(sd), a, b))
    ours = lpips.LPIPS(lpips.import_lpips_state_dict(sd))(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(ours.numpy(), ref, rtol=2e-4, atol=2e-6)
    if full_format:
        # the same seed gives both packages' init the same network
        params = jax_lpips.init_lpips_params(np.random.default_rng(5))
        ours = lpips.LPIPS(lpips.init_lpips_params(np.random.default_rng(5)))(torch.from_numpy(a), torch.from_numpy(b))
        np.testing.assert_allclose(ours.numpy(), np.asarray(jax_lpips.lpips_distance(params, a, b)),
                                   rtol=2e-4, atol=2e-6)


def test_lpips_matches_committed_referee_fixture(tmp_path):
    rec = np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures", "lpips_referee_golden.npz"))
    rng = np.random.default_rng(int(rec["img_seed"]))
    shape = tuple(rec["shape"])
    a = rng.uniform(-1, 1, shape).astype(np.float32)
    b = rng.uniform(-1, 1, shape).astype(np.float32)
    for seed, fmt in ((1, False), (7, True)):
        path = str(tmp_path / f"w{seed}.pth")
        torch.save(_random_torch_state_dict(seed=seed, full_lpips_format=fmt), path)
        ours = lpips.LPIPS.from_torch_file(path)(torch.from_numpy(a), torch.from_numpy(b))
        np.testing.assert_allclose(ours.numpy(), rec[f"ref_seed{seed}_full{int(fmt)}"], rtol=2e-4, atol=2e-6)


def test_lpips_importer_refuses_and_skips():
    sd = _random_torch_state_dict(seed=1)
    for key, match in (("lin2.model.1.weight", "missing lin-head"), ("features.12.bias", "slice 2 conv 1")):
        bad = dict(sd)
        bad.pop(key)
        with pytest.raises(ValueError, match=match):
            lpips.import_lpips_state_dict(bad)
    extra = {**sd, "classifier.0.weight": torch.zeros(16, 25088), "classifier.0.bias": torch.zeros(16),
             "scaling_layer.shift": torch.zeros(1, 3, 1, 1), "features.4.weight": torch.zeros(1)}
    params = lpips.import_lpips_state_dict(extra)
    assert params["convs"][0][0]["weight"].shape == (64, 3, 3, 3) and len(params["lins"]) == 5
    # identity is 0, the distance is symmetric
    a, b = _lpips_images((1, 32, 32, 3), 3)
    lp = lpips.LPIPS(params)
    d = lp(torch.from_numpy(np.concatenate([a, a, b])), torch.from_numpy(np.concatenate([a, b, a])))
    assert abs(float(d[0])) < 1e-6 and float(d[1]) > 0
    np.testing.assert_allclose(float(d[1]), float(d[2]), rtol=1e-5)


# ---------------------------------------------------------------------------
# calc_metrics


def _metrics_tree(root):
    """A two-category DVR-layout tree with renders (NMR-like: 4-digit
    ground-truth names, ``softras_test.lst``, ``metadata.yaml``)."""
    import json

    rng = np.random.default_rng(0)
    data, out = root / "data", root / "renders"
    (data / "_meta").mkdir(parents=True)
    out.mkdir()
    (data / "metadata.yaml").write_text(json.dumps({"02691156": {"name": "airplane,aeroplane,plane"},
                                                     "02958343": {"name": "car,auto,automobile"}}))
    for cat, obj in (("02691156", "obj1"), ("02958343", "objA"), ("02958343", "objB")):
        (data / cat / obj / "image").mkdir(parents=True)
        with open(data / cat / "softras_test.lst", "a") as f:
            f.write(obj + "\n")
        (out / f"{cat}_{obj}").mkdir()
        for v in range(4):
            gt = rng.uniform(0, 1, (16, 18, 3))
            imageio.imwrite(str(data / cat / obj / "image" / f"{v:04}.png"), (gt * 255).astype(np.uint8))
            pred = np.clip(gt + rng.normal(0, 0.05 * (v + 1), gt.shape), 0, 1)
            imageio.imwrite(str(out / f"{cat}_{obj}" / f"{v:06}.png"), (pred * 255).astype(np.uint8))
    return data, out


def test_calc_metrics_matches_jax_app(tmp_path):
    import shutil

    from pixelnerf_tpu.apps import calc_metrics as jax_app
    from pixelnerf_tpu_torch.apps import calc_metrics

    data, out = _metrics_tree(tmp_path)
    weights = str(tmp_path / "lpips.pth")
    torch.save(_random_torch_state_dict(seed=7, full_lpips_format=True), weights)
    viewlist = tmp_path / "src.txt"
    viewlist.write_text("02691156 obj1 1\n02958343 objB 3\n")
    views = tmp_path / "views.txt"
    views.write_text("0 1 2 3 4\n")
    flags = ["-D", str(data), "-F", "dvr", "--multicat", "-L", str(viewlist), "-P", "2", "--exclude_dtu_bad",
             "--eval_view_list", str(views), "--lpips_weights", weights, "--lpips_batch_size", "2"]
    jax_out = tmp_path / "jax_renders"
    shutil.copytree(out, jax_out)
    calc_metrics.main(flags + ["-O", str(out), "--device", "cpu", "--require_lpips"])
    jax_app.main(flags + ["-O", str(jax_out), "--require_lpips"])

    def read(path):
        return [l.split() for l in open(path).read().splitlines()]

    objs = sorted(d for d in os.listdir(out) if os.path.isdir(out / d))
    assert len(objs) == 3
    for d in objs:
        ours, ref = read(out / d / "metrics.txt"), read(jax_out / d / "metrics.txt")
        assert [r[0] for r in ours] == [r[0] for r in ref] == ["psnr", "ssim", "lpips"]
        np.testing.assert_allclose([float(r[1]) for r in ours], [float(r[1]) for r in ref], rtol=1e-6, err_msg=d)
    ours, ref = open(out / "all_metrics.txt").read(), open(jax_out / "all_metrics.txt").read()
    number = re.compile(r"-?\d+\.\d+")
    assert number.sub("x", ours) == number.sub("x", ref) and ours.splitlines()[-1].startswith("total")
    assert "airplane" in ours and "n_inst: 2" in ours
    np.testing.assert_allclose([float(x) for x in number.findall(ours)], [float(x) for x in number.findall(ref)],
                               rtol=1e-6)
    # -R: reduce only, the same report
    calc_metrics.main(["-D", str(data), "-O", str(out), "--multicat", "-R"])
    assert open(out / "all_metrics.txt").read() == ours


def test_calc_metrics_skips_lpips_loudly_and_requires_it(tmp_path, capsys):
    from pixelnerf_tpu.apps import calc_metrics as jax_app
    from pixelnerf_tpu_torch.apps import calc_metrics

    data, out = _metrics_tree(tmp_path)
    calc_metrics.main(["-D", str(data), "-O", str(out), "--multicat"])
    ours = capsys.readouterr()
    jax_app.main(["-D", str(data), "-O", str(out), "--multicat", "--overwrite"])
    ref = capsys.readouterr()
    warning = [l for l in ref.err.splitlines() if "LPIPS is SKIPPED" in l]
    assert warning and [l for l in ours.err.splitlines() if "LPIPS is SKIPPED" in l] == warning
    assert "lpips" not in open(out / "all_metrics.txt").read()
    with pytest.raises(SystemExit, match="--require_lpips"):
        calc_metrics.main(["-D", str(data), "-O", str(out), "--multicat", "--require_lpips"])


# ---------------------------------------------------------------------------
# the export


def test_export_state_dict_matches_jax_export(pair, tmp_path, capsys):
    from pixelnerf_tpu.models.torch_import import export_state_dict as jax_export
    from pixelnerf_tpu_torch.apps import export_torch
    from pixelnerf_tpu_torch.models import export_state_dict, load_reference_state_dict, make_model
    from pixelnerf_tpu_torch.train.state import save_checkpoint

    _, variables, tnet, _, tconf = pair
    # the JAX model's float32 weights (perturb leaves some leaves float64)
    variables = jax.tree_util.tree_map(lambda v: np.asarray(v, np.float32), variables)
    ref = jax_export(variables)
    ours = export_state_dict(tnet.state_dict())
    assert set(ours) == set(ref)
    for k, v in ref.items():
        assert ours[k].dtype == torch.float32, k
        np.testing.assert_array_equal(ours[k].numpy(), v, err_msg=k)
    # the app: the port's checkpoint -> pixel_nerf_latest, loaded strictly
    opt = torch.optim.Adam(tnet.parameters())
    save_checkpoint(str(tmp_path / "ck" / "exp"), tnet, opt, 17)
    export_torch.main(["-n", "exp", "--checkpoints_path", str(tmp_path / "ck")])
    path = str(tmp_path / "ck" / "exp" / "pixel_nerf_latest")
    assert f"Exported step-17 weights ({len(ref)} tensors) to {path}" in capsys.readouterr().out
    fresh = make_model(tconf["model"], device="cpu", generator=torch.Generator().manual_seed(9))
    assert load_reference_state_dict(fresh, torch.load(path, weights_only=True)) == []
    own = tnet.state_dict()
    for k, v in fresh.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            torch.testing.assert_close(v, own[k], atol=0, rtol=0, msg=k)
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        export_torch.main(["-n", "absent", "--checkpoints_path", str(tmp_path / "ck")])


# ---------------------------------------------------------------------------
# --profile_dir


def test_train_app_profile_dir_writes_a_trace(work, tmp_path, monkeypatch, capsys):
    """``--profile_dir`` on the CPU, with ``--train_remat dots`` on two ray chunks."""
    import json

    from pixelnerf_tpu_torch.apps import train

    monkeypatch.setenv("PIXELNERF_NO_TB", "1")
    prof = tmp_path / "prof"
    trainer = train.main(["-c", SRN_CONF, "-F", "srn", "-D", work["data"], "-B", "1", "-R", "16", "--epochs", "1",
                          "--epoch_batches", "1", "--workers", "1", "--device", "cpu", "--profile_dir", str(prof),
                          "--train_ray_chunk", "8", "--train_remat", "dots",
                          "--checkpoints_path", str(tmp_path / "ck"), "--logs_path", str(tmp_path / "logs"),
                          "--visual_path", str(tmp_path / "vis")] + TINY)
    assert trainer.step == 1 and trainer.train_remat == "dots"
    files = os.listdir(prof)
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    events = json.load(open(prof / files[0]))["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)
    capsys.readouterr()
