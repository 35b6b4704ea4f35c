"""The port's real-image preprocessor (``apps/preproc.py``) and its image
operations (``utils/imgproc.py``, ``utils/grabcut.py``) on the CPU, against
``cv2`` (which only this test imports) and the JAX app:

- the structuring element, dilate, erode, close, the mask cleanup, the
  contours and their areas, the ellipse fit, ``normalize_image`` and the
  INTER_AREA resize: equal to OpenCV's and the JAX app's, bit for bit;
- GrabCut with OpenCV's own initial models: one ``EVAL`` step learns
  OpenCV's models (to 1e-9), and a cut with frozen models gives OpenCV's
  mask but for at most 0.1% of the ``PR_*`` pixels;
- the whole two-pass segmentation against the JAX app's by IoU (the port
  cannot draw OpenCV's random numbers);
- the app end to end, ``preproc`` then ``eval_real``; its raises and flags.
"""
import argparse
import os

import cv2
import imageio.v2 as imageio
import numpy as np
import pytest

from pixelnerf_tpu.apps import preproc as jax_preproc
from pixelnerf_tpu.data import SyntheticSphereDataset
from pixelnerf_tpu_torch.apps import preproc
from pixelnerf_tpu_torch.utils import grabcut as gc
from pixelnerf_tpu_torch.utils import imgproc, png

from torch_port_utils import REPO, SRN_CONF, TINY

PHOTOS = {name: os.path.join(REPO, "raw", f"{name}.png") for name in ("photo1", "photo2")}


def _blobs(h, w, n, seed, noise=0.02):
    """A 0/255 mask of ``n`` seeded rotated ellipses (some cut by the
    border), with a share ``noise`` of pixels flipped: stray blobs and
    holes."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    m = np.zeros((h, w), np.uint8)
    for _ in range(n):
        cy, cx = rng.integers(0, h), rng.integers(0, w)
        ay, ax = rng.integers(2, h // 3), rng.integers(2, w // 3)
        th = rng.random() * np.pi
        u = (xx - cx) * np.cos(th) + (yy - cy) * np.sin(th)
        v = -(xx - cx) * np.sin(th) + (yy - cy) * np.cos(th)
        m[(u / ax) ** 2 + (v / ay) ** 2 <= 1] = 255
    flip = rng.random((h, w)) < noise
    m[flip] = 255 - m[flip]
    return m


def _sphere():
    ds = SyntheticSphereDataset(num_objects=1, num_views=1, image_size=(96, 96))
    return ((ds[0]["images"][0] * 0.5 + 0.5) * 255).astype(np.uint8)


def _iou(a, b):
    return (a & b).sum() / (a | b).sum()


# ---------------------------------------------------------------------------
# imgproc against cv2


@pytest.mark.parametrize("k", range(3, 22, 2))
def test_ellipse_kernel_is_opencvs(k):
    np.testing.assert_array_equal(imgproc.ellipse_kernel(k), cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (k, k)))


@pytest.mark.parametrize("op", ["dilate", "erode", "close"])
def test_morphology_is_opencvs(op):
    """Seeded masks with blobs cut by the border, at the app's 7 and 15 and
    at 3."""
    for seed in range(6):
        m = _blobs(60, 70, 4, seed)
        for k in (3, 7, 15):
            kern = cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (k, k))
            ref = {"dilate": lambda: cv2.dilate(m, kern), "erode": lambda: cv2.erode(m, kern),
                   "close": lambda: cv2.morphologyEx(m, cv2.MORPH_CLOSE, kern)}[op]()
            np.testing.assert_array_equal(getattr(imgproc, op)(m, k), ref, err_msg=f"{op} k={k} seed={seed}")


def test_cleanup_mask_is_the_jax_apps():
    """Largest component (a tie goes to OpenCV's first label, which follows
    2x2 blocks), close and hole fill; masks touching (0, 0) included."""
    for seed in range(24):
        m = _blobs(60, 70, 3, seed + 500)
        if seed % 4 == 0:
            m[0:10, 0:10] = 255
        np.testing.assert_array_equal(preproc._cleanup_mask(m), jax_preproc._cleanup_mask(m), err_msg=str(seed))
    # two components of 2 pixels: OpenCV labels (1, 0)'s block before (0, 5)'s
    tie = np.zeros((10, 10), np.uint8)
    tie[0, 5:7] = 255
    tie[1:3, 0] = 255
    np.testing.assert_array_equal(preproc._cleanup_mask(tie), jax_preproc._cleanup_mask(tie))
    assert imgproc.largest_component(tie)[1, 0] == 255


def test_contours_and_areas_are_opencvs():
    """Point lists (start, direction, compressed points), list order and
    ``contourArea`` on seeded masks of several blobs with holes and stray
    pixels."""
    for seed in range(60):
        m = _blobs(50, 60, 5, seed)
        ref, _ = cv2.findContours(m, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)
        ours = imgproc.find_external_contours(m)
        assert len(ours) == len(ref), seed
        for a, b in zip(ours, ref):
            np.testing.assert_array_equal(a, b, err_msg=str(seed))
            assert imgproc.contour_area(a) == cv2.contourArea(b)


def test_fit_ellipse_is_opencvs():
    """Centre, axes and angle equal in float32 on 60 seeded blobs; fewer
    than 5 points give None; points without a unique conic raise."""
    fitted = 0
    for seed in range(60):
        m = _blobs(80, 90, 1, seed + 1000)
        cs, _ = cv2.findContours(m, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)
        c = max(cs, key=cv2.contourArea)
        if len(c) < 5:
            continue
        (cx, cy), (w, h), ang = cv2.fitEllipse(c)
        (ox, oy), (ow, oh), oang = imgproc.fit_ellipse(c)
        assert (ox, oy, ow, oh, oang) == tuple(np.float32(v) for v in (cx, cy, w, h, ang)), seed
        fitted += 1
    assert fitted >= 50
    assert imgproc.fit_ellipse(np.array([[0, 0], [1, 1], [2, 0], [1, 2]], np.int32)) is None
    with pytest.raises(NotImplementedError, match="no unique conic"):
        imgproc.fit_ellipse(np.array([[i, i] for i in range(6)], np.int32))


@pytest.mark.parametrize("size_in, size_out", [(420, 128), (874, 128), (1000, 128), (177, 32), (256, 128),
                                               (384, 128), (512, 128), (300, 128)])
def test_resize_area_uint8_downscale_is_opencvs(size_in, size_out):
    rng = np.random.default_rng(size_in)
    for cn in (3, 1):
        img = rng.integers(0, 256, (size_in, size_in, cn)[: 3 if cn == 3 else 2]).astype(np.uint8)
        np.testing.assert_array_equal(imgproc.resize_area(img, size_out, size_out),
                                      cv2.resize(img, (size_out, size_out), interpolation=cv2.INTER_AREA))


@pytest.mark.parametrize("shape_in, shape_out", [((420, 420), (128, 128)), ((177, 177), (32, 32)),
                                                 ((64, 96), (48, 40)), ((64, 64), (32, 32)),
                                                 ((128, 128), (32, 32)), ((256, 256), (32, 32)),
                                                 ((96, 96), (32, 32)), ((40, 60), (8, 12))])
def test_resize_area_float32_is_opencvs(shape_in, shape_out):
    """Ratios that are no integer, and integer factors 2, 4, 8, 3 and 5
    (OpenCV's fast path: its 2 x 2 vector sums, else the block's samples
    four at a time)."""
    rng = np.random.default_rng(sum(shape_in))
    for cn in (3, 1):
        img = rng.random(shape_in + ((cn,) if cn == 3 else ())).astype(np.float32)
        np.testing.assert_array_equal(imgproc.resize_area(img, *shape_out),
                                      cv2.resize(img, shape_out[::-1], interpolation=cv2.INTER_AREA))


@pytest.mark.parametrize("size_in", [64, 100, 37])
def test_resize_area_uint8_upscale_is_opencvs(size_in):
    """OpenCV's INTER_AREA upscale (linear with area offsets, 11-bit
    weights, its vector loop's rounding): equal on these inputs (the
    contract allows one level); so are the float32 upscale and the mixed
    resize, which once raised."""
    rng = np.random.default_rng(size_in)
    img = rng.integers(0, 256, (size_in, size_in, 3)).astype(np.uint8)
    ref = cv2.resize(img, (128, 128), interpolation=cv2.INTER_AREA)
    ours = imgproc.resize_area(img, 128, 128)
    assert np.abs(ours.astype(int) - ref).max() <= 1
    np.testing.assert_array_equal(ours, ref)
    for x, (oh, ow) in ((img.astype(np.float32), (128, 128)), (img, (128, size_in // 2))):
        np.testing.assert_array_equal(imgproc.resize_area(x, oh, ow),
                                      cv2.resize(x, (ow, oh), interpolation=cv2.INTER_AREA))


# ---------------------------------------------------------------------------
# normalize_image against the JAX app


def _ellipse_mask(h, w, a, b, cx, cy):
    yy, xx = np.mgrid[0:h, 0:w]
    return ((((xx - cx) / a) ** 2 + ((yy - cy) / b) ** 2) <= 1.0).astype(np.uint8) * 255


@pytest.mark.parametrize("case", ["elongated", "past_the_edge", "photo", "empty", "tiny"])
def test_normalize_image_is_the_jax_apps(case):
    rng = np.random.default_rng(7)
    img = rng.integers(0, 256, (256, 256, 3)).astype(np.uint8)
    mask = {
        "elongated": lambda: _ellipse_mask(256, 256, 30.0, 12.0, 131.0, 127.0),   # test_apps_smoke's
        "past_the_edge": lambda: _ellipse_mask(256, 256, 40.0, 25.0, 20.0, 230.0),
        "photo": lambda: _blobs(256, 256, 2, 11, noise=0.0),
        "empty": lambda: np.zeros((256, 256), np.uint8),
        "tiny": lambda: np.pad(np.full((2, 2), 255, np.uint8), 127),
    }[case]()
    for size in (128, 64):
        ref = jax_preproc.normalize_image(img, mask, size=size)
        ours = preproc.normalize_image(img, mask, size=size)
        if case in ("empty", "tiny"):
            assert ref is None and ours is None
        else:
            np.testing.assert_array_equal(ours, ref)


# ---------------------------------------------------------------------------
# GrabCut against cv2


def _grabcut_inputs():
    photo = imageio.imread(PHOTOS["photo1"])[..., :3]
    small = cv2.resize(photo, (128, 128), interpolation=cv2.INTER_AREA)
    return {"photo128": small[..., ::-1].copy(), "sphere": _sphere()[..., ::-1].copy()}


@pytest.mark.parametrize("name", ["photo128", "sphere"])
def test_grabcut_learns_and_cuts_as_opencv(name):
    """From OpenCV's initial trimap and models (``iterCount=0``), one port
    ``EVAL`` step learns OpenCV's ``GC_EVAL`` models within 1e-9, and a
    ``EVAL_FREEZE_MODEL`` cut on OpenCV's learnt models gives OpenCV's
    mask on all but 0.1% of the ``PR_*`` pixels (both measured exact)."""
    img = _grabcut_inputs()[name]
    h, w = img.shape[:2]
    rect = (int(w * 0.08), int(h * 0.08), int(w * 0.84), int(h * 0.84))
    cv2.setRNGSeed(0)
    mask = np.zeros((h, w), np.uint8)
    bgd, fgd = np.zeros((1, 65)), np.zeros((1, 65))
    cv2.grabCut(img, mask, rect, bgd, fgd, 0, cv2.GC_INIT_WITH_RECT)
    ours_init, _ = gc.grabcut(img, None, rect, 0, gc.INIT_WITH_RECT)
    np.testing.assert_array_equal(ours_init, mask)

    m1, b1, f1 = mask.copy(), bgd.copy(), fgd.copy()
    cv2.grabCut(img, m1, None, b1, f1, 1, cv2.GC_EVAL)
    ours, (ob, of) = gc.grabcut(img, mask, None, 1, gc.EVAL, model=(bgd, fgd))
    for a, b in ((ob, b1), (of, f1)):
        assert np.abs(a - b).max() <= 1e-9 * np.abs(b).max()
    soft = mask >= gc.PR_BGD
    assert (ours != m1).sum() <= 1e-3 * soft.sum()

    m2 = m1.copy()
    cv2.grabCut(img, m2, None, b1.copy(), f1.copy(), 1, cv2.GC_EVAL_FREEZE_MODEL)
    frozen, (fb, ff) = gc.grabcut(img, m1, None, 1, gc.EVAL_FREEZE_MODEL, model=(b1, f1))
    assert (frozen != m2).sum() <= 1e-3 * (m1 >= gc.PR_BGD).sum()
    np.testing.assert_array_equal(fb, b1)
    np.testing.assert_array_equal(ff, f1)


def test_grabcut_fixes_near_singular_covariances_and_small_sides_as_opencv():
    """OpenCV adds 0.01 to the diagonal of a learnt covariance whose
    determinant is at most 1e-6 (not only at most DBL_EPSILON), and fits
    min(5, samples) components to a side of fewer than 5 samples."""
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (20, 20, 3)).astype(np.uint8)
    fg = np.zeros((20, 20), bool)
    fg[5:15, 5:15] = True
    img[fg] = 100
    ys, xs = np.nonzero(fg)
    for i, c in enumerate([(101, 100, 100), (100, 101, 100), (100, 100, 101)]):
        img[ys[i], xs[i]] = c          # a covariance of determinant ~9.7e-7
    mask = np.where(fg, gc.PR_FGD, gc.BGD).astype(np.uint8)

    def one_component(mean):
        m = np.zeros((1, 65))
        m[0, 0], m[0, 5:8], m[0, 20:29] = 1.0, mean, np.eye(3).ravel() * 100
        return m

    models = (one_component([128] * 3), one_component([100] * 3))
    m1, b1, f1 = mask.copy(), models[0].copy(), models[1].copy()
    cv2.grabCut(img, m1, None, b1, f1, 1, cv2.GC_EVAL)
    ours, (ob, of) = gc.grabcut(img, mask, None, 1, gc.EVAL, model=models)
    assert f1[0, 20] == pytest.approx(0.0199)
    np.testing.assert_array_equal(of, f1)
    np.testing.assert_array_equal(ob, b1)
    np.testing.assert_array_equal(ours, m1)

    two = np.full((20, 20), gc.PR_BGD, np.uint8)
    two[5, 5:7] = gc.FGD
    b2, f2 = np.zeros((1, 65)), np.zeros((1, 65))
    cv2.grabCut(img, two.copy(), None, b2, f2, 0, cv2.GC_INIT_WITH_MASK)
    _, (_, of2) = gc.grabcut(img, two, None, 0, gc.INIT_WITH_MASK)
    for model in (f2, of2):
        assert sorted(model[0, :5]) == [0, 0, 0, 0.5, 0.5]
    means = lambda m: sorted(map(tuple, m[0, 5:20].reshape(5, 3)[m[0, :5] > 0]))  # noqa: E731
    assert means(of2) == means(f2) == sorted(map(tuple, img[5, 5:7].astype(float)))


def test_grabcut_refuses_a_mask_without_one_side():
    img = _sphere()
    with pytest.raises(gc.GrabCutError):
        gc.grabcut(img, np.full(img.shape[:2], gc.PR_FGD, np.uint8), None, 1, gc.INIT_WITH_MASK)
    with pytest.raises(ValueError):
        gc.grabcut(img, np.full(img.shape[:2], 7, np.uint8), None, 1, gc.INIT_WITH_MASK)


@pytest.fixture(scope="module")
def segmentations():
    """Each input's JAX and port masks (two-pass GrabCut) and normalized
    outputs, computed once."""
    out = {}
    inputs = {name: imageio.imread(p)[..., :3] for name, p in PHOTOS.items()}
    inputs["sphere"] = _sphere()
    for name, rgb in inputs.items():
        bgr = np.ascontiguousarray(rgb[..., ::-1])
        ref = jax_preproc._segment_grabcut(bgr)
        ours = preproc._segment_grabcut(bgr, device="cpu")
        out[name] = (ref, ours, jax_preproc.normalize_image(rgb, ref), preproc.normalize_image(rgb, ours))
    return out


@pytest.mark.parametrize("name", ["photo1", "photo2", "sphere"])
def test_segment_grabcut_agrees_with_the_jax_app(segmentations, name):
    """The two-pass segmentation against the JAX app's (cv2's RNG seeded 0).

    The floors come from cv2 itself: the JAX app with cv2's RNG seeded 1-5
    instead of 0 gave, on ``raw/photo1.png``, mask IoU 0.964-1.0 against
    seed 0 and a normalized foreground IoU of 0.923-1.0; on
    ``raw/photo2.png`` and the sphere, 1.0 at every seed. The port's own
    draws are held to the same spread: mask IoU >= 0.95, normalized
    foreground IoU >= 0.90, and the crop's foreground share within
    0.8-1.25x of the JAX one's (measured: 0.990 / 0.981 on photo1, 1.0 on
    the others)."""
    ref, ours, ref_out, our_out = segmentations[name]
    assert ours is not None and ours.dtype == np.uint8 and set(np.unique(ours)) <= {0, 255}
    assert _iou(ref > 0, ours > 0) >= 0.95
    fg_ref, fg_ours = np.any(ref_out < 250, -1), np.any(our_out < 250, -1)
    assert _iou(fg_ref, fg_ours) >= 0.90
    assert 0.8 <= fg_ours.mean() / fg_ref.mean() <= 1.25
    # given the same mask, the outputs are equal
    rgb = imageio.imread(PHOTOS[name])[..., :3] if name in PHOTOS else _sphere()
    np.testing.assert_array_equal(preproc.normalize_image(rgb, ref), ref_out)


@pytest.mark.parametrize("name", ["photo1", "photo2"])
def test_committed_normalize_pngs_predate_the_app(segmentations, name):
    """``input/<photo>_normalize.png`` were written by an earlier preproc:
    their foreground covers 50.6% and 58.6% of the frame, the JAX and the
    port's apps' 5.6-5.7% and 7.4%, a foreground IoU of 0.11-0.13. They
    are no reference for either app."""
    committed = png.imread(os.path.join(REPO, "input", f"{name}_normalize.png"))[..., :3]
    _, _, ref_out, our_out = segmentations[name]
    fg = np.any(committed < 250, -1)
    for out in (ref_out, our_out):
        assert _iou(np.any(out < 250, -1), fg) < 0.2
    assert fg.mean() > 4 * np.any(ref_out < 250, -1).mean()


# ---------------------------------------------------------------------------
# the app


def test_preproc_then_eval_real_on_the_cpu(tmp_path, capsys):
    """``preproc --backend grabcut --cpu`` on the sphere photo of
    ``test_apps_smoke.py``, then the port's ``eval_real`` at ``--size 32``
    (a random init, the TINY model); the written PNG equals the JAX app's
    given the port's mask, and the report names each step's time."""
    from pixelnerf_tpu_torch.apps import eval_real

    raw = tmp_path / "raw"
    raw.mkdir()
    png.imwrite(str(raw / "photo.png"), _sphere())
    report = preproc.main(["--input", str(raw), "--output", str(tmp_path / "input"), "--size", "32",
                           "--backend", "grabcut", "--cpu"])
    out = png.imread(str(tmp_path / "input" / "photo_normalize.png"))
    assert out.shape == (32, 32, 3) and out.min() < 255 and out.max() == 255
    rep = report[str(raw / "photo.png")]
    assert {"read", "pass1_device", "pass1_cut", "pass2_device", "pass2_cut", "cleanup", "ellipse", "resize",
            "write"} <= set(rep["ms"])
    assert 0 < rep["foreground"] < 1 and rep["radius"] > 0
    mask = preproc._segment_grabcut(_sphere()[..., ::-1].copy(), device="cpu")
    np.testing.assert_array_equal(out, jax_preproc.normalize_image(_sphere(), mask, size=32))

    eval_real.main(["-n", "ref", "-c", SRN_CONF, "--checkpoints_path", str(tmp_path / "ck"), "--device", "cpu",
                    "--input", str(tmp_path / "input"), "-O", str(tmp_path / "real_out"), "--size", "32",
                    "--num_views", "2", "-R", "1024"] + TINY)
    frames = sorted(os.listdir(tmp_path / "real_out" / "photo_normalize_frames"))
    assert frames == ["0000.png", "0001.png"]
    assert "Rendered photo_normalize" in capsys.readouterr().out


def test_preproc_raises_on_jpeg_and_gray_png(tmp_path):
    """A truncated JPEG raises, naming the file (imageio raises too), and a
    whole one is read as imageio reads it; a gray input raises."""
    (tmp_path / "a.jpg").write_bytes(b"\xff\xd8\xff")
    with pytest.raises((OSError, SyntaxError)):              # Pillow's errors
        imageio.imread(str(tmp_path / "a.jpg"))
    with pytest.raises(ValueError, match="a.jpg: truncated"):
        preproc.main(["--input", str(tmp_path / "a.jpg"), "--output", str(tmp_path / "o"), "--cpu",
                      "--backend", "grabcut"])
    cv2.imwrite(str(tmp_path / "b.jpg"), np.ascontiguousarray(_sphere()[..., ::-1]))      # OpenCV's encoder
    np.testing.assert_array_equal(preproc.read_rgb(str(tmp_path / "b.jpg")), imageio.imread(str(tmp_path / "b.jpg")))
    png.imwrite(str(tmp_path / "g.png"), np.full((16, 16), 90, np.uint8))
    with pytest.raises(ValueError, match="8-bit RGB"):
        preproc.main(["--input", str(tmp_path / "g.png"), "--output", str(tmp_path / "o"), "--cpu",
                      "--backend", "grabcut"])


class _Parsed(Exception):
    pass


def test_preproc_takes_every_flag_of_the_jax_app(monkeypatch):
    seen = {}

    def capture(self, argv=None, namespace=None):
        seen["flags"] = {s for a in self._actions for s in a.option_strings}
        raise _Parsed

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", capture)
        with pytest.raises(_Parsed):
            jax_preproc.main([])
    jax_flags = seen["flags"]
    assert {"--input", "--output", "--size", "--coco_class", "--backend", "-S", "-M", "--const_border"} <= jax_flags
    args = preproc.parse_args(["--gpu_id", "1", "--cpu", "-S", "3", "-M", "0.5", "--const_border"])
    assert (args.device, args.scale, args.major_scale, args.const_border) == ("cpu", 3.0, 0.5, True)
    assert preproc.parse_args([]).device == "cuda"
    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", capture)
        with pytest.raises(_Parsed):
            preproc.parse_args([])
    assert jax_flags | {"--device", "--cpu", "--gpu_id"} == seen["flags"]
