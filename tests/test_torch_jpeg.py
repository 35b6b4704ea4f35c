"""The port's JPEG reader (``pixelnerf_tpu_torch/utils/jpeg.py``) and the
readers and apps that take JPEG files, against ``imageio.v2.imread``
(Pillow on libjpeg-turbo) and the JAX package, on the CPU.

Files are written here by Pillow (and one by OpenCV); the committed
fixtures of ``tests/fixtures/jpeg/`` (``scripts/make_jpeg_fixtures.py``)
are held to imageio's decode, and so are their expected decodes, which
``chip_smoke.py`` holds the reader to on a host without an imaging library.
"""
import glob
import os
import re
import shutil

import cv2
import imageio.v2 as imageio
import numpy as np
import pytest
from PIL import Image

from pixelnerf_tpu.apps import calc_metrics as jax_calc_metrics
from pixelnerf_tpu.data import SRNDataset as JaxSRN
from pixelnerf_tpu.data.dvr import DVRDataset as JaxDVR
from pixelnerf_tpu_torch.apps import calc_metrics
from pixelnerf_tpu_torch.apps.eval_real import read_input
from pixelnerf_tpu_torch.data import DVRDataset, SRNDataset, get_split_dataset
from pixelnerf_tpu_torch.utils import image_io, jpeg, png

from torch_port_utils import REPO, write_srn_fixture

FIXTURES = os.path.join(REPO, "tests", "fixtures", "jpeg")


def _texture(seed, h, w, channels=3):
    """Sinusoids and noise, so that every frequency band carries bits."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w].astype(np.float64)
    img = np.stack([128 + 90 * np.sin(xx / (2.5 + k) + yy / (4 + k)) for k in range(channels)], -1)
    img = np.clip(img + rng.normal(0, 18, img.shape), 0, 255).astype(np.uint8)
    return img[..., 0] if channels == 1 else img


def _assert_reads_as_imageio(path):
    ref = imageio.imread(path)
    got = jpeg.imread(path)
    assert got.shape == ref.shape and got.dtype == ref.dtype, (path, got.shape, ref.shape)
    np.testing.assert_array_equal(got, ref, err_msg=path)


@pytest.mark.parametrize("quality", [1, 50, 90, 100])
@pytest.mark.parametrize("subsampling", [0, 1, 2])
def test_jpeg_matches_imageio_across_sampling_quality_and_coding(tmp_path, subsampling, quality):
    """Baseline, restart markers, optimised tables and progressive coding
    at each sampling and quality: bit-equal to imageio."""
    img = _texture(subsampling * 7 + quality, 45, 53)
    kinds = {"baseline": {}, "restart": {"restart_marker_blocks": 2}, "optimize": {"optimize": True},
             "progressive": {"progressive": True}}
    for name, opts in kinds.items():
        path = str(tmp_path / f"{name}.jpg")
        Image.fromarray(img).save(path, quality=quality, subsampling=subsampling, **opts)
        _assert_reads_as_imageio(path)


@pytest.mark.parametrize("kind", ["gray", "gray_progressive", "adobe_rgb", "opencv", "photo_420x420"])
def test_jpeg_matches_imageio_on_other_kinds(tmp_path, kind):
    path = str(tmp_path / f"{kind}.jpg")
    if kind == "gray":
        Image.fromarray(_texture(1, 29, 37, 1)).save(path, quality=85)
    elif kind == "gray_progressive":
        Image.fromarray(_texture(2, 29, 37, 1)).save(path, quality=85, progressive=True)
    elif kind == "adobe_rgb":
        # no colour transform (Adobe marker, transform 0): read as RGB
        Image.fromarray(_texture(3, 29, 37)).save(path, quality=90, subsampling=0, keep_rgb=True)
        assert b"Adobe" in open(path, "rb").read()
    elif kind == "opencv":
        cv2.imwrite(path, _texture(4, 40, 33), [cv2.IMWRITE_JPEG_QUALITY, 80])
    else:
        photo = imageio.imread(os.path.join(REPO, "raw", "photo1.png"))[..., :3]
        Image.fromarray(photo).save(path, quality=90)
    got = jpeg.imread(path)
    _assert_reads_as_imageio(path)
    assert got.ndim == (2 if kind.startswith("gray") else 3)


@pytest.mark.parametrize("subsampling", [1, 2])
def test_jpeg_matches_imageio_at_every_small_size(tmp_path, subsampling):
    """Every size 1..11 x 1..11: where the chroma is at most 2 samples
    wide, libjpeg replicates (box) instead of interpolating."""
    for h in range(1, 12):
        for w in range(1, 12):
            path = str(tmp_path / f"{h}x{w}.jpg")
            Image.fromarray(_texture(h * 12 + w, h, w)).save(path, quality=90, subsampling=subsampling)
            _assert_reads_as_imageio(path)


def test_jpeg_ignores_exif_orientation(tmp_path):
    """imageio applies no EXIF orientation, and neither does the port."""
    im = Image.fromarray(_texture(5, 53, 37))
    exif = im.getexif()
    exif[0x0112] = 6                                      # rotate 90 degrees to view
    path = str(tmp_path / "exif.jpg")
    im.save(path, exif=exif.tobytes())
    assert jpeg.imread(path).shape == (53, 37, 3)
    _assert_reads_as_imageio(path)


def _markers(buf):
    """(marker, position of its 0xFF) of the segments before the first scan
    and of every SOS, in order."""
    out, pos = [], 2
    while pos < len(buf):
        m = buf[pos + 1]
        out.append((m, pos))
        if m == 0xDA:
            pos = buf.find(b"\xff\xda", pos + 2)
            if pos < 0:
                break
            continue
        pos += 2 + int.from_bytes(buf[pos + 2 : pos + 4], "big")
    return out


def _edit(buf, marker, offset, value):
    """``buf`` with the byte at ``offset`` into the first ``marker`` segment
    (counted from its 0xFF) set to ``value``."""
    pos = dict(reversed(_markers(buf)))[marker]
    return buf[: pos + offset] + bytes([value]) + buf[pos + offset + 1 :]


def _refusals(tmp_path):
    """name -> (file bytes, exception, message pattern)."""
    base = str(tmp_path / "base.jpg")
    Image.fromarray(_texture(6, 24, 32)).save(base, quality=80, subsampling=0)
    b = open(base, "rb").read()
    prog = str(tmp_path / "prog.jpg")
    Image.fromarray(_texture(7, 24, 32)).save(prog, quality=80, progressive=True)
    p = open(prog, "rb").read()
    gray = str(tmp_path / "gray.jpg")
    Image.fromarray(_texture(8, 24, 32, 1)).save(gray, quality=80)
    cmyk = str(tmp_path / "cmyk.jpg")
    Image.fromarray(_texture(9, 24, 32)).convert("CMYK").save(cmyk, quality=80)
    sof = dict(_markers(b))[0xC0]
    # two components: the third component's three bytes dropped
    two = bytearray(b[: sof + 16] + b[sof + 19 :])
    two[sof + 2 : sof + 4] = (6 + 6 + 2).to_bytes(2, "big")
    two[sof + 9] = 2
    sos = [pos for m, pos in _markers(p) if m == 0xDA]
    dht = [(pos, 2 + int.from_bytes(b[pos + 2 : pos + 4], "big")) for m, pos in _markers(b) if m == 0xC4]
    no_dht = b
    for pos, length in reversed(dht):
        no_dht = no_dht[:pos] + no_dht[pos + length :]
    first_scan = dict(_markers(b))[0xDA]
    data_at = first_scan + 2 + int.from_bytes(b[first_scan + 2 : first_scan + 4], "big")
    return {
        "arithmetic": (_edit(b, 0xC0, 1, 0xC9), NotImplementedError, "arithmetic"),
        "arithmetic_progressive": (_edit(p, 0xC2, 1, 0xCA), NotImplementedError, "arithmetic"),
        "lossless": (_edit(b, 0xC0, 1, 0xC3), NotImplementedError, "lossless"),
        "hierarchical": (_edit(b, 0xC0, 1, 0xC5), NotImplementedError, "hierarchical"),
        "12_bit": (_edit(b, 0xC0, 4, 12), NotImplementedError, "12-bit precision"),
        "two_components": (bytes(two), NotImplementedError, "2 components"),
        "cmyk": (open(cmyk, "rb").read(), NotImplementedError, "4 components"),
        "dnl_height": (_edit(_edit(b, 0xC0, 5, 0), 0xC0, 6, 0), NotImplementedError, "DNL"),
        "h1v2_layout": (_edit(b, 0xC0, 11, 0x12), NotImplementedError, "sampling layout"),
        "h4v1_layout": (_edit(b, 0xC0, 11, 0x41), NotImplementedError, "sampling layout"),
        "no_huffman_tables": (no_dht, NotImplementedError, "Huffman table"),
        "progressive_cut_short": (p[: sos[3]] + b"\xff\xd9", NotImplementedError, "incomplete"),
        "truncated_half": (b[: len(b) // 2], ValueError, "truncated"),
        "truncated_no_eoi": (b[:-2], ValueError, "truncated"),
        "truncated_progressive": (p[: len(p) * 2 // 3], ValueError, "truncated"),
        "not_huffman_codes": (b[:data_at] + b"\xff\x00" * 64 + b"\xff\xd9", ValueError, "no Huffman code"),
        "scan_ends_early": (b[:data_at] + b[data_at : data_at + 8].replace(b"\xff", b"\x00") + b"\xff\xd9",
                            ValueError, "truncated or corrupt"),
        "gray_truncated": (open(gray, "rb").read()[:-40], ValueError, "truncated"),
        "not_a_jpeg": (b"\x89PNG" + b[4:], ValueError, "not a JPEG"),
    }


REFUSALS = ["arithmetic", "arithmetic_progressive", "lossless", "hierarchical", "12_bit", "two_components", "cmyk",
            "dnl_height", "h1v2_layout", "h4v1_layout", "no_huffman_tables", "progressive_cut_short",
            "truncated_half", "truncated_no_eoi", "truncated_progressive", "not_huffman_codes", "scan_ends_early",
            "gray_truncated", "not_a_jpeg"]


@pytest.mark.parametrize("name", REFUSALS)
def test_jpeg_refuses_with_the_file_named(tmp_path, name):
    data, exc, pattern = _refusals(tmp_path)[name]
    path = str(tmp_path / f"refused_{name}.jpg")
    with open(path, "wb") as f:
        f.write(data)
    with pytest.raises(exc, match=f"refused_{name}.jpg: .*{pattern}"):
        jpeg.imread(path)
    if name.startswith("truncated"):
        with pytest.raises(OSError):                      # Pillow raises on these too
            imageio.imread(path)


def test_refusal_cases_cover_the_table(tmp_path):
    assert sorted(_refusals(tmp_path)) == sorted(REFUSALS)


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(FIXTURES, "*.jpg"))), ids=os.path.basename)
def test_committed_fixtures_equal_imageio_and_their_expected_decodes(path):
    expected = np.load(os.path.join(FIXTURES, "expected.npz"))
    name = os.path.splitext(os.path.basename(path))[0]
    ref = imageio.imread(path)
    assert expected[name].dtype == ref.dtype and expected[name].shape == ref.shape
    np.testing.assert_array_equal(expected[name], ref)
    _assert_reads_as_imageio(path)


def test_committed_fixtures_cover_every_listed_kind():
    names = {os.path.splitext(f)[0] for f in os.listdir(FIXTURES) if f.endswith(".jpg")}
    assert names == set(np.load(os.path.join(FIXTURES, "expected.npz")).files)
    assert {"s444", "s422", "s420", "gray", "restart", "optimize", "adobe_rgb", "progressive", "odd_3x5",
            "photo1", "texture_400x300"} <= names
    assert sum(os.path.getsize(os.path.join(FIXTURES, f)) for f in os.listdir(FIXTURES)) < 1 << 20


def test_image_io_dispatches_on_the_signature(tmp_path):
    """A PNG named .jpg is read as a PNG and a JPEG named .png as a JPEG, as
    Pillow reads them; anything else raises; ``imread_many`` keeps order."""
    img = _texture(10, 12, 14)
    as_jpg = str(tmp_path / "png_inside.jpg")
    png.imwrite(as_jpg, img)
    as_png = str(tmp_path / "jpeg_inside.png")
    Image.fromarray(img).save(as_png, format="JPEG", quality=90)
    np.testing.assert_array_equal(image_io.imread(as_jpg), img)
    np.testing.assert_array_equal(image_io.imread(as_png), imageio.imread(as_png))
    other = str(tmp_path / "text.png")
    with open(other, "w") as f:
        f.write("not an image")
    with pytest.raises(ValueError, match="text.png: neither a PNG nor a JPEG"):
        image_io.imread(other)
    paths = [as_png, as_jpg, as_png, as_jpg]
    for got, p in zip(image_io.imread_many(paths), paths):
        np.testing.assert_array_equal(got, imageio.imread(p))


def _jpeg_nmr_object(root, rng, mask_png=True):
    """An NMR-layout category of one object whose views are the committed
    ``nmr_*.jpg`` fixtures, with 8-bit PNG masks and ``world_mat`` cameras."""
    obj = os.path.join(root, "02958343", "obj0")
    os.makedirs(os.path.join(obj, "image"))
    os.makedirs(os.path.join(obj, "mask"))
    cams = {}
    views = sorted(glob.glob(os.path.join(FIXTURES, "nmr_*.jpg")))
    world = np.array([[1, 0, 0, 0], [0, 0, -1, 0], [0, 1, 0, 0], [0, 0, 0, 1]], np.float64)
    cam = np.diag([1.0, -1.0, -1.0, 1.0])
    for v, src in enumerate(views):
        shutil.copy(src, os.path.join(obj, "image", f"{v:04d}.jpg"))
        m = np.zeros((64, 64), np.uint8)
        m[10 + v : 40 + v, 12 : 50 - v] = 255
        png.imwrite(os.path.join(obj, "mask", f"{v:04d}.png"), m)
        ang = 2 * np.pi * v / len(views)
        c2w = np.eye(4)
        c2w[:3, 3] = [2.0 * np.cos(ang), 0.8, 2.0 * np.sin(ang)]
        cams[f"world_mat_{v}"] = np.linalg.inv(np.linalg.inv(world) @ c2w @ np.linalg.inv(cam)).astype(np.float32)
        cams[f"camera_mat_{v}"] = np.diag([1.75, 1.75, 1.0, 1.0]).astype(np.float32)
    np.savez(os.path.join(obj, "cameras.npz"), **cams)
    with open(os.path.join(root, "02958343", "softras_train.lst"), "w") as f:
        f.write("obj0\n")
    return root


@pytest.fixture(scope="module")
def jpeg_nmr(tmp_path_factory):
    root = _jpeg_nmr_object(str(tmp_path_factory.mktemp("jpeg_nmr")), np.random.default_rng(0))
    return root, JaxDVR(root, stage="train")[0]                  # the JAX item, once per module


def test_dvr_item_on_jpeg_views_matches_jax(jpeg_nmr):
    root, ref = jpeg_nmr
    got = DVRDataset(root, stage="train")[0]
    assert set(got) == set(ref) and got["images"].shape == (6, 64, 64, 3)
    for k in ref:
        if isinstance(ref[k], str):
            assert got[k] == ref[k]
        else:
            assert np.asarray(got[k]).dtype == np.asarray(ref[k]).dtype, k
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(ref[k]), err_msg=k)
    # through the -F dvr entry, and at a resized image_size
    item = get_split_dataset("dvr", root, "train")[0]
    np.testing.assert_array_equal(item["images"], ref["images"])
    small = DVRDataset(root, stage="train", image_size=(32, 32))[0]
    np.testing.assert_array_equal(small["images"], JaxDVR(root, stage="train", image_size=(32, 32))[0]["images"])


def test_srn_item_on_jpeg_views_matches_jax(tmp_path):
    """The SRN reader reads whatever ``rgb/`` holds, as the JAX reader does:
    views stored as JPEG give the JAX item."""
    path = write_srn_fixture(str(tmp_path), stages=("train",))
    for f in glob.glob(os.path.join(path + "_train", "*", "rgb", "*.png")):
        Image.open(f).convert("RGB").save(f[:-4] + ".jpg", quality=90)
        os.remove(f)
    ref, got = JaxSRN(path, stage="train")[1], SRNDataset(path, stage="train")[1]
    assert set(got) == set(ref)
    for k in ref:
        if not isinstance(ref[k], str):
            assert np.asarray(got[k]).dtype == np.asarray(ref[k]).dtype, k
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(ref[k]), err_msg=k)


@pytest.mark.parametrize("size", [32, 128])
def test_eval_real_read_input_on_jpeg_matches_the_jax_app(size):
    """The JAX app reads an input with imageio and resizes it with OpenCV's
    INTER_AREA; the port's ``read_input`` gives the same array."""
    path = os.path.join(FIXTURES, "photo1.jpg")
    img = imageio.imread(path)[..., :3]
    ref = (cv2.resize(img, (size, size), interpolation=cv2.INTER_AREA).astype(np.float32) / 255.0 - 0.5) / 0.5
    got = read_input(path, size)
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)


def test_calc_metrics_on_jpeg_ground_truth_matches_the_jax_app(tmp_path):
    """Ground-truth views stored as JPEG (``.jpg``): the port's app gives
    the JAX app's PSNR and SSIM and its report."""
    rng = np.random.default_rng(3)
    data, out = tmp_path / "data", tmp_path / "renders"
    for obj in ("objA", "objB"):
        (data / "02958343" / obj / "image").mkdir(parents=True)
        (out / obj).mkdir(parents=True)
        for v in range(3):
            gt = _texture(v + (obj == "objB") * 5, 20, 24)
            Image.fromarray(gt).save(str(data / "02958343" / obj / "image" / f"{v:04}.jpg"), quality=85,
                                     subsampling=v % 3)
            pred = np.clip(gt + rng.normal(0, 8 * (v + 1), gt.shape), 0, 255).astype(np.uint8)
            png.imwrite(str(out / obj / f"{v:06}.png"), pred)
    (data / "02958343" / "softras_test.lst").write_text("objA\nobjB\n")
    jax_out = tmp_path / "jax_renders"
    shutil.copytree(out, jax_out)
    flags = ["-D", str(data / "02958343"), "-F", "dvr"]
    calc_metrics.main(flags + ["-O", str(out), "--device", "cpu"])
    jax_calc_metrics.main(flags + ["-O", str(jax_out)])
    for obj in ("objA", "objB"):
        ours = [l.split() for l in open(out / obj / "metrics.txt").read().splitlines()]
        ref = [l.split() for l in open(jax_out / obj / "metrics.txt").read().splitlines()]
        assert [r[0] for r in ours] == [r[0] for r in ref] == ["psnr", "ssim"]
        np.testing.assert_allclose([float(r[1]) for r in ours], [float(r[1]) for r in ref], rtol=1e-6, err_msg=obj)
    ours, ref = open(out / "all_metrics.txt").read(), open(jax_out / "all_metrics.txt").read()
    number = re.compile(r"-?\d+\.\d+")
    assert number.sub("x", ours) == number.sub("x", ref)
    np.testing.assert_allclose([float(x) for x in number.findall(ours)], [float(x) for x in number.findall(ref)],
                               rtol=1e-6)
