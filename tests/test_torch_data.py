"""The port's image I/O, SRN reader and numpy helpers against the libraries
and the JAX package modules they replace, on the CPU.

- ``utils/png.py`` against ``imageio.v2.imread`` (exact: shape, dtype and
  values) on files imageio writes and on files built here byte by byte with
  each of the five row filters, in every supported colour type and depth;
- ``data/srn.py`` and ``get_split_dataset("srn")`` against the JAX reader
  (every array of every item exact);
- ``resize_area_np``, ``image_to_tensor``, ``mask_to_tensor`` exact;
  ``psnr``/``ssim`` to 1e-12; ``depth_cmap`` and its table exact against
  cv2; ``write_exr`` byte for byte; ``resize_area_like_cv2`` exact against
  ``cv2.resize(INTER_AREA)`` where it is defined.
"""
import os
import struct
import zlib

import cv2
import imageio.v2 as imageio
import numpy as np
import pytest

from pixelnerf_tpu.data import SRNDataset as JaxSRN
from pixelnerf_tpu.data import base as jax_base
from pixelnerf_tpu.data import get_split_dataset as jax_get_split_dataset
from pixelnerf_tpu.eval.common import depth_cmap as jax_depth_cmap
from pixelnerf_tpu.utils import exr as jax_exr
from pixelnerf_tpu.utils import metrics as jax_metrics
from pixelnerf_tpu_torch.data import SRNDataset, base, get_split_dataset
from pixelnerf_tpu_torch.eval.common import depth_cmap, hot_lut, resize_area_like_cv2
from pixelnerf_tpu_torch.utils import exr, metrics, png

from torch_port_utils import write_srn_fixture

# ---------------------------------------------------------------------------
# PNG: an independent encoder, byte by byte


def _paeth_byte(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _filter_row(kind, row, prev, bpp):
    out = bytearray(len(row))
    for i, x in enumerate(row):
        a = row[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        pred = (0, a, b, (a + b) // 2, _paeth_byte(a, b, c))[kind]
        out[i] = (x - pred) % 256
    return bytes([kind]) + bytes(out)


def _chunk(kind, data):
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF)


ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _png_bytes(samples, depth, ctype, filters, extra=b"", interlace=0):
    """samples: (H, W, C) integers; each row filtered with filters[y]. With
    ``interlace`` the seven Adam7 passes, each filtered as an image of its
    own (an empty pass has no bytes)."""
    h, w, c = samples.shape
    if interlace:
        data = b"".join(_scanline_bytes(samples[y0::dy, x0::dx], depth, filters)
                        for x0, y0, dx, dy in ADAM7 if samples[y0::dy, x0::dx].size)
    else:
        data = _scanline_bytes(samples, depth, filters)
    return (png.SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, interlace))
            + extra + _chunk(b"IDAT", zlib.compress(data)) + _chunk(b"IEND", b""))


def _scanline_bytes(samples, depth, filters):
    h, w, c = samples.shape
    if depth < 8:
        # most significant bits first, each row padded to a whole byte
        per = 8 // depth
        s = samples.reshape(h, w * c).astype(np.uint8)
        s = np.pad(s, ((0, 0), (0, -s.shape[1] % per))).reshape(h, -1, per)
        packed = np.zeros(s.shape[:2], np.uint8)
        for j in range(per):
            packed = (packed << depth) | s[..., j]
        raw, row_bytes = packed.tobytes(), packed.shape[1]
    else:
        raw = samples.astype(">u2" if depth == 16 else np.uint8).tobytes()
        row_bytes = w * c * depth // 8
    bpp = max(1, c * depth // 8)
    prev = bytes(row_bytes)
    data = b""
    for y in range(h):
        row = raw[y * row_bytes : (y + 1) * row_bytes]
        data += _filter_row(int(filters[y % len(filters)]), row, prev, bpp)
        prev = row
    return data


# colour type, bit depth, channels in the file
COLOUR_TYPES = {
    "gray8": (0, 8, 1), "gray_alpha8": (4, 8, 2), "rgb8": (2, 8, 3), "rgba8": (6, 8, 4),
    "gray16": (0, 16, 1), "gray_alpha16": (4, 16, 2), "rgb16": (2, 16, 3), "rgba16": (6, 16, 4),
    "palette": (3, 8, 1), "palette_trns": (3, 8, 1),
    "gray1": (0, 1, 1), "gray2": (0, 2, 1), "gray4": (0, 4, 1),
    "palette1": (3, 1, 1), "palette2": (3, 2, 1), "palette4": (3, 4, 1),
}
FILTERS = {"none": [0], "sub": [1], "up": [2], "average": [3], "paeth": [4], "mixed": [4, 0, 3, 1, 2, 4, 3]}


def _assert_same_read(path):
    ref = imageio.imread(path)
    got = png.imread(path)
    assert got.shape == ref.shape and got.dtype == ref.dtype, (got.shape, got.dtype, ref.shape, ref.dtype)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("filt", list(FILTERS))
def test_png_reader_matches_imageio_on_hand_built_files(tmp_path, filt):
    """Every colour type and depth, each row filter (and a mix), an odd
    width and height: the port reads what imageio reads."""
    rng = np.random.default_rng(len(filt))
    for name, (ctype, depth, ch) in COLOUR_TYPES.items():
        h, w = 13, 11
        top = min(16, 1 << depth) if ctype == 3 else (1 << depth)
        samples = rng.integers(0, top, (h, w, ch))
        # a smooth gradient in half the image so the predictors matter
        samples[: h // 2] = (np.arange(w)[None, :, None] * 7 + np.arange(h // 2)[:, None, None] * 3) % top
        extra = b""
        if ctype == 3:
            extra = _chunk(b"PLTE", rng.integers(0, 256, (top, 3)).astype(np.uint8).tobytes())
            if name == "palette_trns":
                extra += _chunk(b"tRNS", rng.integers(0, 256, 10).astype(np.uint8).tobytes())
        path = str(tmp_path / f"{name}.png")
        with open(path, "wb") as f:
            f.write(_png_bytes(samples, depth, ctype, FILTERS[filt], extra))
        _assert_same_read(path)


@pytest.mark.parametrize("filt", ["none", "paeth", "mixed"])
@pytest.mark.parametrize("shape", [(13, 11), (1, 1), (3, 9), (9, 2)])
def test_png_reader_matches_imageio_on_interlaced_files(tmp_path, filt, shape):
    """Adam7 interlaced files of every colour type and depth, sizes where
    some passes are empty: the port reads what imageio reads, alone and in
    ``imread_many`` beside a file not interlaced."""
    rng = np.random.default_rng(len(filt) + shape[0])
    paths = []
    for name, (ctype, depth, ch) in COLOUR_TYPES.items():
        top = min(16, 1 << depth) if ctype == 3 else (1 << depth)
        samples = rng.integers(0, top, shape + (ch,))
        extra = _chunk(b"PLTE", rng.integers(0, 256, (top, 3)).astype(np.uint8).tobytes()) if ctype == 3 else b""
        for interlace in (1, 0):
            path = str(tmp_path / f"{name}_{interlace}.png")
            with open(path, "wb") as f:
                f.write(_png_bytes(samples, depth, ctype, FILTERS[filt], extra, interlace=interlace))
            paths.append(path)
        _assert_same_read(paths[-2])
    for path, img in zip(paths, png.imread_many(paths)):
        ref = imageio.imread(path)
        assert img.shape == ref.shape and img.dtype == ref.dtype
        np.testing.assert_array_equal(img, ref)


def test_png_read_many_matches_imageio(tmp_path, monkeypatch):
    """One ``imread_many`` over files of two sizes, several colour types and
    filter mixes (some needing the wavefront, some not) reads each file as
    imageio does, also when a group is split for its size."""
    rng = np.random.default_rng(7)
    paths = []
    for i in range(12):
        name = list(COLOUR_TYPES)[i % 4]
        ctype, depth, ch = COLOUR_TYPES[name]
        h, w = (13, 11) if i % 3 else (9, 16)
        samples = rng.integers(0, 1 << depth, (h, w, ch))
        samples[: h // 2] = (np.arange(w)[None, :, None] * 5 + np.arange(h // 2)[:, None, None]) % (1 << depth)
        path = str(tmp_path / f"m{i}.png")
        with open(path, "wb") as f:
            f.write(_png_bytes(samples, depth, ctype, list(FILTERS.values())[i % len(FILTERS)]))
        paths.append(path)
    for group_bytes in (png._GROUP_BYTES, 1):
        monkeypatch.setattr(png, "_GROUP_BYTES", group_bytes)
        got = png.imread_many(paths)
        assert len(got) == len(paths)
        for path, img in zip(paths, got):
            ref = imageio.imread(path)
            assert img.shape == ref.shape and img.dtype == ref.dtype
            np.testing.assert_array_equal(img, ref)


@pytest.mark.parametrize("shape", [(5, 13), (17, 8), (1, 1), (9, 33)])
def test_png_reader_matches_imageio_on_pillow_1_bit_files(tmp_path, shape):
    """Masks saved by Pillow in mode "1" (1-bit gray, rows ending inside a
    byte): bool, as imageio returns them."""
    from PIL import Image

    path = str(tmp_path / "mask.png")
    Image.fromarray(np.random.default_rng(sum(shape)).uniform(size=shape) > 0.5).save(path)
    _assert_same_read(path)
    assert png.imread(path).dtype == np.bool_


@pytest.mark.parametrize("bits", [1, 2, 4])
def test_png_reader_matches_imageio_on_pillow_palette_files(tmp_path, bits):
    """Palette images that Pillow writes with 1, 2 and 4 bits a pixel."""
    from PIL import Image

    rng = np.random.default_rng(bits)
    im = Image.fromarray(rng.integers(0, 1 << bits, (13, 21)).astype(np.uint8), "P")
    im.putpalette(rng.integers(0, 256, 3 << bits).astype(np.uint8).tobytes())
    path = str(tmp_path / "p.png")
    im.save(path, bits=bits)
    assert open(path, "rb").read()[24] == bits           # the IHDR's bit depth
    _assert_same_read(path)


@pytest.mark.parametrize("shape,dtype", [((17, 9), np.uint8), ((17, 9, 2), np.uint8), ((17, 9, 3), np.uint8),
                                         ((17, 9, 4), np.uint8), ((17, 9), np.uint16)])
def test_png_reader_matches_imageio_on_imageio_files(tmp_path, shape, dtype):
    rng = np.random.default_rng(3)
    img = rng.integers(0, np.iinfo(dtype).max + 1, shape).astype(dtype)
    path = str(tmp_path / "img.png")
    imageio.imwrite(path, img)
    _assert_same_read(path)
    np.testing.assert_array_equal(png.imread(path), img)


@pytest.mark.parametrize("channels", [None, 1, 3, 4])
def test_png_writer_roundtrips_through_imageio(tmp_path, channels):
    """The writer's files read back exactly through imageio, with every
    filter type, one per row in turn, and with all rows unfiltered."""
    rng = np.random.default_rng(4)
    shape = (21, 14) if channels is None else (21, 14, channels)
    img = rng.integers(0, 256, shape).astype(np.uint8)
    img[:8] = 200                                       # flat rows
    for filters in (0, np.arange(21) % 5):
        path = str(tmp_path / "w.png")
        png.imwrite(path, img, filters=filters)
        ref = imageio.imread(path)
        expect = img[..., 0] if channels == 1 else img
        assert ref.shape == expect.shape
        np.testing.assert_array_equal(ref, expect)
        np.testing.assert_array_equal(png.imread(path), expect)


def test_png_reader_refuses_what_it_does_not_read(tmp_path):
    """What it once refused it now reads as imageio does (an interlaced file,
    a 4-bit palette); a CRC error and a write of uint16 still raise."""
    samples = np.arange(4 * 4 * 3).reshape(4, 4, 3) * 5
    path = str(tmp_path / "interlaced.png")
    with open(path, "wb") as f:
        f.write(_png_bytes(samples, 8, 2, [0], interlace=1))
    _assert_same_read(path)
    np.testing.assert_array_equal(png.imread(path), samples)
    path = str(tmp_path / "palette4.png")
    with open(path, "wb") as f:
        f.write(_png_bytes(np.arange(16).reshape(4, 4, 1)[::-1], 4, 3, [0, 1, 2, 4],
                           _chunk(b"PLTE", bytes(range(16 * 3)))))
    _assert_same_read(path)
    good = str(tmp_path / "good.png")
    png.imwrite(good, np.zeros((4, 4, 3), np.uint8))
    blob = bytearray(open(good, "rb").read())
    blob[40] ^= 0xFF                                    # inside IDAT
    with open(good, "wb") as f:
        f.write(bytes(blob))
    with pytest.raises(ValueError, match="CRC"):
        png.imread(good)
    with pytest.raises(TypeError):
        png.imwrite(str(tmp_path / "x.png"), np.zeros((4, 4, 3), np.uint16))


# ---------------------------------------------------------------------------
# SRN reader


def _assert_items_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], str):
            assert a[k] == b[k], k
        else:
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
            np.testing.assert_array_equal(np.asarray(b[k]), np.asarray(a[k]), err_msg=k)


SRN_CASES = {
    "native": ("cars", False, dict()),
    "resize_32_to_16": ("cars", False, dict(image_size=(16, 16))),
    "world_scale": ("cars", False, dict(world_scale=0.5)),
    "chairs_nested": ("chairs", True, dict()),
    "z_overrides": ("chairs", False, dict(z_near=0.5, z_far=2.5, cache_cap=2)),
}


@pytest.mark.parametrize("case", list(SRN_CASES))
def test_srn_dataset_matches_jax(tmp_path, case):
    name, nested, kw = SRN_CASES[case]
    kw = {"image_size": (32, 32), **kw}
    path = write_srn_fixture(str(tmp_path), name=name, stages=("train", "test"), nested=nested)
    for stage in ("train", "test"):
        jd, td = JaxSRN(path, stage=stage, **kw), SRNDataset(path, stage=stage, **kw)
        assert len(td) == len(jd) == 2
        assert (td.z_near, td.z_far, td.lindisp, td.base_path) == (jd.z_near, jd.z_far, jd.lindisp, jd.base_path)
        for i in range(len(jd)):
            _assert_items_equal(jd[i], td[i])
        if kw.get("cache_cap"):
            assert td[0] is td[0]
    if case == "chairs_nested":
        train = SRNDataset(path, stage="train")
        assert train.base_path == JaxSRN(path, stage="train").base_path
        assert train.base_path.endswith("chairs_2.0_train") and train.z_near == 1.25


def test_get_split_dataset_srn_matches_jax(tmp_path):
    path = write_srn_fixture(str(tmp_path))
    ours = get_split_dataset("srn", path, training=False, image_size=(32, 32))
    ref = jax_get_split_dataset("srn", path, training=False, image_size=(32, 32))
    assert len(ours) == len(ref) == 3
    for t, j in zip(ours, ref):
        assert t.stage == j.stage and len(t) == len(j)
        _assert_items_equal(j[1], t[1])
    assert get_split_dataset("srn", path, "val", image_size=(32, 32)).stage == "val"
    for factory in (get_split_dataset, jax_get_split_dataset):
        with pytest.raises(NotImplementedError):
            factory("nerf_llff", path, "train")


# ---------------------------------------------------------------------------
# numpy helpers


def test_image_helpers_match_jax():
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (20, 24, 3)).astype(np.uint8)
    np.testing.assert_array_equal(base.image_to_tensor(img), jax_base.image_to_tensor(img))
    for mask in (rng.integers(0, 256, (20, 24)).astype(np.uint8), rng.integers(0, 256, (20, 24, 3)).astype(np.uint8)):
        np.testing.assert_array_equal(base.mask_to_tensor(mask), jax_base.mask_to_tensor(mask))
    x = rng.uniform(-1, 1, (3, 32, 48, 3)).astype(np.float32)
    for size in ((16, 24), (10, 7), (32, 48), (5, 40)):
        ours, ref = base.resize_area_np(x, *size), jax_base.resize_area_np(x, *size)
        assert ours.dtype == ref.dtype
        np.testing.assert_array_equal(ours, ref)


def test_psnr_ssim_match_jax():
    rng = np.random.default_rng(1)
    for shape in ((32, 32, 3), (17, 23, 3), (24, 24)):
        a = rng.uniform(0, 1, shape).astype(np.float32)
        b = np.clip(a + rng.normal(0, 0.1, shape), 0, 1).astype(np.float32)
        assert abs(metrics.psnr(a, b) - jax_metrics.psnr(a, b)) <= 1e-12
        assert abs(metrics.ssim(a, b, data_range=1.0) - jax_metrics.ssim(a, b, data_range=1.0)) <= 1e-12


def test_depth_cmap_matches_jax_and_cv2():
    levels = np.arange(256, dtype=np.uint8)[:, None]
    np.testing.assert_array_equal(hot_lut(), cv2.applyColorMap(levels, cv2.COLORMAP_HOT)[:, 0, ::-1])
    # every level through the normalisation, then real depth maps
    ramp = np.linspace(0.8, 1.8, 256 * 4, dtype=np.float32).reshape(32, 32)
    np.testing.assert_array_equal(depth_cmap(ramp, 0.8, 1.8), jax_depth_cmap(ramp, 0.8, 1.8))
    rng = np.random.default_rng(2)
    depth = rng.uniform(0.5, 2.0, (40, 30)).astype(np.float32)
    for near, far in ((0.8, 1.8), (None, None), (1.0, 1.0)):
        out = depth_cmap(depth, near, far)
        assert out.dtype == np.float32 and out.shape == (40, 30, 3)
        np.testing.assert_array_equal(out, jax_depth_cmap(depth, near, far))


def test_write_exr_bytes_match_jax(tmp_path):
    rng = np.random.default_rng(3)
    for shape in ((12, 9), (12, 9, 3)):
        for half in (False, True):
            img = rng.normal(size=shape).astype(np.float32)
            exr.write_exr(str(tmp_path / "a.exr"), img, half=half)
            jax_exr.write_exr(str(tmp_path / "b.exr"), img, half=half)
            assert (tmp_path / "a.exr").read_bytes() == (tmp_path / "b.exr").read_bytes()
            np.testing.assert_array_equal(exr.read_exr(str(tmp_path / "a.exr")), jax_exr.read_exr(str(tmp_path / "b.exr")))


def test_resize_area_like_cv2_matches_cv2_and_refuses_the_rest():
    """Exact against ``cv2.resize(INTER_AREA)`` at every downscale: factors
    1, 2 and 4 per axis (what ``--scale 0.5`` and ``0.25`` give), integer
    factors of 3 and 8, ratios that are no integer (``--scale 0.75``); and
    at the upscales and mixed resizes that once raised (``--scale 2``, a
    row grown and a column shrunk). An empty size is refused."""
    rng = np.random.default_rng(4)
    for (h, w), (oh, ow) in (((64, 64), (32, 32)), ((128, 128), (32, 32)), ((64, 128), (32, 32)),
                             ((128, 128), (128, 64)), ((40, 40), (40, 40)), ((64, 64), (48, 48)),
                             ((64, 64), (43, 43)), ((64, 64), (8, 8)), ((64, 64), (21, 32)), ((96, 96), (32, 32)),
                             ((64, 64), (128, 128)), ((64, 64), (32, 128)), ((64, 64), (65, 64))):
        for ch in (3, 1):
            x = rng.uniform(0, 1, (h, w, ch)).astype(np.float32)
            ref = cv2.resize(x, (ow, oh), interpolation=cv2.INTER_AREA).reshape(oh, ow, ch)
            np.testing.assert_array_equal(resize_area_like_cv2(x, oh, ow), ref)
    for size in ((0, 64), (64, 0)):
        with pytest.raises(ValueError):
            resize_area_like_cv2(np.zeros((64, 64, 3), np.float32), *size)


def test_data_modules_read_no_imaging_library():
    """The port's reader decodes with its own PNG reader: the SRN module
    names no imaging library."""
    import pixelnerf_tpu_torch.data.srn as srn

    src = open(srn.__file__).read()
    assert "imageio" not in src and "PIL" not in src and "cv2" not in src
    assert os.path.basename(png.__file__) == "png.py"
