"""Shared-per-object colour jitter for DTU training (the port's own copy
of ``pixelnerf_tpu/data/color_jitter.py``, numpy only, so a seed gives the
same draws and values in both packages).

One random hue/saturation/brightness/contrast draw (in that order, from
``default_rng(seed)``, once per item) is applied to *all* views of an
object (reference src/data/data_util.py:33-46), so multi-view consistency
is preserved; torchvision's functional_tensor formulas (gray = 0.2989 R +
0.587 G + 0.114 B, blends clamped to [0, 1], hue via HSV rotation).
"""
from __future__ import annotations

import numpy as np

from .base import DatasetBase


def _gray(img):
    return (
        0.2989 * img[..., 0:1] + 0.587 * img[..., 1:2] + 0.114 * img[..., 2:3]
    )


def _blend(img1, img2, factor):
    return np.clip(factor * img1 + (1.0 - factor) * img2, 0.0, 1.0)


def _adjust_saturation(img, factor):
    return _blend(img, np.broadcast_to(_gray(img), img.shape), factor)


def _adjust_contrast(img, factor):
    mean = _gray(img).mean(axis=(-3, -2, -1), keepdims=True)
    return _blend(img, np.broadcast_to(mean, img.shape), factor)


def _adjust_brightness(img, factor):
    return np.clip(img * factor, 0.0, 1.0)


def _rgb_to_hsv(img):
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    maxc = img.max(-1)
    minc = img.min(-1)
    v = maxc
    deltac = maxc - minc
    s = np.where(maxc > 0, deltac / np.maximum(maxc, 1e-12), 0.0)
    dz = np.maximum(deltac, 1e-12)
    rc = (maxc - r) / dz
    gc = (maxc - g) / dz
    bc = (maxc - b) / dz
    h = np.where(
        maxc == r, bc - gc, np.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc)
    )
    h = (h / 6.0) % 1.0
    h = np.where(deltac == 0, 0.0, h)
    return np.stack([h, s, v], axis=-1)


def _hsv_to_rgb(hsv):
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    i = np.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - f * s)
    t = v * (1.0 - (1.0 - f) * s)
    i = i.astype(np.int32) % 6
    out = np.choose(
        i[..., None],
        [
            np.stack([v, t, p], -1), np.stack([q, v, p], -1),
            np.stack([p, v, t], -1), np.stack([p, q, v], -1),
            np.stack([t, p, v], -1), np.stack([v, p, q], -1),
        ],
        mode="clip",
    )
    return out


def _adjust_hue(img, factor):
    hsv = _rgb_to_hsv(np.clip(img, 0.0, 1.0))
    hsv[..., 0] = (hsv[..., 0] + factor) % 1.0
    return _hsv_to_rgb(hsv)


class ColorJitterDataset(DatasetBase):
    def __init__(
        self,
        base_dset,
        hue_range=0.1,
        saturation_range=0.1,
        brightness_range=0.1,
        contrast_range=0.1,
        extra_inherit_attrs=(),
        seed=0,
    ):
        self.base_dset = base_dset
        self.hue_range = (-hue_range, hue_range)
        self.saturation_range = (1 - saturation_range, 1 + saturation_range)
        self.brightness_range = (1 - brightness_range, 1 + brightness_range)
        self.contrast_range = (1 - contrast_range, 1 + contrast_range)
        self._rng = np.random.default_rng(seed)
        for attr in ("z_near", "z_far", "lindisp", "base_path") + tuple(
            extra_inherit_attrs
        ):
            if hasattr(base_dset, attr):
                setattr(self, attr, getattr(base_dset, attr))

    def __len__(self):
        return len(self.base_dset)

    def apply_color_jitter(self, images):
        """images (NV, H, W, 3) in [-1, 1]; same jitter across all views."""
        hue = self._rng.uniform(*self.hue_range)
        sat = self._rng.uniform(*self.saturation_range)
        bright = self._rng.uniform(*self.brightness_range)
        contrast = self._rng.uniform(*self.contrast_range)
        x = (images + 1.0) * 0.5
        x = _adjust_saturation(x, sat)
        x = _adjust_hue(x, hue)
        x = _adjust_contrast(x, contrast)
        x = _adjust_brightness(x, bright)
        return (x * 2.0 - 1.0).astype(np.float32)

    def __getitem__(self, idx):
        data = dict(self.base_dset[idx])
        if data:
            data["images"] = self.apply_color_jitter(data["images"])
        return data
