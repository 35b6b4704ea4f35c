"""Full-frame chunked rendering and the depth colormap (counterpart of
``pixelnerf_tpu/eval/common.py`` ``FullRenderer``, ``depth_cmap``).

The eval and serving paths render NV*H*W rays per object in fixed-size
chunks; here each chunk is one ``render_rays`` call in a Python loop
(PyTorch runs eagerly, so no chunk is padded).
"""
from __future__ import annotations

import functools
from typing import Dict, List, Optional

import numpy as np
import torch

from ..render.renderer import RenderConfig, render_rays_chunked
from ..utils.nans import raise_if_not_finite


class FullRenderer:
    """Render an arbitrary number of rays, chunk by chunk.

    :param net: a port ``PixelNeRFNet``
    :param fast: let the field MLPs take the fused kernel (bf16, single view)
    :param staged: render through the staged pair (the fine pass reuses the
        coarse samples' features) instead of ``net.query``. A baked encoding
        (``bake_encoding``) of a model with a separate fine MLP is rendered
        unstaged whatever this says: its maps are per MLP, and the staged
        pair would feed the fine MLP the coarse MLP's injections
    :param use_kernels: route the gather and the fused MLP through their
        CUDA kernels (True) or their plain PyTorch versions (False), for
        comparing the two on the card
    :param debug_nans: raise ``FloatingPointError`` at a render output that
        holds a NaN or an infinity (the apps' ``--debug_nans``)
    """

    def __init__(
        self,
        net,
        cfg: RenderConfig,
        ray_chunk: int = 50000,
        want_weights: bool = False,
        fast: bool = False,
        use_kernels: bool = True,
        staged: bool = True,
        debug_nans: bool = False,
    ):
        self.net = net
        self.cfg = cfg
        self.ray_chunk = int(ray_chunk)
        self.want_weights = want_weights
        self.fast = fast
        self.use_kernels = use_kernels
        self.staged = staged
        self.debug_nans = debug_nans

    @torch.inference_mode()
    def render_batch(
        self,
        enc,
        rays: torch.Tensor,
        generator: Optional[torch.Generator] = None,
        noise: Optional[List[Dict[str, torch.Tensor]]] = None,
    ) -> Dict[str, Dict[str, torch.Tensor]]:
        """Batched-object render: rays (SB, NR, 8) against an SB-object
        encoding -> dict of tensors with leading (SB, NR) dims.

        :param noise: one pre-drawn noise dict per ray chunk (see
            ``render/renderer.py``), or None to draw from ``generator``
        """
        net = self.net

        def features_fn(xyz, viewdirs):
            return net.query_features(enc, xyz, viewdirs, use_kernels=self.use_kernels)

        def mlp_fn(feats, coarse):
            return net.query_mlp(
                enc, feats, coarse=coarse, fast=self.fast, use_kernels=self.use_kernels
            )

        def query_fn(xyz, viewdirs, coarse):
            return net.query(
                enc, xyz, viewdirs, coarse=coarse, fast=self.fast, use_kernels=self.use_kernels
            )

        baked_per_mlp = enc.tz_coarse is not None and net.mlp_fine is not None
        q = (features_fn, mlp_fn) if (self.staged and not baked_per_mlp) else query_fn
        out = render_rays_chunked(
            q, rays, self.cfg, self.ray_chunk, generator, noise, self.want_weights, net.use_viewdirs,
        )
        if self.debug_nans:
            raise_if_not_finite("the render output", out)
        return out

    def __call__(self, enc, rays: torch.Tensor, generator=None, noise=None) -> dict:
        """:param rays: (NR, 8) -> {'coarse': {'rgb': (NR, 3), ...}, ...}"""
        out = self.render_batch(enc, rays[None], generator, noise)
        return {b: {k: v[0] for k, v in d.items()} for b, d in out.items()}

    def render_image(self, enc, rays_hw: torch.Tensor, generator=None, noise=None,
                     fine: Optional[bool] = None):
        """:param rays_hw: (H, W, 8) -> (rgb (H, W, 3), depth (H, W))"""
        H, W, _ = rays_hw.shape
        out = self(enc, rays_hw.reshape(-1, 8), generator, noise)
        use_fine = fine if fine is not None else self.cfg.using_fine
        branch = out["fine"] if use_fine else out["coarse"]
        return branch["rgb"].reshape(H, W, 3), branch["depth"].reshape(H, W)


@functools.lru_cache(maxsize=1)
def hot_lut() -> np.ndarray:
    """OpenCV's ``COLORMAP_HOT`` as a (256, 3) uint8 RGB table, built as
    OpenCV builds it: the 64 samples of r = 2.5x, g = 2.5x - 1,
    b = 5x - 4 (each clipped to [0, 1]) at x = i/63, linearly interpolated
    in float32 at the 256 levels l/255, scaled by 255 and rounded half to
    even."""
    f32 = np.float32
    i = np.arange(64, dtype=np.float64)
    samples = [np.clip(i * 2.5 / 63, 0, 1), np.clip(i * 2.5 / 63 - 1, 0, 1), np.clip(i * 5 / 63 - 4, 0, 1)]
    x = np.arange(64, dtype=f32) * (f32(1) / f32(63))
    xi = np.arange(256, dtype=f32) * (f32(1) / f32(255))
    lo = np.searchsorted(x[1:63], xi, side="left")   # the last sample below each level
    cols = []
    for y in samples:
        y = y.astype(f32)
        v = y[lo] + (xi - x[lo]) * (y[lo + 1] - y[lo]) / (x[lo + 1] - x[lo])
        cols.append(np.rint(v * f32(255)))
    lut = np.clip(np.stack(cols, axis=-1), 0, 255).astype(np.uint8)
    lut.flags.writeable = False          # shared by every caller
    return lut


def depth_cmap(depth: np.ndarray, z_near: float = None, z_far: float = None):
    """Colormapped depth visualization (HOT), float [0,1] rgb."""
    d = np.asarray(depth, np.float32)
    vmin = d.min() if z_near is None else z_near
    vmax = d.max() if z_far is None else z_far
    norm = np.clip((d - vmin) / max(vmax - vmin, 1e-10), 0.0, 1.0)
    return hot_lut()[(norm * 255).astype(np.uint8)].astype(np.float32) / 255.0



def resize_area_like_cv2(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Area downscale of an (H, W, C) float32 image by a factor of 1, 2 or
    4 per axis, bit for bit as OpenCV's ``cv2.resize(img, (out_w, out_h),
    interpolation=cv2.INTER_AREA)``: each output pixel is the mean of its
    fy x fx block, summed in float32 in OpenCV's order (a 2x2 block of a
    3-channel image sample by sample along its rows, every other block row
    by row, then the row sums) and scaled by the exact ``1 / (fy * fx)``.
    Other sizes (factors of 8 and more, odd or fractional ratios, upscales)
    raise ``NotImplementedError``: OpenCV's float32 sums or weights there
    are not reproduced."""
    img = np.asarray(img, np.float32)
    h, w = img.shape[:2]
    if (h, w) == (out_h, out_w):
        return img.copy()
    fy, fx = (h // out_h, w // out_w) if 0 < out_h <= h and 0 < out_w <= w else (0, 0)
    if not (fy in (1, 2, 4) and fx in (1, 2, 4) and fy * out_h == h and fx * out_w == w):
        raise NotImplementedError(
            f"area resize {h}x{w} -> {out_h}x{out_w} is not a downscale by 1, 2 or 4 per axis; "
            "OpenCV's INTER_AREA is reproduced for those only"
        )
    blocks = img.reshape(out_h, fy, out_w, fx, *img.shape[2:])
    zero = np.zeros((out_h, out_w) + img.shape[2:], np.float32)
    if (fy, fx) == (2, 2) and img.ndim == 3 and img.shape[2] == 3:
        acc = zero
        for dy in range(2):
            for dx in range(2):
                acc = acc + blocks[:, dy, :, dx]
    else:
        acc = zero
        for dy in range(fy):
            row = zero
            for dx in range(fx):
                row = row + blocks[:, dy, :, dx]
            acc = acc + row
    return acc * np.float32(1.0 / (fy * fx))
