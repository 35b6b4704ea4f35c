"""Full-frame chunked rendering and the depth colormap (counterpart of
``pixelnerf_tpu/eval/common.py`` ``FullRenderer``, ``depth_cmap``).

The eval and serving paths render NV*H*W rays per object in fixed-size
chunks; here each chunk is one ``render_rays`` call in a Python loop
(PyTorch runs eagerly, so no chunk is padded, but on a mesh to a multiple
of its ranks).
"""
from __future__ import annotations

import functools
from typing import Dict, List, Optional

import numpy as np
import torch

from ..render.renderer import RenderConfig, render_rays_chunked
from ..utils.imgproc import resize_area
from ..utils.nans import raise_if_not_finite
from ..utils.profiling import span


def field(net, enc, fast: bool = False, use_kernels: bool = True, staged: bool = True):
    """The renderer's field for ``net`` on ``enc``: the staged pair
    ``(features_fn, mlp_fn)`` (the fine pass reuses the coarse samples'
    features), or ``net.query`` unstaged when ``staged`` is False or the
    encoding is baked per MLP (``bake_encoding`` of a model with a separate
    fine MLP, whose staged pair would feed the fine MLP the coarse MLP's
    injections)."""

    def features_fn(xyz, viewdirs):
        return net.query_features(enc, xyz, viewdirs, use_kernels=use_kernels)

    def mlp_fn(feats, coarse):
        return net.query_mlp(enc, feats, coarse=coarse, fast=fast, use_kernels=use_kernels)

    def query_fn(xyz, viewdirs, coarse):
        return net.query(enc, xyz, viewdirs, coarse=coarse, fast=fast, use_kernels=use_kernels)

    baked_per_mlp = enc.tz_coarse is not None and net.mlp_fine is not None
    return (features_fn, mlp_fn) if (staged and not baked_per_mlp) else query_fn


class FullRenderer:
    """Render an arbitrary number of rays, chunk by chunk.

    :param net: a port ``PixelNeRFNet``
    :param fast: let the field MLPs take the fused kernel (bf16; one view,
        or views averaged at the combine layer: its multi-view mode)
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
    :param mesh: a ``parallel.Mesh``: every rank renders its slice of each
        chunk's rays (one render per chunk, no microbatches), and every
        rank gets the whole result; every rank of the mesh must call it
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
        mesh=None,
    ):
        self.net = net
        self.cfg = cfg
        self.ray_chunk = int(ray_chunk)
        self.want_weights = want_weights
        self.fast = fast
        self.use_kernels = use_kernels
        self.staged = staged
        self.debug_nans = debug_nans
        self.mesh = mesh
        if mesh is not None:
            from ..parallel.render import make_sharded_render

            self._sharded = make_sharded_render(net, cfg, mesh, want_weights, fast=fast, staged=staged,
                                                use_kernels=use_kernels)

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
        if self.mesh is not None:
            out = self._render_sharded(enc, rays, generator, noise)
        else:
            q = field(self.net, enc, self.fast, self.use_kernels, self.staged)
            out = render_rays_chunked(
                q, rays, self.cfg, self.ray_chunk, generator, noise, self.want_weights, self.net.use_viewdirs,
            )
        if self.debug_nans:
            raise_if_not_finite("the render output", out)
        return out

    def _render_sharded(self, enc, rays, generator, noise):
        """The mesh path: each chunk of ``ray_chunk`` rays, padded to a
        multiple of the mesh's ranks with copies of its last ray, is one
        sharded render (each rank renders its slice, the results are
        gathered), then trimmed."""
        from ..parallel.mesh import shard_rays

        size = self.mesh.size
        outs = []
        for i, start in enumerate(range(0, rays.shape[1], self.ray_chunk)):
            part = rays[:, start : start + self.ray_chunk]
            n = part.shape[1]
            pad = -n % size
            chunk_noise = None if noise is None else noise[i]
            if pad:
                part = torch.cat([part, part[:, -1:].expand(-1, pad, -1)], dim=1)
                if chunk_noise is not None:
                    chunk_noise = {k: torch.cat([v, v[:, -1:].expand(-1, pad, -1)], dim=1)
                                   for k, v in chunk_noise.items()}
            out = self._sharded(enc, shard_rays(self.mesh, part), generator, chunk_noise)
            outs.append({b: {k: v[:, :n] for k, v in d.items()} for b, d in out.items()})
        return {b: {k: torch.cat([o[b][k] for o in outs], dim=1) for k in outs[0][b]} for b in outs[0]}

    def __call__(self, enc, rays: torch.Tensor, generator=None, noise=None) -> dict:
        """:param rays: (NR, 8) -> {'coarse': {'rgb': (NR, 3), ...}, ...}"""
        out = self.render_batch(enc, rays[None], generator, noise)
        return {b: {k: v[0] for k, v in d.items()} for b, d in out.items()}

    def render_image(self, enc, rays_hw: torch.Tensor, generator=None, noise=None,
                     fine: Optional[bool] = None):
        """:param rays_hw: (H, W, 8) -> (rgb (H, W, 3), depth (H, W))"""
        H, W, _ = rays_hw.shape
        with span("request", rays=H * W, chunks=-(-H * W // self.ray_chunk)):
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
    """``cv2.resize(img, (out_w, out_h), interpolation=cv2.INTER_AREA)`` of
    an (H, W, C) float32 image, bit for bit: ``utils.imgproc.resize_area``
    (a downscale by its area path; an upscale, ``--scale`` above 1, or a
    resize that shrinks one axis and grows the other by OpenCV's linear
    pass with area-mode offsets)."""
    return resize_area(np.asarray(img, np.float32), out_h, out_w)
