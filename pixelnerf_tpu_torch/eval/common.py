"""Full-frame chunked rendering (counterpart of
``pixelnerf_tpu/eval/common.py`` ``FullRenderer``).

The eval and serving paths render NV*H*W rays per object in fixed-size
chunks; here each chunk is one ``render_rays`` call in a Python loop
(PyTorch runs eagerly, so no chunk is padded).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

from ..render.renderer import RenderConfig, render_rays_chunked


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
    ):
        self.net = net
        self.cfg = cfg
        self.ray_chunk = int(ray_chunk)
        self.want_weights = want_weights
        self.fast = fast
        self.use_kernels = use_kernels
        self.staged = staged

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
        return render_rays_chunked(
            q, rays, self.cfg, self.ray_chunk, generator, noise, self.want_weights, net.use_viewdirs,
        )

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
