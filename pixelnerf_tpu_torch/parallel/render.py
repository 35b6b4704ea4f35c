"""Sharded rendering: rays over ranks, no per-ray communication
(counterpart of ``pixelnerf_tpu/parallel/render.py``).

Each rank renders its slice of the rays with the whole model and encoding,
and with its slice of the random draws made on the global shape, so every
ray sees the numbers the single-process render gives it. Only the outputs
are gathered, so every rank returns the whole result, as the JAX package's
replicated ``out_shardings`` do.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..eval.common import field
from ..render.renderer import RenderConfig, draw_noise, render_rays, render_rays_chunked
from .mesh import Mesh, gather_rays, local_noise, split_noise
from .mesh import shard_rays  # noqa: F401  (the JAX module exports it here)


def global_draws(cfg: RenderConfig, generator: torch.Generator, shape, ray_chunk: Optional[int],
                 device, dtype=torch.float32, train: bool = False):
    """The draws a single-process render of (SB, B) rays makes from
    ``generator``: one noise dict per chunk of ``ray_chunk`` rays along B
    (one dict when ``ray_chunk`` is None), each drawn as
    ``render_rays_chunked`` draws it."""
    SB, B = shape
    step = B if ray_chunk is None else ray_chunk
    return [draw_noise(torch.empty((SB, min(step, B - s), 8), device=device, dtype=dtype), cfg, generator, train)
            for s in range(0, B, step)]


def make_sharded_render(
    net,
    cfg: RenderConfig,
    mesh: Mesh,
    want_weights: bool = False,
    ray_chunk: Optional[int] = None,
    fast: bool = False,
    staged: bool = False,
    use_kernels: bool = True,
):
    """Build ``render(enc, rays, generator=None, noise=None) -> outputs``.

    ``rays`` is this rank's (SB, B / ranks, 8) slice (:func:`shard_rays`
    of the global rays); ``noise`` the draws on the global (SB, B) shape,
    one dict or one per chunk of ``ray_chunk`` rays, else they are drawn
    from ``generator`` as a single-process render draws them. Every rank
    returns the whole (SB, B) result, and every rank of the mesh must call
    it.

    :param staged: render through the staged pair instead of ``net.query``
        (the JAX package's sharded render is unstaged)
    :param fast: the field MLPs through the fused kernel (bf16)
    """

    @torch.inference_mode()
    def render(enc, rays: torch.Tensor, generator: Optional[torch.Generator] = None, noise=None):
        SB, b_local, _ = rays.shape
        if noise is None:
            if generator is None:
                raise ValueError("pass a torch.Generator or pre-drawn noise")
            noise = global_draws(cfg, generator, (SB, b_local * mesh.size), ray_chunk, rays.device, rays.dtype)
        b = slice(mesh.rank * b_local, (mesh.rank + 1) * b_local)
        mine = local_noise(noise, slice(None), b)
        q = field(net, enc, fast, use_kernels, staged)
        if ray_chunk is not None and b_local > ray_chunk:
            out = render_rays_chunked(q, rays, cfg, ray_chunk, None, split_noise(mine, ray_chunk), want_weights,
                                      net.use_viewdirs)
        else:
            out = render_rays(q, rays, cfg, None, mine, want_weights, net.use_viewdirs)
        return gather_rays(mesh, out)

    return render

