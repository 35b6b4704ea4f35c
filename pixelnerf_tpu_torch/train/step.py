"""The training step: encode + staged render + loss + backward + Adam
(counterpart of ``pixelnerf_tpu/train/step.py``).

PyTorch runs eagerly, so the step is a closure over the model and the
optimizer that updates both in place, where the JAX step is a pure jitted
function of a train state. The pixel-aligned gather goes through kernel C
and its backward (``index_latent(differentiable=True)``); the MLPs run
their dense chain (the JAX package leaves training's GEMMs to XLA).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Union

import torch

from ..render.renderer import RenderConfig, render_rays, render_rays_chunked


def _stages(net, enc, use_kernels: bool, differentiable: bool):
    """The staged renderer's ``(features_fn, mlp_fn)`` for ``net`` on ``enc``."""

    def features_fn(xyz, viewdirs):
        return net.query_features(
            enc, xyz, viewdirs, use_kernels=use_kernels, differentiable=differentiable
        )

    def mlp_fn(feats, coarse):
        return net.query_mlp(enc, feats, coarse=coarse, use_kernels=use_kernels)

    return features_fn, mlp_fn


def make_train_step(
    net,
    cfg: RenderConfig,
    optimizer: torch.optim.Optimizer,
    loss_fn,
    train_encoder: bool = True,
    ray_chunk: Optional[int] = None,
    remat: Union[bool, str] = True,
    accu_grad: int = 1,
    use_kernels: bool = True,
):
    """Build ``step(batch, generator=None, noise=None) -> metrics``.

    batch: images (SB, NS, H, W, 3), poses (SB, NS, 4, 4), focal, c, rays
    (SB, R, 8), rgb_gt (SB, R, 3), tensors on the model's device.

    :param optimizer: over the model's parameters; ``torch.optim.Adam(lr,
        betas=(0.9, 0.999), eps=1e-8)`` is ``optax.adam``
    :param train_encoder: the encoder's batch norms in training mode
        (batch statistics, running statistics updated)
    :param ray_chunk: render in chunks of this many rays per object when
        R exceeds it, with ``remat`` as in ``render_rays_chunked``
    :param accu_grad: average the gradients of this many calls before one
        optimizer update (``optax.MultiSteps``)
    :param use_kernels: the gather through kernel C and its backward (for
        CUDA tensors) if True, else through their plain versions
    :return: the step; ``noise`` is one pre-drawn noise dict per ray chunk
        (one entry when the step does not chunk), else the draws come from
        ``generator``. Metrics: ``rc``, ``rf``, ``t`` (the losses) and
        ``gnorm`` (the global L2 norm of this call's gradients), detached
        0-d tensors.
    """
    if accu_grad < 1:
        raise ValueError(f"accu_grad must be >= 1, got {accu_grad}")
    params = [p for g in optimizer.param_groups for p in g["params"]]
    acc: List[Optional[torch.Tensor]] = [None] * len(params)
    calls = [0]

    def step(
        batch: Dict[str, torch.Tensor],
        generator: Optional[torch.Generator] = None,
        noise: Optional[List[Dict[str, torch.Tensor]]] = None,
    ) -> Dict[str, torch.Tensor]:
        for p in params:
            p.grad = None
        enc = net.encode(
            batch["images"], batch["poses"], batch["focal"], batch.get("c"), train=train_encoder
        )
        stages = _stages(net, enc, use_kernels, differentiable=True)
        rays = batch["rays"]
        if ray_chunk is not None and rays.shape[1] > ray_chunk:
            outputs = render_rays_chunked(
                *stages, rays, cfg, ray_chunk, generator, noise,
                use_viewdirs=net.use_viewdirs, train=True, remat=remat,
            )
        else:
            outputs = render_rays(
                *stages, rays, cfg, generator, None if noise is None else noise[0],
                use_viewdirs=net.use_viewdirs, train=True,
            )
        loss, metrics = loss_fn(outputs, batch["rgb_gt"])
        loss.backward()
        grads = [p.grad for p in params]
        sq = [g.float().square().sum() for g in grads if g is not None]
        gnorm = torch.sqrt(torch.stack(sq).sum()) if sq else torch.zeros(())
        update = True
        if accu_grad > 1:
            # MultiSteps: one update with the mean of accu_grad calls' gradients
            calls[0] += 1
            update = calls[0] % accu_grad == 0
            for i, (p, g) in enumerate(zip(params, grads)):
                if g is not None:
                    acc[i] = g / accu_grad if acc[i] is None else acc[i] + g / accu_grad
                p.grad = acc[i] if update else None
                if update:
                    acc[i] = None
        if update:
            optimizer.step()
        return {**{k: v.detach() for k, v in metrics.items()}, "gnorm": gnorm.detach()}

    return step


def make_eval_step(net, cfg: RenderConfig, loss_fn):
    """Loss-only step on a held-out batch: ``eval_step(batch, generator=None,
    noise=None) -> metrics``, no gradients, the unchunked inference render
    (kernel A's gather)."""

    @torch.no_grad()
    def step(batch, generator=None, noise=None):
        enc = net.encode(batch["images"], batch["poses"], batch["focal"], batch.get("c"))
        outputs = render_rays(
            *_stages(net, enc, use_kernels=True, differentiable=False), batch["rays"], cfg,
            generator, noise, use_viewdirs=net.use_viewdirs,
        )
        _, metrics = loss_fn(outputs, batch["rgb_gt"])
        return metrics

    return step
