"""The training step: encode + staged render + loss + backward + Adam
(counterpart of ``pixelnerf_tpu/train/step.py``).

PyTorch runs eagerly, so the step is a closure over the model and the
optimizer that updates both in place, where the JAX step is a pure jitted
function of a train state. The pixel-aligned gather goes through kernel C
and its backward (``index_latent(differentiable=True)``); the MLPs run
their dense chain (the JAX package leaves training's GEMMs to XLA).
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Union

import torch

from ..eval.common import FullRenderer
from ..parallel.mesh import DATA_AXIS, RAY_AXIS, average_over_ranks, local_noise, split_noise, synced_batch_norms
from ..parallel.render import global_draws
from ..render.renderer import RenderConfig, render_rays, render_rays_chunked
from ..utils.nans import raise_if_not_finite
from ..utils.profiling import span


def _stages(net, enc, use_kernels: bool, differentiable: bool):
    """The staged renderer's ``(features_fn, mlp_fn)`` for ``net`` on ``enc``."""

    def features_fn(xyz, viewdirs):
        return net.query_features(
            enc, xyz, viewdirs, use_kernels=use_kernels, differentiable=differentiable
        )

    def mlp_fn(feats, coarse):
        return net.query_mlp(enc, feats, coarse=coarse, use_kernels=use_kernels)

    return features_fn, mlp_fn


def accumulation_state(optimizer: torch.optim.Optimizer) -> dict:
    """The gradient accumulation's state, kept on the optimizer as
    ``optax.MultiSteps`` keeps it in the optimizer state: ``mini_step``, the
    calls since the last update, and ``acc_grads``, their partial mean (one
    entry per parameter of the optimizer, None before the first call).
    ``train/state.py`` saves and restores it with the optimizer, and every
    step built on the optimizer shares it."""
    state = getattr(optimizer, "accumulation", None)
    if state is None:
        state = optimizer.accumulation = {"mini_step": 0, "acc_grads": None}
    return state


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
    debug_nans: bool = False,
    mesh=None,
):
    """Build ``step(batch, generator=None, noise=None) -> metrics``.

    batch: images (SB, NS, H, W, 3), poses (SB, NS, 4, 4), focal, c, rays
    (SB, R, 8), rgb_gt (SB, R, 3), tensors on the model's device; with a
    ``mesh``, this rank's slice of the global batch (``shard_batch``), whose
    SB divides the data axis and R the ray axis.

    :param optimizer: over the model's parameters; ``torch.optim.Adam(lr,
        betas=(0.9, 0.999), eps=1e-8)`` is ``optax.adam``
    :param train_encoder: the encoder's batch norms in training mode
        (batch statistics, running statistics updated)
    :param ray_chunk: render in chunks of this many rays per object when
        R exceeds it, with ``remat`` as in ``render_rays_chunked``
    :param accu_grad: average the gradients of this many calls before one
        optimizer update (``optax.MultiSteps``); the partial mean and the
        call counter live in :func:`accumulation_state` of the optimizer, so
        a checkpoint in the middle of an accumulation resumes it
    :param use_kernels: the gather through kernel C and its backward (for
        CUDA tensors) if True, else through their plain versions
    :param debug_nans: raise ``FloatingPointError`` at a non-finite loss,
        before its backward, and run the step under autograd's anomaly
        detection, which raises at a backward function's NaN output (the
        counterpart of ``jax_debug_nans``; off, it costs nothing)
    :param mesh: a ``parallel.Mesh`` (the JAX step's ``mesh``): each rank
        renders its slice of the rays with its slice of the draws made on
        the global shape, the encoders' batch norms reduce their statistics
        over the data axis, and the gradients and the losses are averaged
        over every rank before the update, so that each rank applies the
        gradient of the mean loss over the global batch. Every rank of the
        mesh must call the step
    :return: the step; ``noise`` is one pre-drawn noise dict per ray chunk
        (one entry when the step does not chunk; with a mesh, on the global
        shape), else the draws come from ``generator``. Metrics: ``rc``,
        ``rf``, ``t`` (the losses) and ``gnorm`` (the global L2 norm of this
        call's gradients), detached 0-d tensors.
    """
    if accu_grad < 1:
        raise ValueError(f"accu_grad must be >= 1, got {accu_grad}")
    params = [p for g in optimizer.param_groups for p in g["params"]]
    anomaly = (lambda: torch.autograd.set_detect_anomaly(True)) if debug_nans else contextlib.nullcontext

    def step(
        batch: Dict[str, torch.Tensor],
        generator: Optional[torch.Generator] = None,
        noise: Optional[List[Dict[str, torch.Tensor]]] = None,
    ) -> Dict[str, torch.Tensor]:
        with span("train.step", rays=batch["rays"].shape[0] * batch["rays"].shape[1]):
            for p in params:
                p.grad = None
            rays = batch["rays"]
            if mesh is not None:
                noise = _local_train_noise(mesh, cfg, rays, ray_chunk, generator, noise)
            with anomaly(), synced_batch_norms(net, mesh):
                with span("forward"):
                    enc = net.encode(
                        batch["images"], batch["poses"], batch["focal"], batch.get("c"), train=train_encoder
                    )
                    stages = _stages(net, enc, use_kernels, differentiable=True)
                    if ray_chunk is not None and rays.shape[1] > ray_chunk:
                        outputs = render_rays_chunked(
                            stages, rays, cfg, ray_chunk, generator, noise,
                            use_viewdirs=net.use_viewdirs, train=True, remat=remat,
                        )
                    else:
                        outputs = render_rays(
                            stages, rays, cfg, generator, None if noise is None else noise[0],
                            use_viewdirs=net.use_viewdirs, train=True,
                        )
                    loss, metrics = loss_fn(outputs, batch["rgb_gt"])
                    if debug_nans:
                        raise_if_not_finite("the train loss", loss)
                with span("backward"):
                    loss.backward()
            with span("optimizer"):
                grads = [p.grad for p in params]
                if mesh is not None:
                    metrics = {k: v.detach().clone() for k, v in metrics.items()}
                    average_over_ranks(mesh, grads + list(metrics.values()))
                sq = [g.float().square().sum() for g in grads if g is not None]
                gnorm = torch.sqrt(torch.stack(sq).sum()) if sq else torch.zeros(())
                update = True
                if accu_grad > 1:
                    # MultiSteps: one update with the mean of accu_grad calls' gradients
                    state = accumulation_state(optimizer)
                    acc: List[Optional[torch.Tensor]] = state["acc_grads"] or [None] * len(params)
                    state["mini_step"] += 1
                    # >=: a counter restored from a run with a larger accu_grad still updates
                    update = state["mini_step"] >= accu_grad
                    for i, (p, g) in enumerate(zip(params, grads)):
                        if g is not None:
                            acc[i] = g / accu_grad if acc[i] is None else acc[i] + g / accu_grad
                        p.grad = acc[i] if update else None
                    state["acc_grads"] = None if update else acc
                    if update:
                        state["mini_step"] = 0
                if update:
                    optimizer.step()
            return {**{k: v.detach() for k, v in metrics.items()}, "gnorm": gnorm.detach()}

    return step


def _local_train_noise(mesh, cfg, rays, ray_chunk, generator, noise):
    """This rank's draws for its (SB / data, R / ray) block of the rays, one
    dict per chunk of its render: the global draws (``noise``, else drawn
    from ``generator`` as the single-process step draws them) sliced."""
    SB, R = rays.shape[0] * mesh.shape[DATA_AXIS], rays.shape[1] * mesh.shape[RAY_AXIS]
    if noise is None:
        if generator is None:
            raise ValueError("pass a torch.Generator or pre-drawn noise")
        chunked = ray_chunk is not None and R > ray_chunk
        noise = global_draws(cfg, generator, (SB, R), ray_chunk if chunked else None, rays.device, rays.dtype,
                             train=True)
    sb = slice(mesh.data_index * rays.shape[0], (mesh.data_index + 1) * rays.shape[0])
    b = slice(mesh.ray_index * rays.shape[1], (mesh.ray_index + 1) * rays.shape[1])
    return split_noise(local_noise(noise, sb, b), ray_chunk)


def make_eval_step(net, cfg: RenderConfig, loss_fn, mesh=None):
    """Loss-only step on a held-out batch: ``eval_step(batch, generator=None,
    noise=None) -> metrics``, no gradients, the unchunked inference render
    (kernel A's gather). With a ``mesh`` every rank takes the whole batch
    and renders its slice of the rays (``FullRenderer(mesh=)``); every rank
    of the mesh must call it."""

    @torch.no_grad()
    def step(batch, generator=None, noise=None):
        enc = net.encode(batch["images"], batch["poses"], batch["focal"], batch.get("c"))
        if mesh is not None:
            renderer = FullRenderer(net, cfg, ray_chunk=batch["rays"].shape[1], mesh=mesh)
            outputs = renderer.render_batch(enc, batch["rays"], generator, None if noise is None else [noise])
        else:
            outputs = render_rays(
                _stages(net, enc, use_kernels=True, differentiable=False), batch["rays"], cfg,
                generator, noise, use_viewdirs=net.use_viewdirs,
            )
        _, metrics = loss_fn(outputs, batch["rgb_gt"])
        return metrics

    return step
