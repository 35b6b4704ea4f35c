"""Conditioned residual MLP, the NeRF field network (counterpart of
``pixelnerf_tpu/models/resnetfc.py`` ``ResnetFC``).

``lin_in`` to d_hidden, ``n_blocks`` two-layer residual blocks (zero-init
second layer), the latent injection ``x += lin_z[blk](z)`` (with SPADE
``x = scale_z[blk](z) * x + lin_z[blk](z)``) for blocks before
``combine_layer``, multi-view mean/max fusion *at* ``combine_layer``, then
``lin_out``. The activation is ReLU, or with ``beta > 0``
``softplus(beta * x) / beta``. Module names follow the reference's
state_dict (``lin_in``, ``lin_z.{i}``, ``scale_z.{i}``,
``blocks.{i}.fc_0/fc_1``, ``lin_out``).

Parameters stay float32; every layer computes in ``dtype``: the product is
rounded to ``dtype`` before the ``dtype`` bias add, as ``nn.Dense(dtype=...)``
does. With ``fast=True`` and the kernel's gate met (ReLU, no SPADE, bf16,
a latent; a single view, or views averaged at ``combine_layer`` from
latents that are not baked) the whole MLP is one launch of the
fused kernel (``ops/fused_mlp.py``, its multi-view mode at NS > 1);
otherwise the dense chain below runs, as the JAX package leaves every
multi-view case to XLA: the gate is read from the config and the views
before any launch, so softplus, SPADE and max-combined fields always take
the chain. On the card the kernel is built
for ``d_hidden`` 64, 128, 256 or 512 and a latent whose width is a multiple
of 8 (its tile rounded up to 64 columns) and fits the block's shared memory:
other widths with ``fast=True`` raise there, they do not fall back to the
chain.
With ``z_pretransformed`` the latent already holds the injections (a baked
encoding), and with ``gather=`` the latents are gathered inside the kernel
(``ops/fused_field.py``).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.fused_field import fused_gather_resnetfc_infer, fused_gather_resnetfc_infer_plain
from ..ops.fused_mlp import fused_resnetfc_infer, fused_resnetfc_infer_plain, pack_weights
from ..utils.geometry import combine_interleaved
from ..utils.profiling import count


def activation(x: torch.Tensor, beta: float) -> torch.Tensor:
    """ReLU, or with ``beta > 0`` ``softplus(beta * x) / beta``
    (``F.softplus`` returns its argument past 20, where the exact value lies
    within 2.1e-9 of it: below half an ulp of float32 there, so the same
    numbers as ``jax.nn.softplus``)."""
    if beta > 0:
        return F.softplus(x * beta) / beta
    return torch.relu(x)


class ResnetBlockFC(nn.Module):
    """Two-layer residual FC block of width ``size``."""

    def __init__(self, size: int):
        super().__init__()
        self.fc_0 = nn.Linear(size, size)
        self.fc_1 = nn.Linear(size, size)


class ResnetFC(nn.Module):
    def __init__(
        self,
        d_in: int,
        d_out: int = 4,
        n_blocks: int = 5,
        d_latent: int = 0,
        d_hidden: int = 128,
        combine_layer: int = 1000,
        combine_type: str = "average",
        beta: float = 0.0,
        use_spade: bool = False,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.d_in = d_in
        self.d_out = d_out
        self.n_blocks = n_blocks
        self.d_latent = d_latent
        self.d_hidden = d_hidden
        self.combine_layer = combine_layer
        self.combine_type = combine_type
        self.beta = beta
        self.use_spade = use_spade
        self.dtype = dtype
        self.lin_in = nn.Linear(d_in, d_hidden)
        if d_latent > 0:
            self.lin_z = nn.ModuleList(
                [nn.Linear(d_latent, d_hidden) for _ in range(self.n_lin_z)]
            )
            if use_spade:
                self.scale_z = nn.ModuleList(
                    [nn.Linear(d_latent, d_hidden) for _ in range(self.n_lin_z)]
                )
        self.blocks = nn.ModuleList([ResnetBlockFC(d_hidden) for _ in range(n_blocks)])
        self.lin_out = nn.Linear(d_hidden, d_out)

    @property
    def n_lin_z(self) -> int:
        return min(self.combine_layer, self.n_blocks) if self.d_latent > 0 else 0

    def _can_use_kernel(self, single_view: bool, z_pretransformed: bool = False) -> bool:
        """The fused kernel's gate: ReLU, no SPADE, bf16, a latent, and a
        single view (the JAX package's gate) or views that ``combine_type =
        "average"`` averages after at least one block (combine_layer 1 or
        more) from latents that are not baked (the kernel's multi-view
        mode). Widths play no part in it: on
        the card a width the kernel is not built for raises in the kernel's
        wrapper."""
        return (
            self.beta <= 0.0 and not self.use_spade and self.d_latent > 0
            and self.dtype == torch.bfloat16
            and (single_view or (self.combine_type == "average" and not z_pretransformed
                                 and self.combine_layer >= 1))
        )


    def _dense(self, a: torch.Tensor, lin: nn.Linear) -> torch.Tensor:
        dt = self.dtype
        return torch.matmul(a, lin.weight.to(dt).t()) + lin.bias.to(dt)

    def _refuse_autograd(self, *inputs) -> None:
        """The fused kernels have no backward: their result would carry no
        graph, and a training step would silently lose the MLP's gradients."""
        if torch.is_grad_enabled() and (
            any(t is not None and t.requires_grad for t in inputs)
            or any(p.requires_grad for p in self.parameters())
        ):
            raise RuntimeError(
                "ResnetFC(fast=True) is inference-only; run it under torch.no_grad() "
                "or train with fast=False"
            )

    def _shape_out(self, out, lead, combine_inner_dims) -> torch.Tensor:
        out = out[..., : self.d_out]
        if self.combine_layer < self.n_blocks and len(combine_inner_dims) > 1:
            # the dense chain folds to (SB, B, d) at the combine layer
            # even for NS=1; mirror that output shape
            return out.reshape(-1, combine_inner_dims[-1], self.d_out)
        return out.reshape(*lead, self.d_out)

    def forward(
        self,
        zx,
        combine_inner_dims: Sequence[int] = (1,),
        fast: bool = False,
        use_kernels: bool = True,
        z_pretransformed: bool = False,
        gather: Optional[tuple] = None,
    ) -> torch.Tensor:
        """:param zx: a tuple ``(z, x)`` of (..., d_latent) (None without a
            latent) and (..., d_in), kept unconcatenated
        :param combine_inner_dims: (NS, B); the leading axis is reduced over
            NS at combine_layer (multi-view fusion)
        :param fast: allow the fused inference kernel (ReLU, no SPADE,
            bf16; a single view, or views averaged from unbaked latents).
            Inference only: raises where autograd would record the call.
        :param use_kernels: with ``fast``, call the kernel's wrapper if True,
            else its plain version (a caller-side choice for comparing them)
        :param z_pretransformed: ``z`` already holds the latent injections
            ``z_raw @ cat(lin_z weights).T + cat(lin_z biases)``, of width
            ``n_lin_z * d_hidden`` (``models.pixelnerf.bake_encoding``); the
            injection product is skipped
        :param gather: ``(table, base, wg, width)``: gather the latents inside
            the fused gather+MLP kernel (``ops/fused_field.py``) from the
            (R, d_latent) bf16 ``table`` of views ``width`` pixels wide, at
            row bases ``base`` (..., 2) with weights ``wg`` (..., 2). Needs
            ``fast``, ``z`` None, ReLU, no SPADE, bf16, a latent, a single
            view: raises otherwise, never falls back
        :return: (..., d_out) float32, with the NS axis folded away if NS > 1
        """
        dt = self.dtype
        if z_pretransformed and self.use_spade:
            raise ValueError("baked injections are incompatible with SPADE")
        z, x = zx
        z = z.to(dt) if z is not None else None
        x = x.to(dt)
        expect_z = self.n_lin_z * self.d_hidden if z_pretransformed else self.d_latent
        if gather is None and (0 if z is None else z.shape[-1]) != expect_z:
            raise ValueError(f"z width does not match the expected {expect_z}")
        if x.shape[-1] != self.d_in:
            raise ValueError("x width does not match d_in")

        single_view = (
            len(combine_inner_dims) == 1 or combine_inner_dims[0] == 1
        ) or self.combine_layer >= self.n_blocks
        lead = x.shape[:-1]

        if gather is not None:
            # a deliberate opt-in (PixelNeRFNet.query_fused): raise, do not
            # silently fall back
            if not fast or z is not None or z_pretransformed:
                raise ValueError("gather= needs fast=True, z=None and an unbaked latent")
            if not (single_view and self._can_use_kernel(single_view)):
                raise ValueError(
                    "the fused gather path requires ReLU, no SPADE, bf16, d_latent > 0 and a single view")
            table, base, wg, width = gather
            self._refuse_autograd(x, table, wg)
            run = fused_gather_resnetfc_infer if use_kernels else fused_gather_resnetfc_infer_plain
            out = run(
                table,
                base.reshape(-1, 2).contiguous(),
                wg.reshape(-1, 2).contiguous(),
                x.reshape(-1, self.d_in).contiguous(),
                pack_weights(self),
                self.n_blocks,
                self.combine_layer,
                width,
            )
            return self._shape_out(out, lead, combine_inner_dims)

        if fast and z is not None and self._can_use_kernel(single_view, z_pretransformed):
            self._refuse_autograd(z, x)
            count("kernel_b")
            views, points = 1, None
            if not single_view:
                # rows (SB, NS, B...): the views' mean inside the kernel
                views, points = int(combine_inner_dims[0]), math.prod(int(d) for d in combine_inner_dims[1:])
                count("kernel_b_views", views)
            run = fused_resnetfc_infer if use_kernels else fused_resnetfc_infer_plain
            out = run(
                z.reshape(-1, expect_z).contiguous(),
                x.reshape(-1, self.d_in).contiguous(),
                pack_weights(self, with_wz=not z_pretransformed),
                self.n_blocks,
                self.combine_layer,
                z_pretransformed,
                views=views,
                points=points,
            )
            return self._shape_out(out, lead, combine_inner_dims)

        count("dense")
        tz_list = sz_list = None
        if z is not None and self.d_latent > 0:
            if z_pretransformed:
                tz_all = z
            else:
                # all latent injections as ONE product: reads z once
                K = torch.cat([lin.weight for lin in self.lin_z], dim=0).to(dt)
                B = torch.cat([lin.bias for lin in self.lin_z]).to(dt)
                tz_all = torch.matmul(z, K.t()) + B
            dh = self.d_hidden
            tz_list = [tz_all[..., i * dh : (i + 1) * dh] for i in range(self.n_lin_z)]
            if self.use_spade:
                Ks = torch.cat([lin.weight for lin in self.scale_z], dim=0).to(dt)
                Bs = torch.cat([lin.bias for lin in self.scale_z]).to(dt)
                sz_all = torch.matmul(z, Ks.t()) + Bs
                sz_list = [sz_all[..., i * dh : (i + 1) * dh] for i in range(self.n_lin_z)]

        x = self._dense(x, self.lin_in)

        for blkid in range(self.n_blocks):
            if blkid == self.combine_layer:
                x = combine_interleaved(
                    x.reshape(-1, x.shape[-1]), combine_inner_dims, self.combine_type
                )
                tz_list = sz_list = None   # latent injected only before fusion
            if tz_list is not None and blkid < self.combine_layer:
                if sz_list is not None:
                    x = sz_list[blkid] * x + tz_list[blkid]
                else:
                    x = x + tz_list[blkid]
            blk = self.blocks[blkid]
            net = self._dense(activation(x, self.beta), blk.fc_0)
            x = x + self._dense(activation(net, self.beta), blk.fc_1)

        return self._dense(activation(x, self.beta), self.lin_out).float()

    @classmethod
    def from_conf(cls, conf, d_in: int, **kwargs) -> "ResnetFC":
        return cls(
            d_in=d_in,
            n_blocks=conf.get_int("n_blocks", 5),
            d_hidden=conf.get_int("d_hidden", 128),
            combine_layer=conf.get_int("combine_layer", 1000),
            combine_type=conf.get_string("combine_type", "average"),
            beta=conf.get_float("beta", 0.0),
            use_spade=conf.get_bool("use_spade", False),
            dtype=getattr(torch, conf.get_string("dtype", "float32")),
            **kwargs,
        )
