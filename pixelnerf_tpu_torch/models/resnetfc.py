"""Conditioned residual MLP, the NeRF field network (counterpart of
``pixelnerf_tpu/models/resnetfc.py`` ``ResnetFC``).

``lin_in`` to d_hidden, ``n_blocks`` two-layer residual blocks (zero-init
second layer), the latent injection ``x += lin_z[blk](z)`` for blocks before
``combine_layer``, multi-view mean/max fusion *at* ``combine_layer``, then
``lin_out``. Module names follow the reference's state_dict
(``lin_in``, ``lin_z.{i}``, ``blocks.{i}.fc_0/fc_1``, ``lin_out``).

Parameters stay float32; every layer computes in ``dtype``: the product is
rounded to ``dtype`` before the ``dtype`` bias add, as ``nn.Dense(dtype=...)``
does. With ``fast=True`` and the kernel's gate met (bf16, single view,
a latent) the whole MLP is one launch of the
fused kernel (``ops/fused_mlp.py``); otherwise the dense chain below runs,
as the JAX package leaves that case to XLA.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from ..ops.fused_mlp import fused_resnetfc_infer, fused_resnetfc_infer_plain, pack_weights
from ..utils.geometry import combine_interleaved


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
        self.dtype = dtype
        self.lin_in = nn.Linear(d_in, d_hidden)
        if d_latent > 0:
            self.lin_z = nn.ModuleList(
                [nn.Linear(d_latent, d_hidden) for _ in range(self.n_lin_z)]
            )
        self.blocks = nn.ModuleList([ResnetBlockFC(d_hidden) for _ in range(n_blocks)])
        self.lin_out = nn.Linear(d_hidden, d_out)

    @property
    def n_lin_z(self) -> int:
        return min(self.combine_layer, self.n_blocks) if self.d_latent > 0 else 0

    def _can_use_kernel(self, z, single_view: bool) -> bool:
        return (
            self.d_latent > 0
            and z is not None
            and single_view
            and self.dtype == torch.bfloat16
        )

    def _dense(self, a: torch.Tensor, lin: nn.Linear) -> torch.Tensor:
        dt = self.dtype
        return torch.matmul(a, lin.weight.to(dt).t()) + lin.bias.to(dt)

    def forward(
        self,
        zx,
        combine_inner_dims: Sequence[int] = (1,),
        fast: bool = False,
        use_kernels: bool = True,
    ) -> torch.Tensor:
        """:param zx: a tuple ``(z, x)`` of (..., d_latent) (None without a
            latent) and (..., d_in), kept unconcatenated
        :param combine_inner_dims: (NS, B); the leading axis is reduced over
            NS at combine_layer (multi-view fusion)
        :param fast: allow the fused inference kernel (single-view, bf16).
            Inference only.
        :param use_kernels: with ``fast``, call the kernel's wrapper if True,
            else its plain version (a caller-side choice for comparing them)
        :return: (..., d_out) float32, with the NS axis folded away if NS > 1
        """
        dt = self.dtype
        z, x = zx
        z = z.to(dt) if z is not None else None
        x = x.to(dt)
        if (0 if z is None else z.shape[-1]) != self.d_latent or x.shape[-1] != self.d_in:
            raise ValueError("z/x widths do not match d_latent/d_in")

        single_view = (
            len(combine_inner_dims) == 1 or combine_inner_dims[0] == 1
        ) or self.combine_layer >= self.n_blocks

        if fast and self._can_use_kernel(z, single_view):
            run = fused_resnetfc_infer if use_kernels else fused_resnetfc_infer_plain
            lead = x.shape[:-1]
            out = run(
                z.reshape(-1, self.d_latent).contiguous(),
                x.reshape(-1, self.d_in).contiguous(),
                pack_weights(self),
                self.n_blocks,
                self.combine_layer,
            )[..., : self.d_out]
            if self.combine_layer < self.n_blocks and len(combine_inner_dims) > 1:
                # the dense chain folds to (SB, B, d) at the combine layer
                # even for NS=1; mirror that output shape
                return out.reshape(-1, combine_inner_dims[-1], self.d_out)
            return out.reshape(*lead, self.d_out)

        tz_list = None
        if z is not None and self.d_latent > 0:
            # all latent injections as ONE product: reads z once
            K = torch.cat([lin.weight for lin in self.lin_z], dim=0).to(dt)
            B = torch.cat([lin.bias for lin in self.lin_z]).to(dt)
            tz_all = torch.matmul(z, K.t()) + B
            dh = self.d_hidden
            tz_list = [tz_all[..., i * dh : (i + 1) * dh] for i in range(self.n_lin_z)]

        x = self._dense(x, self.lin_in)

        for blkid in range(self.n_blocks):
            if blkid == self.combine_layer:
                x = combine_interleaved(
                    x.reshape(-1, x.shape[-1]), combine_inner_dims, self.combine_type
                )
                tz_list = None   # latent injected only before fusion
            if tz_list is not None and blkid < self.combine_layer:
                x = x + tz_list[blkid]
            blk = self.blocks[blkid]
            net = self._dense(torch.relu(x), blk.fc_0)
            x = x + self._dense(torch.relu(net), blk.fc_1)

        return self._dense(torch.relu(x), self.lin_out).float()

    @classmethod
    def from_conf(cls, conf, d_in: int, **kwargs) -> "ResnetFC":
        if conf.get_bool("use_spade", False) or conf.get_float("beta", 0.0) > 0:
            raise NotImplementedError("SPADE and softplus (beta > 0) ResnetFC are not ported yet")
        return cls(
            d_in=d_in,
            n_blocks=conf.get_int("n_blocks", 5),
            d_hidden=conf.get_int("d_hidden", 128),
            combine_layer=conf.get_int("combine_layer", 1000),
            combine_type=conf.get_string("combine_type", "average"),
            dtype=getattr(torch, conf.get_string("dtype", "float32")),
            **kwargs,
        )
