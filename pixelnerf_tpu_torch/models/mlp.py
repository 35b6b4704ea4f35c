"""IGR-style plain MLP field, the alternative to ResnetFC (counterpart of
``pixelnerf_tpu/models/mlp.py`` ``ImplicitNet``; ``type = mlp``).

Input-skip concats scaled by 1/sqrt(2), the optional geometric (sphere-SDF)
initialisation (:meth:`ImplicitNet.geometric_init_`) and the same
``combine_interleaved`` multi-view fusion at ``combine_layer``, applied to
both the running ``x`` and the skip input ``x_init``. Layers are
``lin{i}``; each computes in ``dtype`` (the product rounded to ``dtype``
before the ``dtype`` bias add, as ``nn.Dense(dtype=...)``), the output is
float32. There is no fused kernel for it: ``fast`` is accepted and unused,
as in the JAX package.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn

from ..utils.geometry import combine_interleaved
from .resnetfc import activation


class ImplicitNet(nn.Module):
    def __init__(
        self,
        d_in: int,
        dims: Sequence[int],
        skip_in: Sequence[int] = (),
        d_out: int = 4,
        geometric_init: bool = True,
        radius_init: float = 0.3,
        beta: float = 0.0,
        output_init_gain: float = 2.0,
        num_position_inputs: int = 3,
        sdf_scale: float = 1.0,
        dim_excludes_skip: bool = False,
        combine_layer: int = 1000,
        combine_type: str = "average",
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.d_in = d_in
        self.skip_in = tuple(skip_in)
        self.d_out = d_out
        self.geometric_init = geometric_init
        self.radius_init = radius_init
        self.beta = beta
        self.output_init_gain = output_init_gain
        self.num_position_inputs = num_position_inputs
        self.sdf_scale = sdf_scale
        self.combine_layer = combine_layer
        self.combine_type = combine_type
        self.dtype = dtype
        dims = [d_in] + list(dims) + [d_out]
        if dim_excludes_skip:
            for i in range(1, len(dims) - 1):
                if i in self.skip_in:
                    dims[i] += d_in
        self.dims = dims
        self.num_layers = len(dims)
        width = d_in
        for layer in range(self.num_layers - 1):
            out_dim = dims[layer + 1] - d_in if layer + 1 in self.skip_in else dims[layer + 1]
            if layer < combine_layer and layer in self.skip_in:
                width += d_in
            setattr(self, f"lin{layer}", nn.Linear(width, out_dim))
            width = out_dim

    @torch.no_grad()
    def geometric_init_(self, generator: torch.Generator) -> None:
        """The JAX package's geometric initialisation, drawn from
        ``generator``: standard normal weights scaled by sqrt(2 / out_dim);
        the output layer's row 0 at ``1e-5 * N(0, 1) - sqrt(pi / in_dim) *
        sdf_scale`` and its other rows scaled by ``output_init_gain``, its
        bias 0 but ``radius_init`` at row 0; the input columns past the
        position inputs zeroed at layer 0 and at the skip layers."""
        last = self.num_layers - 2
        for layer in range(self.num_layers - 1):
            lin = getattr(self, f"lin{layer}")
            out_dim, in_dim = lin.weight.shape
            w = torch.randn((out_dim, in_dim), generator=generator)
            if layer == last:
                w[0] = w[0] * 1e-5 - math.sqrt(math.pi) / math.sqrt(self.dims[layer]) * self.sdf_scale
                if self.d_out > 1:
                    w[1:] = w[1:] * self.output_init_gain
            else:
                w = w * (math.sqrt(2.0) / math.sqrt(out_dim))
            if self.d_in > self.num_position_inputs and (layer == 0 or layer in self.skip_in):
                w[:, -self.d_in + self.num_position_inputs :] = 0.0
            lin.weight.copy_(w)
            lin.bias.zero_()
            if layer == last:
                lin.bias[0] = self.radius_init

    def forward(
        self, zx, combine_inner_dims: Sequence[int] = (1,), fast: bool = False, use_kernels: bool = True,
        z_pretransformed: bool = False,
    ) -> torch.Tensor:
        """:param zx: ``(z, x)``, concatenated latent first (either may be
            None), (..., d_in) together
        :return: (..., d_out) float32, with the NS axis folded away at
            ``combine_layer``"""
        if z_pretransformed:
            raise ValueError("ImplicitNet takes no baked injections")
        x = torch.cat([v for v in zx if v is not None], dim=-1).to(self.dtype)
        x_init = x
        dt = self.dtype
        for layer in range(self.num_layers - 1):
            if layer == self.combine_layer:
                x = combine_interleaved(x.reshape(-1, x.shape[-1]), combine_inner_dims, self.combine_type)
                x_init = combine_interleaved(
                    x_init.reshape(-1, x_init.shape[-1]), combine_inner_dims, self.combine_type
                )
            if layer < self.combine_layer and layer in self.skip_in:
                x = torch.cat([x, x_init], dim=-1) / math.sqrt(2)
            lin = getattr(self, f"lin{layer}")
            x = torch.matmul(x, lin.weight.to(dt).t()) + lin.bias.to(dt)
            if layer < self.num_layers - 2:
                x = activation(x, self.beta)
        return x.float()

    @classmethod
    def from_conf(cls, conf, d_in: int) -> "ImplicitNet":
        return cls(
            d_in=d_in,
            dims=tuple(conf.get_list("dims")),
            skip_in=tuple(conf.get_list("skip_in", [])),
            beta=conf.get_float("beta", 0.0),
            dim_excludes_skip=conf.get_bool("dim_excludes_skip", False),
            combine_layer=conf.get_int("combine_layer", 1000),
            combine_type=conf.get_string("combine_type", "average"),
            dtype=getattr(torch, conf.get_string("dtype", "float32")),
        )
