"""Pixel-aligned spatial encoder and the latent lookup (counterpart of
``pixelnerf_tpu/models/encoder.py``).

``SpatialEncoder.forward`` returns the latent instead of caching it, and the
pixel-aligned lookup is the free function :func:`index_latent` on it. For
bilinear/border lookup :func:`index_latent` goes through the gather kernel
(``ops/gather.py``); the other modes use the plain ``grid_sample``.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from ..ops.gather import gather_bilerp, gather_bilerp_plain
from ..ops.grid_sample import _compute_source_index, bilinear_pair_bases, grid_sample
from ..ops.resize import resize_bilinear
from .resnet import ResNetFeatures


def latent_scaling(latent_h: int, latent_w: int, device=None) -> torch.Tensor:
    """Pixel->grid scaling constants, (2,) [sx, sy]: ``s = size/(size-1) * 2``
    per axis, the align_corners=True convention relating original-image
    pixel coordinates to the latent's [-1, 1] grid."""
    return torch.tensor(
        [latent_w / (latent_w - 1) * 2.0, latent_h / (latent_h - 1) * 2.0],
        dtype=torch.float32,
        device=device,
    )


def index_latent(
    latent: torch.Tensor,
    uv: torch.Tensor,
    image_shape: Optional[torch.Tensor] = None,
    interp: str = "bilinear",
    padding: str = "border",
    out_dtype: torch.dtype = torch.float32,
    use_kernels: bool = True,
) -> torch.Tensor:
    """Pixel-aligned feature lookup.

    :param latent: (N, Hl, Wl, C) encoder output
    :param uv: (Ng, P, 2) query points, (x, y) in original-image pixel
        coordinates if ``image_shape`` is given, else already in [-1, 1];
        Ng == N, or N == 1
    :param image_shape: (2,) [W, H] of the original image, or None
    :param out_dtype: dtype of the result (the consumer's compute dtype)
    :param use_kernels: bilinear/border goes through :func:`gather_bilerp`
        (the CUDA kernel for CUDA tensors) if True, else through its plain
        version; a caller-side choice, used to compare the two on the card
    :return: (Ng, P, C) features
    """
    N, Hl, Wl, C = latent.shape
    if image_shape is not None:
        uv = uv * (latent_scaling(Hl, Wl, uv.device) / image_shape) - 1.0
    if interp != "bilinear" or padding != "border":
        return grid_sample(latent, uv, mode=interp, padding_mode=padding).to(out_dtype)
    Ng, P = uv.shape[:2]
    ix = _compute_source_index(uv[..., 0], Wl, "border", True)
    iy = _compute_source_index(uv[..., 1], Hl, "border", True)
    base, w = bilinear_pair_bases(ix, iy, Hl, Wl)                  # (Ng, P, 2)
    if N > 1:
        # fold the view index into the row index of one flat table
        off = torch.arange(Ng, device=uv.device, dtype=torch.int32) * (Hl * Wl)
        base = base + off[:, None, None]
    gather = gather_bilerp if use_kernels else gather_bilerp_plain
    out = gather(
        latent.reshape(N * Hl * Wl, C),
        base.reshape(-1, 2).contiguous(),
        w.reshape(-1, 2).contiguous(),
        Wl,
        out_dtype,
    )
    return out.reshape(Ng, P, C)


class SpatialEncoder(nn.Module):
    """Pixel-aligned CNN encoder: truncated ResNet, multi-scale concat.

    Each stage's map is bilinearly upsampled (align_corners=True) to the
    first stage's resolution and channel-concatenated: (B, H', W',
    latent_size), latent_size = 512 for num_layers=4 (64+64+128+256).
    """

    def __init__(
        self,
        backbone: str = "resnet34",
        num_layers: int = 4,
        use_first_pool: bool = True,
        index_interp: str = "bilinear",
        index_padding: str = "border",
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        if backbone not in ("resnet18", "resnet34"):
            raise NotImplementedError(f"backbone {backbone!r} is not ported yet")
        self.num_layers = num_layers
        self.index_interp = index_interp
        self.index_padding = index_padding
        self.model = ResNetFeatures(backbone, num_layers, use_first_pool, dtype)

    @property
    def latent_size(self) -> int:
        return [0, 64, 128, 256, 512, 1024][self.num_layers]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """:param x: (B, H, W, 3) images in [-1, 1] -> (B, H', W', latent_size)"""
        latents = self.model(x)
        target_h, target_w = latents[0].shape[1:3]
        # the JAX package compares index_interp against "nearest " (with a
        # trailing space), which never matches: align_corners is always True
        latents = [
            resize_bilinear(lat, target_h, target_w, align_corners=True)
            for lat in latents
        ]
        return torch.cat(latents, dim=-1)

    @classmethod
    def from_conf(cls, conf) -> "SpatialEncoder":
        if conf.get_float("feature_scale", 1.0) != 1.0:
            raise NotImplementedError("feature_scale != 1 is not ported yet")
        return cls(
            backbone=conf.get_string("backbone", "resnet34"),
            num_layers=conf.get_int("num_layers", 4),
            use_first_pool=conf.get_bool("use_first_pool", True),
            index_interp=conf.get_string("index_interp", "bilinear"),
            index_padding=conf.get_string("index_padding", "border"),
            dtype=getattr(torch, conf.get_string("dtype", "float32")),
        )
