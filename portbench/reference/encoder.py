"""The pixel-aligned ResNet encoder of pixelNeRF (Yu et al. 2021, §4.1):
a ResNet's stem and first ``num_layers - 1`` stages; each stage's map is
upsampled bilinearly (align_corners) to the stem's resolution and the maps
are concatenated along channels. Weights are read by torchvision's names
under ``encoder.model.``."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .precision import Precision

BN_EPS = 1e-5
STAGE_BLOCKS = {"resnet18": (2, 2, 2, 2), "resnet34": (3, 4, 6, 3)}
PREFIX = "encoder.model."


def batch_norm(x: torch.Tensor, w: dict, name: str, train: bool) -> torch.Tensor:
    """Inference: the running statistics. Training: the batch's mean and
    biased variance, E[x^2] - E[x]^2 clipped at 0, over N, H and W."""
    if train:
        mean = x.mean(dim=(0, 2, 3))
        var = torch.clamp(x.square().mean(dim=(0, 2, 3)) - mean.square(), min=0.0)
    else:
        mean, var = w[name + ".running_mean"], w[name + ".running_var"]
    mul = torch.rsqrt(var + BN_EPS) * w[name + ".weight"]
    return (x - mean[:, None, None]) * mul[:, None, None] + w[name + ".bias"][:, None, None]


def _block(x, w, name, stride, prec, train):
    y = prec.conv(x, w[name + ".conv1.weight"], stride, 1)
    y = torch.relu(batch_norm(y, w, name + ".bn1", train))
    y = batch_norm(prec.conv(y, w[name + ".conv2.weight"], 1, 1), w, name + ".bn2", train)
    if name + ".downsample.0.weight" in w:
        x = batch_norm(prec.conv(x, w[name + ".downsample.0.weight"], stride, 0), w, name + ".downsample.1", train)
    return torch.relu(y + x)


def encode(w: dict, images: torch.Tensor, encoder: dict, prec: Precision = None, train: bool = False) -> torch.Tensor:
    """(N, H, W, 3) images in [-1, 1] -> (N, H/2, W/2, latent_size)."""
    prec = prec or Precision()
    x = images.permute(0, 3, 1, 2)
    x = torch.relu(batch_norm(prec.conv(x, w[PREFIX + "conv1.weight"], 2, 3), w, PREFIX + "bn1", train))
    maps = [x]
    for k in range(1, encoder["num_layers"]):
        if k == 1:
            x = F.max_pool2d(x, 3, 2, 1)
        for b in range(STAGE_BLOCKS[encoder["backbone"]][k - 1]):
            x = _block(x, w, f"{PREFIX}layer{k}.{b}", 2 if (b == 0 and k > 1) else 1, prec, train)
        maps.append(x)
    h, wd = maps[0].shape[2:]
    maps = [m if m.shape[2:] == (h, wd) else F.interpolate(m, size=(h, wd), mode="bilinear", align_corners=True)
            for m in maps]
    return prec.store(torch.cat(maps, dim=1).permute(0, 2, 3, 1).contiguous())
