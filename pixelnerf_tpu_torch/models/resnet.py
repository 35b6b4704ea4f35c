"""ResNet-18/34 trunks with torchvision's module names (counterpart of
``pixelnerf_tpu/models/resnet.py``).

Parameters keep torchvision's state_dict names (``conv1``, ``bn1``,
``layer{k}.{j}.conv1``, ``downsample.0/1``) so the weight bridge is a
mechanical key map. Parameters stay float32; the convolutions and batch
norms run in the module's compute ``dtype``. Convolutions run NCHW
internally; the public input and outputs are NHWC like the JAX package's.
"""
from __future__ import annotations

from typing import List

import torch
import torch.nn as nn
import torch.nn.functional as F

BN_EPS = 1e-5


def max_pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    """``MaxPool2d(kernel_size=3, stride=2, padding=1)`` (NCHW here)."""
    return F.max_pool2d(x, kernel_size=3, stride=2, padding=1)


class Conv2d(nn.Conv2d):
    """Bias-free conv whose float32 weight is cast to the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.weight.to(x.dtype), None, self.stride, self.padding)


class BatchNorm2d(nn.BatchNorm2d):
    """Batch norm with flax's semantics.

    Inference (``train=False``): running statistics, in the input's dtype.
    Training: flax's ``_compute_stats``/``_normalize``, which differ from
    torch's ``F.batch_norm(training=True)``: the statistics are reduced in
    float32 even for bf16 input, the variance is the biased
    ``E[x^2] - E[x]^2`` clipped at 0, the running statistics are updated
    as ``0.9 * running + 0.1 * batch`` with that biased variance (torch
    would store the unbiased one), and the normalisation runs in float32
    before the cast back to the input's dtype.

    ``sync_group``: a process group over which training reduces the
    statistics, as flax does under ``jit`` over a batch sharded on a mesh's
    data axis: the sums of x and x^2 and the element count are summed over
    the group's ranks (autograd-aware, so the backward carries the other
    ranks' terms) before the mean and the biased variance are taken. None
    (the default): this process's batch alone. ``parallel.mesh`` sets it
    for the duration of a sharded train step.
    """

    def __init__(self, features: int):
        super().__init__(features, eps=BN_EPS, momentum=0.1)
        self.sync_group = None

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        dt = x.dtype
        if not train:
            return F.batch_norm(
                x, self.running_mean.to(dt), self.running_var.to(dt),
                self.weight.to(dt), self.bias.to(dt), False, 0.0, self.eps,
            )
        xf = x.float()
        if self.sync_group is None:
            mean = xf.mean(dim=(0, 2, 3))
            var = xf.square().mean(dim=(0, 2, 3)) - mean.square()
        else:
            from torch.distributed.nn.functional import all_reduce

            count = xf.new_full((1,), xf.numel() // xf.shape[1])
            sums = all_reduce(torch.cat([xf.sum(dim=(0, 2, 3)), xf.square().sum(dim=(0, 2, 3)), count]),
                              group=self.sync_group)
            c = xf.shape[1]
            mean = sums[:c] / sums[-1]
            var = sums[c : 2 * c] / sums[-1] - mean.square()
        var = torch.maximum(var, var.new_zeros(()))       # jnp.maximum: ties split the gradient
        with torch.no_grad():
            self.running_mean.mul_(1.0 - self.momentum).add_(self.momentum * mean)
            self.running_var.mul_(1.0 - self.momentum).add_(self.momentum * var)
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]
        return y.to(dt)


def _conv(cin: int, cout: int, kernel: int, stride: int) -> Conv2d:
    return Conv2d(cin, cout, kernel, stride=stride, padding=kernel // 2, bias=False)


class BasicBlock(nn.Module):
    """torchvision BasicBlock: 3x3 -> 3x3 with identity/projection shortcut."""

    def __init__(self, cin: int, features: int, stride: int = 1):
        super().__init__()
        self.conv1 = _conv(cin, features, 3, stride)
        self.bn1 = BatchNorm2d(features)
        self.conv2 = _conv(features, features, 3, 1)
        self.bn2 = BatchNorm2d(features)
        self.downsample = None
        if stride != 1 or cin != features:
            self.downsample = nn.Sequential(_conv(cin, features, 1, stride), BatchNorm2d(features))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        y = torch.relu(self.bn1(self.conv1(x), train))
        y = self.bn2(self.conv2(y), train)
        identity = x
        if self.downsample is not None:
            conv, bn = self.downsample
            identity = bn(conv(x), train)
        return torch.relu(y + identity)


STAGE_SIZES = {"resnet18": (2, 2, 2, 2), "resnet34": (3, 4, 6, 3)}
STAGE_FEATURES = (64, 128, 256, 512)


def _stage(cin: int, features: int, num_blocks: int, stride: int) -> nn.Sequential:
    blocks = [BasicBlock(cin, features, stride)]
    blocks += [BasicBlock(features, features, 1) for _ in range(num_blocks - 1)]
    return nn.Sequential(*blocks)


class ResNetFeatures(nn.Module):
    """Truncated ResNet trunk returning per-stage feature maps:
    [post-stem, layer1, ..., layer{num_layers-1}], as the reference consumes
    them. ``use_first_pool=False`` skips the stem maxpool."""

    def __init__(
        self,
        backbone: str = "resnet34",
        num_layers: int = 4,
        use_first_pool: bool = True,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        sizes = STAGE_SIZES[backbone]
        self.num_layers = num_layers
        self.use_first_pool = use_first_pool
        self.dtype = dtype
        self.conv1 = _conv(3, 64, 7, 2)
        self.bn1 = BatchNorm2d(64)
        cin = 64
        for k in range(1, min(num_layers, 5)):
            stride = 1 if k == 1 else 2
            self.add_module(f"layer{k}", _stage(cin, STAGE_FEATURES[k - 1], sizes[k - 1], stride))
            cin = STAGE_FEATURES[k - 1]

    def forward(self, x_nhwc: torch.Tensor, train: bool = False) -> List[torch.Tensor]:
        """:param x_nhwc: (B, H, W, 3) -> list of (B, h, w, c) float32 maps
        :param train: batch norms in training mode (batch statistics, running
            statistics updated)"""
        x = x_nhwc.permute(0, 3, 1, 2).to(self.dtype)
        x = torch.relu(self.bn1(self.conv1(x), train))
        latents = [x]
        for k in range(1, min(self.num_layers, 5)):
            if k == 1 and self.use_first_pool:
                x = max_pool_3x3_s2(x)
            for block in getattr(self, f"layer{k}"):
                x = block(x, train)
            latents.append(x)
        return [lat.permute(0, 2, 3, 1).float() for lat in latents]


class ResNetTrunk(nn.Module):
    """The full trunk through layer4 with the stem's max pool, then the
    mean over H and W: (B, H, W, 3) -> (B, 512), for the global image
    encoder. Float32 whatever the model's dtype, as in the JAX package
    (its ``ResNetTrunk`` takes no dtype)."""

    def __init__(self, backbone: str = "resnet34"):
        super().__init__()
        sizes = STAGE_SIZES[backbone]
        self.conv1 = _conv(3, 64, 7, 2)
        self.bn1 = BatchNorm2d(64)
        cin = 64
        for k in range(1, 5):
            self.add_module(f"layer{k}", _stage(cin, STAGE_FEATURES[k - 1], sizes[k - 1], 1 if k == 1 else 2))
            cin = STAGE_FEATURES[k - 1]

    def forward(self, x_nhwc: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = x_nhwc.permute(0, 3, 1, 2).float()
        x = max_pool_3x3_s2(torch.relu(self.bn1(self.conv1(x), train)))
        for k in range(1, 5):
            for block in getattr(self, f"layer{k}"):
                x = block(x, train)
        return x.mean(dim=(2, 3))
