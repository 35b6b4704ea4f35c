"""Image encoders and the latent lookup (counterpart of
``pixelnerf_tpu/models/encoder.py``): the pixel-aligned ``SpatialEncoder``
(a truncated ResNet, or the ``ConvEncoder`` of ``backbone = custom``) and
the global ``ImageEncoder``.

``SpatialEncoder.forward`` returns the latent instead of caching it, and the
pixel-aligned lookup is the free function :func:`index_latent` on it. For
bilinear/border lookup :func:`index_latent` goes through a gather kernel:
kernel A (``ops/gather.py``) for inference, kernel C with its backward
(``ops/gather_rows.py``) for training; the other modes use the plain
``grid_sample``.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.gather import gather_bilerp, gather_bilerp_plain
from ..ops.gather_rows import GatherRowsLerp
from ..ops.grid_sample import _compute_source_index, bilinear_corners, bilinear_pair_bases, grid_sample
from ..ops.resize import resize_area, resize_bilinear
from ..utils.geometry import device_vector
from .resnet import ResNetFeatures, ResNetTrunk


def latent_scaling(latent_h: int, latent_w: int, device=None) -> torch.Tensor:
    """Pixel->grid scaling constants, (2,) [sx, sy]: ``s = size/(size-1) * 2``
    per axis, the align_corners=True convention relating original-image
    pixel coordinates to the latent's [-1, 1] grid. Filled on ``device``
    (``torch.tensor`` of a list, or an element set from a Python number,
    would copy from the host and wait for the device once per lookup)."""
    return device_vector((latent_w / (latent_w - 1) * 2.0, latent_h / (latent_h - 1) * 2.0), device)


def index_latent(
    latent: torch.Tensor,
    uv: torch.Tensor,
    image_shape: Optional[torch.Tensor] = None,
    interp: str = "bilinear",
    padding: str = "border",
    out_dtype: torch.dtype = torch.float32,
    use_kernels: bool = True,
    differentiable: bool = False,
) -> torch.Tensor:
    """Pixel-aligned feature lookup.

    :param latent: (N, Hl, Wl, C) encoder output
    :param uv: (Ng, P, 2) query points, (x, y) in original-image pixel
        coordinates if ``image_shape`` is given, else already in [-1, 1];
        Ng == N, or N == 1
    :param image_shape: (2,) [W, H] of the original image, or None
    :param out_dtype: dtype of the result (the consumer's compute dtype)
    :param use_kernels: bilinear/border goes through the CUDA kernels (for
        CUDA tensors) if True, else through their plain versions; a
        caller-side choice, used to compare the two on the card
    :param differentiable: bilinear/border goes through
        :class:`GatherRowsLerp` (kernel C and its backward), with gradients
        for the latent and, through the corner weights, for ``uv``; else
        through :func:`gather_bilerp` (kernel A, inference only)
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
    # fold the view index into the row index of one flat table
    off = None
    if N > 1:
        off = torch.arange(Ng, device=uv.device, dtype=torch.int32)[:, None, None] * (Hl * Wl)
    if differentiable:
        idx, w = bilinear_corners(ix, iy, Hl, Wl)                  # (Ng, P, 4)
        if off is not None:
            idx = idx + off
        out = GatherRowsLerp.apply(
            latent.reshape(N * Hl * Wl, C),
            idx.reshape(-1, 4).contiguous(),
            w.reshape(-1, 4).contiguous(),
            out_dtype,
            use_kernels,
        )
        return out.reshape(Ng, P, C)
    base, w = bilinear_pair_bases(ix, iy, Hl, Wl)                  # (Ng, P, 2)
    if off is not None:
        base = base + off
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
    ``backbone = custom`` runs the :class:`ConvEncoder` instead (a
    128-channel map at the input's resolution). ``feature_scale`` resizes
    the input first: ``round(H * feature_scale)``, bilinear with
    align_corners above 1, area below.
    """

    def __init__(
        self,
        backbone: str = "resnet34",
        num_layers: int = 4,
        use_first_pool: bool = True,
        index_interp: str = "bilinear",
        index_padding: str = "border",
        feature_scale: float = 1.0,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        if backbone not in ("resnet18", "resnet34", "custom"):
            raise NotImplementedError(f"unknown backbone {backbone!r}")
        self.backbone = backbone
        self.num_layers = num_layers
        self.index_interp = index_interp
        self.index_padding = index_padding
        self.feature_scale = feature_scale
        if backbone == "custom":
            # float32 whatever the model's dtype: the JAX package passes its
            # dtype to the ResNet only
            self.model = ConvEncoder()
        else:
            self.model = ResNetFeatures(backbone, num_layers, use_first_pool, dtype)

    @property
    def latent_size(self) -> int:
        if self.backbone == "custom":
            return 128
        return [0, 64, 128, 256, 512, 1024][self.num_layers]

    def scaled_size(self, h: int, w: int) -> tuple:
        """The size the backbone sees for an (h, w) image."""
        if self.feature_scale == 1.0:
            return h, w
        return int(round(h * self.feature_scale)), int(round(w * self.feature_scale))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """:param x: (B, H, W, 3) images in [-1, 1] -> (B, H', W', latent_size)
        :param train: the trunk's batch norms in training mode"""
        if self.feature_scale != 1.0:
            h, w = self.scaled_size(*x.shape[1:3])
            if self.feature_scale > 1.0:
                x = resize_bilinear(x, h, w, align_corners=True)
            else:
                x = resize_area(x, h, w)
        if self.backbone == "custom":
            return self.model(x)
        latents = self.model(x, train)
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
        return cls(
            backbone=conf.get_string("backbone", "resnet34"),
            num_layers=conf.get_int("num_layers", 4),
            use_first_pool=conf.get_bool("use_first_pool", True),
            index_interp=conf.get_string("index_interp", "bilinear"),
            index_padding=conf.get_string("index_padding", "border"),
            feature_scale=conf.get_float("feature_scale", 1.0),
            dtype=getattr(torch, conf.get_string("dtype", "float32")),
        )


class ImageEncoder(nn.Module):
    """Global image encoder: the full ResNet trunk and its mean over the
    image -> (B, latent_size), through ``fc`` unless latent_size is 512.
    Float32 in a model of any dtype (the JAX package's ``ImageEncoder``
    ignores the ``dtype`` pushed into its config)."""

    def __init__(self, backbone: str = "resnet34", latent_size: int = 128):
        super().__init__()
        self.latent_size = latent_size
        self.model = ResNetTrunk(backbone)
        self.fc = nn.Linear(512, latent_size) if latent_size != 512 else None

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        z = self.model(x, train)
        return self.fc(z) if self.fc is not None else z

    @staticmethod
    def index(latent: torch.Tensor, n_queries: int) -> torch.Tensor:
        """(B, L) -> (B, n_queries, L): the global vector for every query
        point."""
        return latent[:, None, :].expand(latent.shape[0], n_queries, latent.shape[1])

    @classmethod
    def from_conf(cls, conf) -> "ImageEncoder":
        return cls(
            backbone=conf.get_string("backbone", "resnet34"),
            latent_size=conf.get_int("latent_size", 128),
        )


def _same_pad(x: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """TensorFlow-SAME reflect padding before a VALID conv (NCHW)."""
    h, w = x.shape[2:]
    pad_h = max((-(-h // stride) - 1) * stride + kernel - h, 0)
    pad_w = max((-(-w // stride) - 1) * stride + kernel - w, 0)
    return F.pad(x, (pad_w // 2, pad_w - pad_w // 2, pad_h // 2, pad_h - pad_h // 2), mode="reflect")


def _same_unpad_deconv(x: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """The crop after a transposed conv (NCHW)."""
    h_scaled = (x.shape[2] - 1) * stride
    w_scaled = (x.shape[3] - 1) * stride
    pad_h = max((-(-h_scaled // stride) - 1) * stride + kernel - h_scaled, 0)
    pad_w = max((-(-w_scaled // stride) - 1) * stride + kernel - w_scaled, 0)
    top, left = pad_h // 2, pad_w // 2
    return x[:, :, top : x.shape[2] - (pad_h - top), left : x.shape[3] - (pad_w - left)]


class ConvTranspose(nn.Module):
    """flax's ``ConvTranspose(padding="VALID")``: ``lax.conv_transpose``, a
    correlation of the stride-dilated input with the kernel as it is. Its
    ``weight`` (out, in, kh, kw) is the flax kernel (kh, kw, in, out) as
    the weight bridge lays out every 4-D kernel; ``F.conv_transpose2d``
    takes (in, out, kh, kw) and correlates with the kernel flipped, so the
    forward hands it the weight flipped in space with in and out swapped."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int, bias: bool):
        super().__init__()
        self.stride = stride
        self.weight = nn.Parameter(torch.empty(cout, cin, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose2d(x, self.weight.flip(2, 3).transpose(0, 1), self.bias, self.stride)


class ConvEncoder(nn.Module):
    """The experimental 3-down/3-up conv encoder with skip concats
    (``backbone = custom``): reflect-SAME convs, GroupNorm(32) with flax's
    epsilon 1e-6, leaky ReLU, float32. (B, H, W, 3) -> (B, H, W, 128) for
    H, W multiples of 16.

    ``conv_mid``'s output is flattened into channels and broadcast back out,
    so ``deconv2_conv``'s input width depends on the image size (at 128x128
    a 2x2 map: 512 channels; at 64x64 and below: 128). That layer is made
    for an image size (H, W) by :meth:`build_for` (``make_model(...,
    image_size=...)``), or by loading a state_dict that holds it (its width
    says the map's); a call raises while it is missing, and an image whose
    map has another width raises.
    """

    TOP_SKIP = 512     # channels of conv2's output, concatenated before deconv2

    def __init__(self):
        super().__init__()
        for name, cin, cout, kernel, stride in (("conv_in", 3, 64, 7, 2), ("conv0", 64, 128, 3, 2),
                                                ("conv1", 128, 256, 3, 2), ("conv2", 256, 512, 3, 2),
                                                ("conv_mid", 512, 128, 4, 4)):
            setattr(self, f"{name}_conv", nn.Conv2d(cin, cout, kernel, stride=stride, bias=False))
            setattr(self, f"{name}_norm", nn.GroupNorm(32, cout, eps=1e-6))
        # deconv{i}: the layer above's output and the skip of conv{i} -> 64 * 2**i
        self.deconv2_conv = None      # its input: the flattened mid map + 512
        self.deconv1_conv = ConvTranspose(512, 128, 3, 2, bias=False)
        self.deconv0_conv = ConvTranspose(256, 64, 3, 2, bias=False)
        for i in range(3):
            setattr(self, f"deconv{i}_norm", nn.GroupNorm(32, 64 * 2**i, eps=1e-6))
        self.deconv_last = ConvTranspose(64, 128, 3, 2, bias=True)

    @staticmethod
    def mid_channels(h: int, w: int) -> int:
        """Channels of the flattened mid map for an (h, w) input: the
        strides 2, 2, 2, 2 and 4 of SAME convs leave ceil(h/64) x ceil(w/64)
        pixels of 128 channels."""
        return 128 * -(-h // 64) * -(-w // 64)

    def _make_top(self, mid: int) -> ConvTranspose:
        top = ConvTranspose(mid + self.TOP_SKIP, 256, 3, 2, bias=False)
        self.deconv2_conv = top.to(self.conv_in_conv.weight.device)
        return self.deconv2_conv

    def build_for(self, h: int, w: int) -> None:
        """Make ``deconv2_conv`` for (h, w) inputs, its weights uninitialised
        as its siblings' are until ``init_weights`` draws them."""
        self._make_top(self.mid_channels(h, w))

    def adopt(self, state_dict, prefix: str = "") -> None:
        """Make ``deconv2_conv``, if it is missing, at the width that
        ``state_dict`` holds for it (under ``prefix``)."""
        key = f"{prefix}deconv2_conv.weight"
        if self.deconv2_conv is None and key in state_dict:
            self._make_top(state_dict[key].shape[1] - self.TOP_SKIP)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        self.adopt(state_dict, prefix)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def _conv_block(self, y: torch.Tensor, name: str) -> torch.Tensor:
        conv = getattr(self, f"{name}_conv")
        y = F.conv2d(_same_pad(y, conv.kernel_size[0], conv.stride[0]), conv.weight, None, conv.stride)
        return F.leaky_relu(getattr(self, f"{name}_norm")(y))

    def forward(self, x_nhwc: torch.Tensor) -> torch.Tensor:
        x = x_nhwc.permute(0, 3, 1, 2).float()
        x = self._conv_block(x, "conv_in")
        inters = []
        for i in range(3):
            x = self._conv_block(x, f"conv{i}")
            inters.append(x)
        x = self._conv_block(x, "conv_mid")
        # the (h, w, c) map flattened in NHWC order, broadcast over the last skip's extent
        n = x.shape[0]
        x = x.permute(0, 2, 3, 1).reshape(n, -1, 1, 1)
        if self.deconv2_conv is None:
            raise ValueError("ConvEncoder: build_for(H, W) (make_model(image_size=...)) or load weights first")
        want = self.deconv2_conv.weight.shape[1] - self.TOP_SKIP
        if x.shape[1] != want:
            raise ValueError(f"ConvEncoder was made for a mid map of {want} channels, "
                             f"this image gives {x.shape[1]}")
        x = x.expand(n, x.shape[1], *inters[-1].shape[2:])
        for i in reversed(range(3)):
            x = torch.cat([x, inters[i]], dim=1)
            x = _same_unpad_deconv(getattr(self, f"deconv{i}_conv")(x), 3, 2)
            x = F.leaky_relu(getattr(self, f"deconv{i}_norm")(x))
        x = _same_unpad_deconv(self.deconv_last(x), 3, 2)
        return x.permute(0, 2, 3, 1)
