"""Model construction from config trees (counterpart of
``pixelnerf_tpu/models/factory.py``): ``make_mlp`` (``mlp`` | ``resnet`` |
``empty``), ``make_encoder`` (``spatial`` | ``global``), ``make_model``, and
the initialisation ``init_weights``."""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn

from ..config import ConfigNode
from .code import PositionalEncoding
from .encoder import ConvEncoder, ConvTranspose, ImageEncoder, SpatialEncoder
from .mlp import ImplicitNet
from .pixelnerf import PixelNeRFNet
from .resnetfc import ResnetFC


def make_mlp(conf, d_in: int, d_latent: int = 0, allow_empty: bool = False):
    mlp_type = conf.get_string("type", "mlp")
    if mlp_type == "mlp":
        return ImplicitNet.from_conf(conf, d_in + d_latent)
    if mlp_type == "resnet":
        return ResnetFC.from_conf(conf, d_in, d_latent=d_latent)
    if mlp_type == "empty" and allow_empty:
        return None
    raise NotImplementedError(f"Unsupported MLP type {mlp_type!r}")


def make_encoder(conf):
    enc_type = conf.get_string("type", "spatial")
    if enc_type == "spatial":
        return SpatialEncoder.from_conf(conf)
    if enc_type == "global":
        return ImageEncoder.from_conf(conf)
    raise NotImplementedError(f"Unsupported encoder type {enc_type!r}")


@torch.no_grad()
def lecun_normal_(weight: torch.Tensor, generator: torch.Generator) -> None:
    """flax's default kernel init, ``lecun_normal``: a normal of variance
    1/fan_in truncated at two standard deviations (and rescaled to keep
    that variance), drawn by the inverse CDF from ``generator``."""
    fan_in = weight[0].numel()
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    u = lo + (1.0 - 2.0 * lo) * torch.rand(weight.shape, generator=generator, dtype=torch.float64)
    x = torch.erfinv(2.0 * u - 1.0) * math.sqrt(2.0)
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    weight.copy_((x * std).to(weight.dtype))


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """The JAX package's initialisation, drawn from ``generator``: kaiming
    normal (fan_in) for the ResNets' convs and the linears, zero biases,
    identity batch and group norms, zero ``fc_1`` weights (each residual
    block starts as the identity); flax's default ``lecun_normal`` for the
    custom conv encoder and the global encoder's ``fc``, which keep it;
    :meth:`ImplicitNet.geometric_init_` for an ImplicitNet that asks for
    it."""
    lecun, done = set(), set()
    for mod in model.modules():
        if isinstance(mod, ConvEncoder):
            lecun.update(m for m in mod.modules() if isinstance(m, (nn.Conv2d, ConvTranspose)))
        elif isinstance(mod, ImageEncoder) and mod.fc is not None:
            lecun.add(mod.fc)
        elif isinstance(mod, ImplicitNet) and mod.geometric_init:
            mod.geometric_init_(generator)
            done.update(mod.modules())
    for name, mod in model.named_modules():
        if mod in done:
            continue
        if mod in lecun:
            lecun_normal_(mod.weight, generator)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, (nn.Conv2d, nn.Linear)):
            fan_in = mod.weight[0].numel()
            std = math.sqrt(2.0 / fan_in)
            w = torch.randn(mod.weight.shape, generator=generator) * std
            if name.endswith("fc_1"):
                w.zero_()
            mod.weight.copy_(w)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, nn.BatchNorm2d):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
            mod.running_mean.zero_()
            mod.running_var.fill_(1.0)
        elif isinstance(mod, nn.GroupNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()


def make_model(
    conf,
    device="cuda",
    generator: Optional[torch.Generator] = None,
    stop_encoder_grad: bool = False,
    image_size: Optional[tuple] = None,
) -> PixelNeRFNet:
    """Build a PixelNeRFNet from a 'model' config subtree, initialised from
    ``generator`` (a CPU ``torch.Generator``; seed 0 if None), in eval mode,
    on ``device``.

    A model-level ``dtype`` (``bfloat16`` or ``float32``) is pushed into the
    encoder, MLP and global-encoder subtrees as their compute dtype and is
    the storage dtype of the encoded latent; parameters stay float32 (the
    global encoder and the custom conv encoder compute in float32, as in the
    JAX package). ``stop_encoder_grad`` detaches the gathered features (a
    frozen encoder, ``--freeze_enc``). ``image_size`` (H, W) of the source
    images makes the custom conv encoder's layer whose width depends on it
    (``ConvEncoder``; needed before training one).
    """
    if conf.get_string("type", "pixelnerf") != "pixelnerf":
        raise NotImplementedError(f"model type {conf.get_string('type')!r}")
    dtype = conf.get("dtype", None)
    if dtype is not None:
        for sub in ("encoder", "mlp_coarse", "mlp_fine", "global_encoder"):
            subconf = conf.get(sub)
            if isinstance(subconf, dict):
                subconf.setdefault("dtype", dtype)

    use_encoder = conf.get_bool("use_encoder", True)
    use_xyz = conf.get_bool("use_xyz", False)
    if not (use_encoder or use_xyz):
        raise ValueError("the model needs the encoder or xyz")
    use_code = conf.get_bool("use_code", False)
    use_code_viewdirs = conf.get_bool("use_code_viewdirs", True)
    use_viewdirs = conf.get_bool("use_viewdirs", False)

    encoder = make_encoder(conf.get_config("encoder", ConfigNode()))
    global_encoder = None
    if conf.get_bool("use_global_encoder", False):
        global_encoder = ImageEncoder.from_conf(conf.get_config("global_encoder", ConfigNode()))
    d_in = 3 if use_xyz else 1
    if use_viewdirs and use_code_viewdirs:
        d_in += 3
    code = None
    if use_code and d_in > 0:
        code = PositionalEncoding.from_conf(conf.get_config("code", ConfigNode()), d_in=d_in)
        d_in = code.d_out
    if use_viewdirs and not use_code_viewdirs:
        d_in += 3
    d_latent = encoder.latent_size if use_encoder else 0
    if global_encoder is not None:
        d_latent += global_encoder.latent_size

    mlp_coarse = make_mlp(conf.get_config("mlp_coarse", ConfigNode()), d_in, d_latent)
    mlp_fine = make_mlp(
        conf.get_config("mlp_fine", ConfigNode({"type": "empty"})), d_in, d_latent,
        allow_empty=True,
    )
    net = PixelNeRFNet(
        encoder=encoder,
        mlp_coarse=mlp_coarse,
        mlp_fine=mlp_fine,
        code=code,
        global_encoder=global_encoder,
        use_encoder=use_encoder,
        use_xyz=use_xyz,
        normalize_z=conf.get_bool("normalize_z", True),
        use_code_viewdirs=use_code_viewdirs,
        use_viewdirs=use_viewdirs,
        stop_encoder_grad=stop_encoder_grad,
        latent_dtype=getattr(torch, dtype) if dtype is not None else torch.float32,
        quad_gather=conf.get_bool("quad_gather", False),
    )
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    if image_size is not None and isinstance(encoder.model, ConvEncoder):
        encoder.model.build_for(*encoder.scaled_size(*image_size))
    init_weights(net, generator)
    return net.to(device).eval()
