"""Model construction from config trees (counterpart of
``pixelnerf_tpu/models/factory.py`` ``make_model``, ResnetFC only)."""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn

from ..config import ConfigNode
from .code import PositionalEncoding
from .encoder import SpatialEncoder
from .pixelnerf import PixelNeRFNet
from .resnetfc import ResnetFC


def make_mlp(conf, d_in: int, d_latent: int = 0, allow_empty: bool = False):
    mlp_type = conf.get_string("type", "mlp")
    if mlp_type == "resnet":
        return ResnetFC.from_conf(conf, d_in, d_latent=d_latent)
    if mlp_type == "empty" and allow_empty:
        return None
    raise NotImplementedError(f"MLP type {mlp_type!r} is not ported yet")


def make_encoder(conf) -> SpatialEncoder:
    enc_type = conf.get_string("type", "spatial")
    if enc_type != "spatial":
        raise NotImplementedError(f"encoder type {enc_type!r} is not ported yet")
    return SpatialEncoder.from_conf(conf)


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """The JAX package's initialisation, drawn from ``generator``: kaiming
    normal (fan_in) for convs and linears, zero biases, identity batch
    norms, and zero ``fc_1`` weights (each residual block starts as the
    identity)."""
    for name, mod in model.named_modules():
        if isinstance(mod, (nn.Conv2d, nn.Linear)):
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


def make_model(
    conf,
    device="cuda",
    generator: Optional[torch.Generator] = None,
    stop_encoder_grad: bool = False,
) -> PixelNeRFNet:
    """Build a PixelNeRFNet from a 'model' config subtree, initialised from
    ``generator`` (a CPU ``torch.Generator``; seed 0 if None), in eval mode,
    on ``device``.

    A model-level ``dtype`` (``bfloat16`` or ``float32``) is pushed into the
    encoder and MLP subtrees as their compute dtype and is the storage dtype
    of the encoded latent; parameters stay float32. ``stop_encoder_grad``
    detaches the gathered features (a frozen encoder, ``--freeze_enc``).
    """
    if conf.get_string("type", "pixelnerf") != "pixelnerf":
        raise NotImplementedError(f"model type {conf.get_string('type')!r}")
    if conf.get_bool("use_global_encoder", False):
        raise NotImplementedError("the global encoder is not ported yet")
    dtype = conf.get("dtype", None)
    if dtype is not None:
        for sub in ("encoder", "mlp_coarse", "mlp_fine"):
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
        use_encoder=use_encoder,
        use_xyz=use_xyz,
        normalize_z=conf.get_bool("normalize_z", True),
        use_code_viewdirs=use_code_viewdirs,
        use_viewdirs=use_viewdirs,
        stop_encoder_grad=stop_encoder_grad,
        latent_dtype=getattr(torch, dtype) if dtype is not None else torch.float32,
    )
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    init_weights(net, generator)
    return net.to(device).eval()
