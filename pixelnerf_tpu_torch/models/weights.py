"""The weight bridge: JAX package variables -> the port's state_dict.

The port keeps its own copy of the mapping that
``pixelnerf_tpu/models/torch_import.py`` implements (it imports nothing of
that package). Input is the flax ``{'params': ..., 'batch_stats': ...}``
tree as nested dicts of numpy arrays. Layout transforms:

- conv kernel (kh, kw, I, O)   -> weight (O, I, kh, kw)
- dense kernel (I, O)          -> weight (O, I)
- batch norm scale / bias      -> weight / bias
- batch norm mean / var        -> running_mean / running_var
- ``block{i}`` under ``layer{k}`` -> ``layer{k}.{i}``, elsewhere ``blocks.{i}``
- ``downsample_conv`` / ``downsample_bn`` -> ``downsample.0`` / ``downsample.1``
- ``lin_z_{i}`` / ``scale_z_{i}`` -> ``lin_z.{i}`` / ``scale_z.{i}``
- group norm scale / bias      -> weight / bias

Every 4-D kernel takes the conv transform, the custom conv encoder's
transposed convs (``deconv*``) included, as the JAX package's
``torch_import`` does; the port's ``ConvTranspose`` keeps its weight in that
layout and computes flax's ``ConvTranspose`` from it
(``models/encoder.py``).

:func:`from_jax_opt_state` carries an optax Adam state's moments through
the same map into a ``torch.optim.Adam`` state dict.

:func:`load_reference_state_dict` loads the reference implementation's
``pixel_nerf_latest`` state_dict (the port's modules use its module paths),
:func:`export_state_dict` writes one, and :func:`load_pretrained_encoder`
a torchvision ResNet state_dict into the encoder's trunk.
"""
from __future__ import annotations

import re
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn as nn

from .encoder import ConvEncoder


def _flatten(tree: Dict, prefix=()) -> Dict[Tuple[str, ...], np.ndarray]:
    flat = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            flat.update(_flatten(v, prefix + (k,)))
        else:
            flat[prefix + (k,)] = np.asarray(v)
    return flat


def _module_path(path) -> str:
    """flax scope path -> torch dotted module path."""
    out = []
    for p in path:
        if re.match(r"^block\d+$", p) and out and re.match(r"^layer\d+$", out[-1]):
            out.append(p[len("block"):])
        elif re.match(r"^block\d+$", p):
            out.extend(["blocks", p[len("block"):]])
        elif p == "downsample_conv":
            out.extend(["downsample", "0"])
        elif p == "downsample_bn":
            out.extend(["downsample", "1"])
        elif re.match(r"^(lin_z|scale_z)_\d+$", p):
            out.extend(p.rsplit("_", 1))
        else:
            out.append(p)
    return ".".join(out)


def from_jax_variables(variables: Dict[str, Dict]) -> Dict[str, torch.Tensor]:
    """flax variables (nested numpy arrays) -> the port's state_dict
    (float32 CPU tensors; ``num_batches_tracked`` is not produced)."""
    out: Dict[str, torch.Tensor] = {}
    for path, value in _flatten(variables.get("params", {})).items():
        name, leaf = _module_path(path[:-1]), path[-1]
        if leaf == "kernel":
            value = value.transpose(3, 2, 0, 1) if value.ndim == 4 else value.T
            out[f"{name}.weight"] = value
        elif leaf == "scale":
            out[f"{name}.weight"] = value
        elif leaf == "bias":
            out[f"{name}.bias"] = value
        else:
            raise ValueError(f"unrecognized param leaf: {path}")
    for path, value in _flatten(variables.get("batch_stats", {})).items():
        name, leaf = _module_path(path[:-1]), path[-1]
        stat = {"mean": "running_mean", "var": "running_var"}.get(leaf)
        if stat is None:
            raise ValueError(f"unrecognized batch_stats leaf: {path}")
        out[f"{name}.{stat}"] = value
    return {
        k: torch.from_numpy(np.array(v, dtype=np.float32))
        for k, v in out.items()
    }


def load_jax_variables(model: nn.Module, variables: Dict[str, Dict]) -> None:
    """Load JAX package variables into ``model``; raises unless every
    parameter and running statistic is covered and nothing is left over."""
    result = model.load_state_dict(from_jax_variables(variables), strict=False)
    missing = [k for k in result.missing_keys if not k.endswith("num_batches_tracked")]
    if missing or result.unexpected_keys:
        raise ValueError(
            f"weight bridge mismatch: missing {missing}, unexpected {result.unexpected_keys}"
        )


def from_jax_opt_state(adam, model: nn.Module, optimizer: torch.optim.Optimizer) -> Dict:
    """An optax Adam state (``ScaleByAdamState``: ``mu``, ``nu``, ``count``;
    ``opt_state[0]`` of ``optax.adam``) as a ``torch.optim.Adam`` state dict
    for ``optimizer`` over ``model``'s parameters: the moments go through
    the same key map and layout transforms as the parameters, so a JAX
    train state continues in the port. Pass the result to
    ``optimizer.load_state_dict``."""
    mu = from_jax_variables({"params": adam.mu})
    nu = from_jax_variables({"params": adam.nu})
    names = {id(p): n for n, p in model.named_parameters()}
    sd = optimizer.state_dict()
    step = torch.tensor(float(np.asarray(adam.count)))
    state = {}
    index = 0
    for group in optimizer.param_groups:
        for p in group["params"]:
            name = names[id(p)]
            if name not in mu:
                raise ValueError(f"the optax state has no moments for {name}")
            state[index] = {"step": step.clone(), "exp_avg": mu[name], "exp_avg_sq": nu[name]}
            index += 1
    return {"state": state, "param_groups": sd["param_groups"]}


# persistent buffers of the reference's modules that the port does not keep:
# the positional code's tables (recomputed from the config, and held to it
# below) and the conditioning state the reference caches on its modules
REFERENCE_BUFFERS = {"poses", "image_shape", "focal", "c", "latent", "latent_scaling", "_freqs", "_phases"}
_TRUNK_STAGE = re.compile(r"^encoder\.model\.(?:layer(\d+)|fc)\.")


def load_reference_state_dict(model: nn.Module, state_dict: Dict[str, torch.Tensor]) -> List[str]:
    """Load a reference ``pixel_nerf_latest`` state_dict into the port's
    ``PixelNeRFNet`` (strictly: every parameter and running statistic must
    be there with its shape). Keys the port has no place for are accounted
    for by name and returned; any other raises:

    - the reference's buffers in ``REFERENCE_BUFFERS`` (``code._freqs`` and
      ``code._phases`` must equal the port's positional code);
    - the trunk's stages the truncated encoder does not run (torchvision's
      ``layer{k}`` for k >= ``num_layers``, ``fc``);
    - ``num_batches_tracked`` the port's batch norms do not have.

    ``num_batches_tracked`` missing from the file (a checkpoint exported
    by the JAX package) keeps the model's value. A custom conv encoder's
    layer whose width depends on the image size is made at the file's."""
    for name, mod in model.named_modules():
        if isinstance(mod, ConvEncoder):
            mod.adopt(state_dict, f"{name}.")
    own = model.state_dict()
    load, skipped, unexpected = {}, [], []
    for key, value in state_dict.items():
        leaf = key.rsplit(".", 1)[-1]
        stage = _TRUNK_STAGE.match(key)
        if key in own:
            load[key] = torch.as_tensor(value)
        elif leaf in REFERENCE_BUFFERS or leaf == "num_batches_tracked":
            if leaf in ("_freqs", "_phases"):
                code = getattr(model, "code", None)
                want = None if code is None else code.tables()[leaf == "_phases"]
                got = np.asarray(torch.as_tensor(value).float().reshape(-1))
                if want is None or got.shape != want.shape or not np.allclose(got, want, rtol=1e-6, atol=0):
                    raise ValueError(f"{key} does not match the model's positional code")
            skipped.append(key)
        elif stage and (stage.group(1) is None or int(stage.group(1)) >= model.encoder.num_layers):
            skipped.append(key)
        else:
            unexpected.append(key)
    missing = [k for k in own if k not in load and not k.endswith("num_batches_tracked")]
    if missing or unexpected:
        raise ValueError(f"reference checkpoint mismatch: missing {missing}, unexpected {unexpected}")
    model.load_state_dict({**own, **load}, strict=True)
    return skipped


# the tensors a reference checkpoint holds of each layer: conv and linear
# weights and biases, batch norm scale, shift and running statistics
_EXPORTED_LEAVES = ("weight", "bias", "running_mean", "running_var")


def export_state_dict(state_dict: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The port's model state_dict as a reference ``pixel_nerf_latest``
    state_dict, the inverse of :func:`load_reference_state_dict`: every
    parameter and running statistic under its module path (the reference's),
    as the JAX package's ``export_state_dict`` writes it, and no key of the
    port's alone (``num_batches_tracked``)."""
    return {k: v.detach().cpu() for k, v in state_dict.items() if k.rsplit(".", 1)[-1] in _EXPORTED_LEAVES}


def load_pretrained_encoder(model: nn.Module, state_dict: Dict[str, torch.Tensor]) -> None:
    """Initialise the encoder's trunk (``model.encoder.model``) from a
    torchvision ResNet state_dict (ImageNet weights, as the reference
    starts from). Only the tensors the trunk has are taken (a
    ``num_layers`` < 5 encoder ignores the deeper stages and ``fc``); a
    missing tensor or a shape mismatch raises with its name."""
    if "state_dict" in state_dict:         # a training script's {"state_dict": ...} wrapper
        state_dict = state_dict["state_dict"]
    trunk = model.encoder.model
    own = trunk.state_dict()
    new = {}
    for key, value in own.items():
        if key not in state_dict:
            if key.endswith("num_batches_tracked"):
                continue
            raise ValueError(f"pretrained encoder missing tensor {key}")
        src = torch.as_tensor(state_dict[key])
        if tuple(src.shape) != tuple(value.shape):
            raise ValueError(
                f"pretrained encoder shape mismatch at {key}: {tuple(src.shape)} vs model {tuple(value.shape)}"
            )
        new[key] = src
    trunk.load_state_dict({**own, **new}, strict=True)
