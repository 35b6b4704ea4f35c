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
- ``lin_z_{i}``                -> ``lin_z.{i}``
"""
from __future__ import annotations

import re
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn as nn


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
        elif re.match(r"^lin_z_\d+$", p):
            out.extend(["lin_z", p.rsplit("_", 1)[1]])
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
        k: torch.from_numpy(np.ascontiguousarray(v, dtype=np.float32))
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
