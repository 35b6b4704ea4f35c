"""The system under test, ``pixelnerf_tpu_torch``, built from a
configuration file: its model (``make_model``), renderer configuration and
training step, with the benchmark's weights loaded."""
from __future__ import annotations

import torch


def model_conf(config: dict, dtype: str = None):
    from pixelnerf_tpu_torch.config import ConfigNode

    m = config["model"]
    mlp = dict(m["mlp"])
    conf = {
        "type": "pixelnerf", "use_encoder": m["use_encoder"], "use_global_encoder": False,
        "use_xyz": m["use_xyz"], "normalize_z": m["normalize_z"], "use_code": m["use_code"],
        "code": dict(m["code"]), "use_viewdirs": m["use_viewdirs"], "use_code_viewdirs": m["use_code_viewdirs"],
        "mlp_coarse": dict(mlp), "mlp_fine": dict(mlp),
        "encoder": {k: v for k, v in m["encoder"].items() if k != "latent_size"} | {"type": "spatial"},
    }
    if dtype is not None and dtype != "float32":
        conf["dtype"] = dtype
    return _node(conf, ConfigNode)


def _node(d, cls):
    return cls({k: _node(v, cls) if isinstance(v, dict) else v for k, v in d.items()})


def build_net(config: dict, dtype: str, device, weights: dict):
    """The program's model with the benchmark's weights (strict: every name
    and shape must match)."""
    from pixelnerf_tpu_torch.models import make_model

    net = make_model(model_conf(config, dtype), device=device)
    net.load_state_dict({k: v.to(device) for k, v in weights.items()}, strict=True)
    return net


def render_config(config: dict):
    from pixelnerf_tpu_torch.render import RenderConfig

    r = config["renderer"]
    return RenderConfig(n_coarse=r["n_coarse"], n_fine=r["n_fine"], n_fine_depth=r["n_fine_depth"],
                        noise_std=r["noise_std"], depth_std=r["depth_std"], white_bkgd=r["white_bkgd"],
                        lindisp=r["lindisp"])


def draws(gen: torch.Generator, lead: tuple, renderer: dict, device) -> dict:
    """The render's random numbers for rays of shape ``lead``, in the
    program's documented layout (``render/renderer.py``): the coarse bins'
    jitter, the importance samples' CDF positions and jitter, the depth
    samples' normals."""
    n_imp = renderer["n_fine"] - renderer["n_fine_depth"]
    kw = dict(generator=gen, device=device)
    out = {"coarse": torch.rand(lead + (renderer["n_coarse"],), **kw)}
    if n_imp > 0:
        out["fine_u"] = torch.rand(lead + (n_imp,), **kw)
        out["fine_jitter"] = torch.rand(lead + (n_imp,), **kw)
    if renderer["n_fine_depth"] > 0:
        out["depth"] = torch.randn(lead + (renderer["n_fine_depth"],), **kw)
    return out


def counters(since: dict = None) -> dict:
    """The program's kernel launch counters (the ``.launches`` of its kernel
    wrappers), or their growth since ``since``."""
    import importlib

    now = {}
    for module, fn in (("gather", "gather_bilerp"), ("fused_mlp", "fused_resnetfc_infer"),
                       ("fused_field", "fused_gather_resnetfc_infer"), ("gather_rows", "gather_rows_lerp"),
                       ("gather_rows", "gather_rows_lerp_bwd")):
        try:
            now[fn] = getattr(getattr(importlib.import_module(f"pixelnerf_tpu_torch.ops.{module}"), fn), "launches")
        except (ImportError, AttributeError):
            continue
    if since is None:
        return now
    return {k: v - since.get(k, 0) for k, v in now.items()}
