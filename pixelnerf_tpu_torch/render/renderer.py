"""Hierarchical volume renderer, coarse + fine (counterpart of
``pixelnerf_tpu/render/renderer.py``).

Semantics kept exactly:

- stratified coarse samples with jittered left-edge bins
- inverse-CDF importance samples from the detached coarse weights, with
  the comparison-count searchsorted
- gaussian depth-jitter samples clamped to [near, far]
- ``alpha = 1 - exp(-delta * relu(sigma))``, transmittance by the cumprod
  of shifted ``(1 - alpha + 1e-10)``, ``delta_inf = far - z_K``, optional
  white background
- the staged fine pass: the fine MLP runs on the cached coarse features and
  on the new samples' features, and the two outputs are merged by one
  stable sort of z with the 4 output channels as payload

Random draws come from an explicit ``torch.Generator``, or are injected as
a dict (``jax.random`` and ``torch.Generator`` cannot agree, so parity
tests hand both sides the same numbers):

- ``"coarse"`` (SB, B, n_coarse) uniform jitter of the coarse bins
- ``"fine_u"`` (SB, B, n_imp) uniform CDF positions of the importance samples
- ``"fine_jitter"`` (SB, B, n_imp) uniform jitter of the importance samples
- ``"depth"`` (SB, B, n_fine_depth) standard normals of the depth samples

where ``n_imp = n_fine - n_fine_depth``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    n_coarse: int = 128
    n_fine: int = 0
    n_fine_depth: int = 0
    depth_std: float = 0.01
    white_bkgd: bool = False

    @property
    def using_fine(self) -> bool:
        return self.n_fine > 0

    @classmethod
    def from_conf(cls, conf, white_bkgd: bool = False) -> "RenderConfig":
        return cls(
            n_coarse=conf.get_int("n_coarse", 128),
            n_fine=conf.get_int("n_fine", 0),
            n_fine_depth=conf.get_int("n_fine_depth", 0),
            depth_std=conf.get_float("depth_std", 0.01),
            white_bkgd=bool(conf.get_float("white_bkgd", white_bkgd)),
        )


def draw_noise(rays: torch.Tensor, cfg: RenderConfig, generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """Draw every random number one ``render_rays`` call needs."""
    lead = rays.shape[:-1]
    kw = dict(generator=generator, device=rays.device, dtype=rays.dtype)
    n_imp = cfg.n_fine - cfg.n_fine_depth
    noise = {"coarse": torch.rand(lead + (cfg.n_coarse,), **kw)}
    if cfg.using_fine and n_imp > 0:
        noise["fine_u"] = torch.rand(lead + (n_imp,), **kw)
        noise["fine_jitter"] = torch.rand(lead + (n_imp,), **kw)
    if cfg.using_fine and cfg.n_fine_depth > 0:
        noise["depth"] = torch.randn(lead + (cfg.n_fine_depth,), **kw)
    return noise


def _z_from_steps(rays: torch.Tensor, z_steps: torch.Tensor) -> torch.Tensor:
    near, far = rays[..., 6:7], rays[..., 7:8]
    return near * (1 - z_steps) + far * z_steps


def sample_coarse(rays: torch.Tensor, cfg: RenderConfig, u: torch.Tensor) -> torch.Tensor:
    """Stratified samples: (..., B, 8) rays -> (..., B, Kc) depths."""
    step = 1.0 / cfg.n_coarse
    z_steps = torch.linspace(0.0, 1.0 - step, cfg.n_coarse, device=rays.device, dtype=rays.dtype)
    return _z_from_steps(rays, z_steps + u * step)


def sample_fine(
    rays: torch.Tensor, weights: torch.Tensor, cfg: RenderConfig,
    u: torch.Tensor, jitter: torch.Tensor,
) -> torch.Tensor:
    """Importance samples from coarse weights: -> (..., B, n_fine - n_fine_depth)."""
    weights = weights.detach() + 1e-5
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)        # (..., Kc+1)
    # searchsorted(cdf, u, right) == count of cdf entries <= u; branchless
    inds = torch.sum((cdf[..., None, :] <= u[..., :, None]).to(rays.dtype), dim=-1) - 1.0
    inds = torch.clamp(inds, min=0.0)
    z_steps = (inds + jitter) / cfg.n_coarse
    return _z_from_steps(rays, z_steps)


def sample_fine_depth(
    rays: torch.Tensor, depth: torch.Tensor, cfg: RenderConfig, normal: torch.Tensor
) -> torch.Tensor:
    """Gaussian jitter around the expected depth: -> (..., B, n_fine_depth)."""
    z = depth[..., None] + normal * cfg.depth_std
    return torch.minimum(torch.maximum(z, rays[..., 6:7]), rays[..., 7:8])


def composite_outputs(
    out: torch.Tensor, rays: torch.Tensor, z_samp: torch.Tensor, cfg: RenderConfig
) -> Dict[str, torch.Tensor]:
    """Compositing on field outputs (SB, B, K, 4) aligned with sorted z."""
    deltas = z_samp[..., 1:] - z_samp[..., :-1]
    delta_inf = rays[..., 7:8] - z_samp[..., -1:]
    deltas = torch.cat([deltas, delta_inf], dim=-1)                    # (SB, B, K)
    rgbs = out[..., :3]
    sigmas = out[..., 3]
    alphas = 1.0 - torch.exp(-deltas * torch.relu(sigmas))
    alphas_shifted = torch.cat(
        [torch.ones_like(alphas[..., :1]), 1.0 - alphas + 1e-10], dim=-1
    )
    T = torch.cumprod(alphas_shifted, dim=-1)                           # (SB, B, K+1)
    weights = alphas * T[..., :-1]
    rgb_final = torch.sum(weights[..., None] * rgbs, dim=-2)
    depth_final = torch.sum(weights * z_samp, dim=-1)
    if cfg.white_bkgd:
        pix_alpha = torch.sum(weights, dim=-1)
        rgb_final = rgb_final + (1.0 - pix_alpha[..., None])
    return {"weights": weights, "rgb": rgb_final, "depth": depth_final}


def _stage_features(features_fn, rays, z_samp, use_viewdirs):
    """The feature stage on the sample positions of ``z_samp``."""
    SB, B, K = z_samp.shape
    points = rays[..., None, :3] + z_samp[..., None] * rays[..., None, 3:6]
    points = points.reshape(SB, B * K, 3)
    viewdirs = None
    if use_viewdirs:
        viewdirs = rays[..., None, 3:6].expand(SB, B, K, 3).reshape(SB, B * K, 3)
    return features_fn(points, viewdirs)


def _format(out: Dict[str, torch.Tensor], want_weights: bool) -> Dict[str, torch.Tensor]:
    ret = {"rgb": out["rgb"], "depth": out["depth"]}
    if want_weights:
        ret["weights"] = out["weights"]
    return ret


def render_rays(
    features_fn: Callable,
    mlp_fn: Callable,
    rays: torch.Tensor,
    cfg: RenderConfig,
    generator: Optional[torch.Generator] = None,
    noise: Optional[Dict[str, torch.Tensor]] = None,
    want_weights: bool = False,
    use_viewdirs: bool = True,
) -> Dict[str, Dict[str, torch.Tensor]]:
    """Staged hierarchical render of a ray batch.

    :param features_fn: ``f(points (SB, P, 3), viewdirs) -> feats``
    :param mlp_fn: ``f(feats, coarse: bool) -> (SB, P, 4)``; the fine pass
        reuses the coarse samples' features (the sorted fine union contains
        every coarse z), so only the new samples go through ``features_fn``
    :param rays: (SB, B, 8) [origin, dir, near, far]
    :param noise: pre-drawn random numbers (see the module docstring);
        drawn from ``generator`` if None
    :return: {'coarse': {rgb, depth[, weights]}[, 'fine': {...}]}
    """
    if rays.dim() != 3 or rays.shape[-1] != 8:
        raise ValueError(f"rays must be (SB, B, 8), got {tuple(rays.shape)}")
    if noise is None:
        if generator is None:
            raise ValueError("pass a torch.Generator or pre-drawn noise")
        noise = draw_noise(rays, cfg, generator)
    SB, B, _ = rays.shape

    z_coarse = sample_coarse(rays, cfg, noise["coarse"])               # (SB, B, Kc)
    feats_c = _stage_features(features_fn, rays, z_coarse, use_viewdirs)
    out_c = mlp_fn(feats_c, True).reshape(SB, B, cfg.n_coarse, 4)
    coarse_out = composite_outputs(out_c, rays, z_coarse, cfg)
    outputs = {"coarse": _format(coarse_out, want_weights)}

    if cfg.using_fine:
        new_samps = []
        if cfg.n_fine - cfg.n_fine_depth > 0:
            new_samps.append(
                sample_fine(rays, coarse_out["weights"], cfg, noise["fine_u"], noise["fine_jitter"])
            )
        if cfg.n_fine_depth > 0:
            new_samps.append(sample_fine_depth(rays, coarse_out["depth"], cfg, noise["depth"]))
        out_fc = mlp_fn(feats_c, False).reshape(SB, B, cfg.n_coarse, 4)
        del feats_c
        if new_samps:
            z_new = torch.cat(new_samps, dim=-1)                        # (SB, B, Kn)
            feats_n = _stage_features(features_fn, rays, z_new, use_viewdirs)
            out_fn = mlp_fn(feats_n, False).reshape(SB, B, z_new.shape[-1], 4)
            out_f = torch.cat([out_fc, out_fn], dim=2)
            z_all = torch.cat([z_coarse, z_new], dim=-1)
        else:
            out_f, z_all = out_fc, z_coarse
        # one stable sort keyed on z; the 4 output channels ride as payload
        z_sorted, order = torch.sort(z_all, dim=-1, stable=True)
        out_sorted = torch.gather(out_f, 2, order[..., None].expand(-1, -1, -1, 4))
        fine_out = composite_outputs(out_sorted, rays, z_sorted, cfg)
        outputs["fine"] = _format(fine_out, want_weights)
    return outputs


def render_rays_chunked(
    features_fn: Callable,
    mlp_fn: Callable,
    rays: torch.Tensor,
    cfg: RenderConfig,
    ray_chunk: int,
    generator: Optional[torch.Generator] = None,
    noise_chunks=None,
    want_weights: bool = False,
    use_viewdirs: bool = True,
) -> Dict[str, Dict[str, torch.Tensor]]:
    """Memory-bounded render: a Python loop over ray chunks of (SB, B, 8),
    concatenated along B. ``noise_chunks`` is a list with one noise dict per
    chunk, or None to draw from ``generator``."""
    SB, B, _ = rays.shape
    outs = []
    for i, start in enumerate(range(0, B, ray_chunk)):
        noise = None if noise_chunks is None else noise_chunks[i]
        outs.append(
            render_rays(
                features_fn, mlp_fn, rays[:, start : start + ray_chunk], cfg,
                generator, noise, want_weights, use_viewdirs,
            )
        )
    return {
        branch: {k: torch.cat([o[branch][k] for o in outs], dim=1) for k in outs[0][branch]}
        for branch in outs[0]
    }
