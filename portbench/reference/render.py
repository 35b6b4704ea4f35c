"""The hierarchical volume render of NeRF as pixelNeRF runs it: stratified
coarse samples, importance samples from the coarse weights (detached) by
the inverse CDF, samples jittered about the coarse depth, one fine pass
over the sorted union, alpha compositing with an optional white
background. The random numbers are given: ``coarse`` (R, Kc), ``fine_u``
and ``fine_jitter`` (R, n_fine - n_fine_depth), ``depth`` (R,
n_fine_depth)."""
from __future__ import annotations

import torch


def composite(out: torch.Tensor, z: torch.Tensor, far: torch.Tensor, white_bkgd: bool):
    """out (R, K, 4), z (R, K) sorted -> weights (R, K), rgb (R, 3), depth (R,)."""
    deltas = torch.cat([z[:, 1:] - z[:, :-1], far[:, None] - z[:, -1:]], dim=-1)
    alpha = 1.0 - torch.exp(-deltas * torch.relu(out[..., 3]))
    trans = torch.cumprod(torch.cat([torch.ones_like(alpha[:, :1]), 1.0 - alpha + 1e-10], dim=-1), dim=-1)
    weights = alpha * trans[:, :-1]
    rgb = (weights[..., None] * out[..., :3]).sum(dim=1)
    if white_bkgd:
        rgb = rgb + (1.0 - weights.sum(dim=1))[:, None]
    return weights, rgb, (weights * z).sum(dim=1)


def render(field, rays: torch.Tensor, noise: dict, cfg: dict):
    """field(points (P, 3), dirs (P, 3), coarse) -> (P, 4); rays (R, 8).
    Returns {"coarse": (rgb, depth), "fine": (rgb, depth)}."""
    near, far = rays[:, 6], rays[:, 7]
    kc = cfg["n_coarse"]
    steps = torch.arange(kc, dtype=rays.dtype, device=rays.device) / kc
    t = steps + noise["coarse"] / kc
    z_c = near[:, None] * (1 - t) + far[:, None] * t

    def run(z, coarse):
        pts = rays[:, None, :3] + z[..., None] * rays[:, None, 3:6]
        dirs = rays[:, None, 3:6].expand(pts.shape)
        return field(pts.reshape(-1, 3), dirs.reshape(-1, 3), coarse).reshape(*z.shape, 4)

    w_c, rgb_c, depth_c = composite(run(z_c, True), z_c, far, cfg["white_bkgd"])
    out = {"coarse": (rgb_c, depth_c)}
    if cfg["n_fine"] > 0:
        new = []
        if cfg["n_fine"] > cfg["n_fine_depth"]:
            pdf = w_c.detach() + 1e-5
            pdf = pdf / pdf.sum(dim=-1, keepdim=True)
            cdf = torch.cat([torch.zeros_like(pdf[:, :1]), torch.cumsum(pdf, dim=-1)], dim=-1)
            idx = (cdf[:, None, :] <= noise["fine_u"][..., None]).sum(dim=-1) - 1
            t = (torch.clamp(idx, min=0).to(rays.dtype) + noise["fine_jitter"]) / kc
            new.append(near[:, None] * (1 - t) + far[:, None] * t)
        if cfg["n_fine_depth"] > 0:
            zd = depth_c[:, None] + noise["depth"] * cfg["depth_std"]
            new.append(torch.minimum(torch.maximum(zd, near[:, None]), far[:, None]))
        z_f, _ = torch.sort(torch.cat([z_c] + new, dim=-1), dim=-1)
        _, rgb_f, depth_f = composite(run(z_f, False), z_f, far, cfg["white_bkgd"])
        out["fine"] = (rgb_f, depth_f)
    return out
