"""pixelNeRF's conditioned field (Yu et al. 2021, §4.2): a query point is
taken into each source view's camera frame, projected to its pixel, and
the view's feature map sampled there bilinearly (border padding,
align_corners); the point's positional code in the view's rotation-only
frame and the view direction feed a residual MLP whose first
``combine_layer`` blocks take the feature as an added injection, then the
views' hidden states are averaged and the remaining blocks run once.
Output: sigmoid(rgb), relu(sigma). Weights by the names
``mlp_coarse.``/``mlp_fine.`` + ``lin_in``, ``lin_z.i``, ``blocks.j.fc_0``,
``blocks.j.fc_1``, ``lin_out``."""
from __future__ import annotations

import math

import torch

from .precision import Precision


def positional_code(x: torch.Tensor, num_freqs: int, freq_factor: float, include_input: bool) -> torch.Tensor:
    """[x, sin(f_0 x), cos(f_0 x), sin(f_1 x), ...], f_k = freq_factor 2^k,
    each term over the three coordinates."""
    terms = [x] if include_input else []
    for k in range(num_freqs):
        f = freq_factor * 2.0 ** k
        terms += [torch.sin(f * x), torch.sin(f * x + math.pi * 0.5)]
    return torch.cat(terms, dim=-1)


def bilinear(latent: torch.Tensor, uv: torch.Tensor, image_wh) -> torch.Tensor:
    """Sample (Hl, Wl, C) at pixel positions uv (P, 2) of an image of size
    image_wh = (W, H): the pixel scaled to the map (align_corners), clamped
    to the border, the four neighbours weighted bilinearly."""
    hl, wl, c = latent.shape
    out = []
    pos = []
    for axis, size, full in ((0, wl, image_wh[0]), (1, hl, image_wh[1])):
        g = uv[:, axis] * (size / (size - 1) * 2.0 / full) - 1.0
        pos.append(torch.clamp((g + 1.0) * 0.5 * (size - 1), 0.0, size - 1))
    px, py = pos
    x0 = torch.floor(px).detach()
    y0 = torch.floor(py).detach()
    fx, fy = px - x0, py - y0
    x0i, y0i = x0.long(), y0.long()
    x1i, y1i = torch.clamp(x0i + 1, max=wl - 1), torch.clamp(y0i + 1, max=hl - 1)
    flat = latent.reshape(hl * wl, c)

    def rows(yi, xi):
        return flat[yi * wl + xi]

    top = rows(y0i, x0i) * (1 - fx)[:, None] + rows(y0i, x1i) * fx[:, None]
    bot = rows(y1i, x0i) * (1 - fx)[:, None] + rows(y1i, x1i) * fx[:, None]
    return top * (1 - fy)[:, None] + bot * fy[:, None]


def resnetfc(w: dict, prefix: str, z: torch.Tensor, x: torch.Tensor, mlp: dict, num_views: int,
             prec: Precision) -> torch.Tensor:
    """z (NS, P, d_latent), x (NS, P, d_in) -> (P, 4) before the heads."""
    def lin(a, name):
        return prec.linear(a, w[prefix + name + ".weight"], w[prefix + name + ".bias"])

    h = lin(x, "lin_in")
    for blk in range(mlp["n_blocks"]):
        if blk == mlp["combine_layer"]:
            h = h.mean(dim=0) if mlp["combine_type"] == "average" else h.amax(dim=0)
        if blk < mlp["combine_layer"]:
            h = h + lin(z, f"lin_z.{blk}")
        y = lin(torch.relu(h), f"blocks.{blk}.fc_0")
        h = h + lin(torch.relu(y), f"blocks.{blk}.fc_1")
    if h.dim() == 3:                     # no combine inside the blocks: one view
        if h.shape[0] != 1:
            raise ValueError("views are combined inside the blocks only")
        h = h[0]
    return lin(torch.relu(h), "lin_out")


class Scene:
    """The conditioning of one scene: its views' feature maps (NS, Hl, Wl,
    C), camera-to-world poses (NS, 4, 4), focal (fx, fy), principal point
    and image size (W, H)."""

    def __init__(self, latent, c2w, focal, c, image_wh):
        self.latent = latent
        rot = c2w[:, :3, :3].transpose(1, 2)
        self.rot = rot
        self.trans = -torch.einsum("nij,nj->ni", rot, c2w[:, :3, 3])
        self.focal = focal
        self.c = c
        self.image_wh = image_wh


def query(w: dict, model: dict, scene: Scene, xyz: torch.Tensor, viewdirs: torch.Tensor, coarse: bool,
          prec: Precision = None, field_raw: bool = False) -> torch.Tensor:
    """(P, 3) world points and directions -> (P, 4): sigmoid(rgb), relu(sigma)
    (``field_raw``: the output layer's values before them)."""
    prec = prec or Precision()
    code = model["code"]
    xyz_rot = torch.einsum("nij,pj->npi", scene.rot, xyz)                  # (NS, P, 3)
    xyz_cam = xyz_rot + scene.trans[:, None, :]
    feat = positional_code(xyz_rot, code["num_freqs"], code["freq_factor"], code["include_input"])
    if model["use_viewdirs"]:
        feat = torch.cat([feat, torch.einsum("nij,pj->npi", scene.rot, viewdirs)], dim=-1)
    z = []
    for v in range(scene.latent.shape[0]):
        u = -xyz_cam[v, :, 0] / xyz_cam[v, :, 2] * scene.focal[0] + scene.c[0]
        vv = xyz_cam[v, :, 1] / xyz_cam[v, :, 2] * scene.focal[1] + scene.c[1]
        z.append(bilinear(scene.latent[v], torch.stack([u, vv], dim=-1), scene.image_wh))
    z = torch.stack(z)
    out = resnetfc(w, "mlp_coarse." if coarse else "mlp_fine.", z, feat, model["mlp"], scene.latent.shape[0], prec)
    if field_raw:
        return out
    return torch.cat([torch.sigmoid(out[:, :3]), torch.relu(out[:, 3:4])], dim=-1)
