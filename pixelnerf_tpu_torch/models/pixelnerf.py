"""The conditional radiance field (counterpart of
``pixelnerf_tpu/models/pixelnerf.py``).

``encode(images, poses, focal, c) -> SceneEncoding`` holds the pixel-aligned
feature maps, the inverted world->camera poses and the normalized
intrinsics; ``query_features`` (camera transform, uv projection,
pixel-aligned gather, positional code) and ``query_mlp`` (the conditioned
MLP and its output heads) are the two stages the staged renderer calls.

Conventions kept for checkpoint parity: fy negated at encode, projection
``uv = -xy/z * f + c``, the canonical-frame xyz feature from the
rotation-only transform, multi-view fusion through the MLP's
``combine_inner_dims``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn as nn

from ..utils.geometry import invert_pose, repeat_interleave
from .code import PositionalEncoding
from .encoder import SpatialEncoder, index_latent


@dataclasses.dataclass
class SceneEncoding:
    """Everything the queries need about the conditioning views."""

    latent: Optional[torch.Tensor]   # (SB*NS, Hl, Wl, C) pixel-aligned features
    poses: torch.Tensor              # (SB*NS, 3, 4) world->camera
    focal: torch.Tensor              # (SB, 2) or (SB*NS, 2) [fx, -fy]
    c: torch.Tensor                  # (SB, 2) or (SB*NS, 2) principal point
    image_shape: torch.Tensor        # (2,) [W, H] of the encoded images
    num_views: int = 1


def _normalize_intrinsic(v, batch: int, name: str, num_views: int = 1, device=None) -> torch.Tensor:
    """Broadcast focal/c to (SB, 2), or keep per-view (SB*NS, 2) inputs.

    A length-2 vector at SB == 1 is an (fx, fy) pair; any other 1-D input is
    per-entry scalars f_i -> (f_i, f_i). Pass shape (SB, 2) to be explicit.
    """
    v = torch.as_tensor(v, dtype=torch.float32, device=device)
    if v.dim() == 0:
        v = v.expand(batch, 2)
    elif v.dim() == 1 and batch == 1 and v.shape[0] == 2:
        v = v[None]
    elif v.dim() == 1:
        v = v[:, None].expand(v.shape[0], 2)
    if v.shape[0] == 1 and batch > 1:
        v = v.expand(batch, 2)
    if tuple(v.shape) not in {(batch, 2), (batch * num_views, 2)}:
        raise ValueError(f"{name} must broadcast to (SB, 2) or per-view (SB*NS, 2), got {tuple(v.shape)}")
    return v


class PixelNeRFNet(nn.Module):
    """Conditional NeRF: CNN-encoded source views condition a residual MLP."""

    def __init__(
        self,
        encoder: SpatialEncoder,
        mlp_coarse: nn.Module,
        mlp_fine: Optional[nn.Module] = None,
        code: Optional[PositionalEncoding] = None,
        use_encoder: bool = True,
        use_xyz: bool = False,
        normalize_z: bool = True,
        use_code_viewdirs: bool = True,
        use_viewdirs: bool = False,
        stop_encoder_grad: bool = False,
        latent_dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.encoder = encoder
        self.mlp_coarse = mlp_coarse
        self.mlp_fine = mlp_fine
        self.code = code
        self.use_encoder = use_encoder
        self.use_xyz = use_xyz
        self.normalize_z = normalize_z
        self.use_code_viewdirs = use_code_viewdirs
        self.use_viewdirs = use_viewdirs
        self.stop_encoder_grad = stop_encoder_grad
        self.latent_dtype = latent_dtype

    @property
    def use_code(self) -> bool:
        return self.code is not None

    @property
    def d_in(self) -> int:
        """Spatial-code width feeding the MLP."""
        d_in = 3 if self.use_xyz else 1
        if self.use_viewdirs and self.use_code_viewdirs:
            d_in += 3
        if self.use_code and d_in > 0:
            d_in = self.code.d_out
        if self.use_viewdirs and not self.use_code_viewdirs:
            d_in += 3
        return d_in

    def encode(
        self, images: torch.Tensor, poses: torch.Tensor, focal, c=None, train: bool = False
    ) -> SceneEncoding:
        """Encode source views.

        :param images: (SB, NS, H, W, 3) in [-1, 1] (NHWC)
        :param poses: (SB, NS, 4, 4) camera-to-world
        :param focal: scalar, (SB,), or (SB, 2) [fx, fy]
        :param c: principal point, same formats; default = image center
        :param train: the encoder's batch norms in training mode
        """
        SB, NS, H, W, _ = images.shape
        dev = images.device
        images_flat = images.reshape(SB * NS, H, W, 3)
        latent = None
        if self.use_encoder:
            # bf16 storage halves the gather's traffic; the lerp is float32.
            # The cast stays in the autograd graph when training.
            latent = self.encoder(images_flat, train).to(self.latent_dtype).contiguous()
        w2c = invert_pose(poses.reshape(SB * NS, 4, 4).float())
        image_shape = torch.tensor([W, H], dtype=torch.float32, device=dev)
        focal = _normalize_intrinsic(focal, SB, "focal", NS, dev)
        focal = focal * torch.tensor([1.0, -1.0], device=dev)   # image y is down
        if c is None:
            c = (image_shape * 0.5).expand(SB, 2)
        else:
            c = _normalize_intrinsic(c, SB, "c", NS, dev)
        return SceneEncoding(latent, w2c, focal, c, image_shape, NS)

    def _point_inputs(self, enc: SceneEncoding, xyz: torch.Tensor, viewdirs):
        """Camera transform + spatial code + uv projection.

        :return: (z_feature (SB*NS, B, d_in), uv (SB*NS, B, 2) or None)
        """
        SB, B, _ = xyz.shape
        NS = enc.num_views
        xyz_rep = repeat_interleave(xyz, NS)                        # (SB*NS, B, 3)
        rot = enc.poses[:, :3, :3]
        xyz_rot = torch.einsum("nij,nbj->nbi", rot, xyz_rep)
        xyz_cam = xyz_rot + enc.poses[:, None, :3, 3]

        if self.use_xyz:
            z_feature = xyz_rot if self.normalize_z else xyz_cam
        else:
            z_feature = -(xyz_rot if self.normalize_z else xyz_cam)[..., 2:3]
        if self.use_code and not self.use_code_viewdirs:
            z_feature = self.code(z_feature)
        if self.use_viewdirs:
            if viewdirs is None:
                raise ValueError("the model uses viewdirs")
            vdirs = repeat_interleave(viewdirs, NS)
            vdirs = torch.einsum("nij,nbj->nbi", rot, vdirs)
            z_feature = torch.cat([z_feature, vdirs], dim=-1)
        if self.use_code and self.use_code_viewdirs:
            z_feature = self.code(z_feature)

        uv = None
        if self.use_encoder:
            uv = -xyz_cam[..., :2] / xyz_cam[..., 2:3]
            focal = enc.focal if enc.focal.shape[0] == SB * NS else repeat_interleave(enc.focal, NS)
            cc = enc.c if enc.c.shape[0] == SB * NS else repeat_interleave(enc.c, NS)
            uv = uv * focal[:, None, :] + cc[:, None, :]
        return z_feature, uv

    def query_features(
        self, enc: SceneEncoding, xyz, viewdirs=None, use_kernels: bool = True,
        differentiable: bool = False,
    ):
        """The per-point feature stage: camera transform, uv projection,
        pixel-aligned gather, positional code.

        :param differentiable: gather through kernel C and its backward
            (training) instead of kernel A (inference)
        :return: (latent or None, z_feature), each (SB*NS, B, D) in the
            MLP's compute dtype
        """
        z_feature, uv = self._point_inputs(enc, xyz, viewdirs)
        dt = self.mlp_coarse.dtype
        latent = None
        if self.use_encoder:
            latent = index_latent(
                enc.latent, uv, enc.image_shape, self.encoder.index_interp,
                self.encoder.index_padding, out_dtype=dt, use_kernels=use_kernels,
                differentiable=differentiable,
            )
            if self.stop_encoder_grad:
                latent = latent.detach()
        return latent, z_feature.to(dt)

    def query_mlp(
        self, enc: SceneEncoding, feats, coarse: bool = True, fast: bool = False,
        use_kernels: bool = True,
    ) -> torch.Tensor:
        """The field MLP stage: the (coarse or fine) conditioned MLP and the
        output heads. :return: (SB, B, 4): sigmoid(rgb), relu(sigma)"""
        latent, z_feature = feats
        NS = enc.num_views
        B = z_feature.shape[1]
        SB = z_feature.shape[0] // NS
        mlp = self.mlp_coarse if (coarse or self.mlp_fine is None) else self.mlp_fine
        out = mlp((latent, z_feature), combine_inner_dims=(NS, B), fast=fast, use_kernels=use_kernels)
        out = out.reshape(SB, B, 4)
        return torch.cat([torch.sigmoid(out[..., :3]), torch.relu(out[..., 3:4])], dim=-1)
