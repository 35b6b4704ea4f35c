"""The conditional radiance field (counterpart of
``pixelnerf_tpu/models/pixelnerf.py``).

``encode(images, poses, focal, c) -> SceneEncoding`` holds the pixel-aligned
feature maps, the inverted world->camera poses and the normalized
intrinsics; ``query_features`` (camera transform, uv projection,
pixel-aligned gather, positional code) and ``query_mlp`` (the conditioned
MLP and its output heads) are the two stages the staged renderer calls, and
``query`` is the two in a row, what the unstaged renderer calls.

Variants read from the config: a global ``ImageEncoder`` whose vector is
concatenated before the pixel-aligned latent (``global_latent``), and the
quad-corner gather (``quad_gather``: ``latent_quad`` holds each pixel's four
bilinear corners, and the lookup is one plain row gather per point instead
of a gather kernel).

Two inference-time variants of the encoding: :func:`bake_encoding` folds the
MLPs' latent injections into per-MLP maps that ``query`` then gathers from
(``tz_coarse``/``tz_fine``), and :func:`pack_encoding` prepares the bf16 map
that ``query_fused`` gathers from inside the fused gather+MLP kernel
(``ops/fused_field.py``).

Conventions kept for checkpoint parity: fy negated at encode, projection
``uv = -xy/z * f + c``, the canonical-frame xyz feature from the
rotation-only transform, multi-view fusion through the MLP's
``combine_inner_dims``.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import torch
import torch.nn as nn

from ..ops.gather import field_rows_wide, gather_bilerp_field, gather_bilerp_field_plain
from ..ops.grid_sample import _compute_source_index, bilinear_pair_bases, build_quad_features, grid_sample_quad
from ..utils.geometry import device_vector, invert_pose, on_device, repeat_interleave
from ..utils.profiling import span
from .code import PositionalEncoding
from .encoder import ImageEncoder, SpatialEncoder, index_latent, latent_scaling


@dataclasses.dataclass
class SceneEncoding:
    """Everything the queries need about the conditioning views."""

    latent: Optional[torch.Tensor]   # (SB*NS, Hl, Wl, C) pixel-aligned features
    poses: torch.Tensor              # (SB*NS, 3, 4) world->camera
    focal: torch.Tensor              # (SB, 2) or (SB*NS, 2) [fx, -fy]
    c: torch.Tensor                  # (SB, 2) or (SB*NS, 2) principal point
    image_shape: torch.Tensor        # (2,) [W, H] of the encoded images
    num_views: int = 1
    # Baked latent injections (bake_encoding): each MLP's lin_z product
    # applied to the feature map at encode time, (SB*NS, Hl, Wl, n_lin_z*dh).
    tz_coarse: Optional[torch.Tensor] = None
    tz_fine: Optional[torch.Tensor] = None
    # The bf16 feature rows (SB*NS, Hl*Wl, C) that the fused gather+MLP
    # kernel reads (pack_encoding).
    latent_packed: Optional[torch.Tensor] = None
    # The global encoder's vectors (SB*NS, G), float32.
    global_latent: Optional[torch.Tensor] = None
    # Each pixel's four bilinear corners (SB*NS, Hl, Wl, 4C) (quad_gather).
    latent_quad: Optional[torch.Tensor] = None


def _normalize_intrinsic(v, batch: int, name: str, num_views: int = 1, device=None) -> torch.Tensor:
    """Broadcast focal/c to (SB, 2), or keep per-view (SB*NS, 2) inputs.

    A length-2 vector at SB == 1 is an (fx, fy) pair; any other 1-D input is
    per-entry scalars f_i -> (f_i, f_i). Pass shape (SB, 2) to be explicit.
    Host values are written on ``device``, not copied (``on_device``).
    """
    v = on_device(v, device)
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
        global_encoder: Optional[ImageEncoder] = None,
        use_encoder: bool = True,
        use_xyz: bool = False,
        normalize_z: bool = True,
        use_code_viewdirs: bool = True,
        use_viewdirs: bool = False,
        stop_encoder_grad: bool = False,
        latent_dtype: torch.dtype = torch.float32,
        quad_gather: bool = False,
    ):
        super().__init__()
        self.encoder = encoder
        self.mlp_coarse = mlp_coarse
        self.mlp_fine = mlp_fine
        self.code = code
        self.global_encoder = global_encoder
        self.use_encoder = use_encoder
        self.use_xyz = use_xyz
        self.normalize_z = normalize_z
        self.use_code_viewdirs = use_code_viewdirs
        self.use_viewdirs = use_viewdirs
        self.stop_encoder_grad = stop_encoder_grad
        self.latent_dtype = latent_dtype
        self.quad_gather = quad_gather

    @property
    def use_code(self) -> bool:
        return self.code is not None

    @property
    def use_global_encoder(self) -> bool:
        return self.global_encoder is not None

    @property
    def d_latent(self) -> int:
        d = self.encoder.latent_size if self.use_encoder else 0
        if self.use_global_encoder:
            d += self.global_encoder.latent_size
        return d

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
        :param train: the encoders' batch norms in training mode
        """
        with span("encode", images=images.shape[0] * images.shape[1]):
            SB, NS, H, W, _ = images.shape
            dev = images.device
            images_flat = images.reshape(SB * NS, H, W, 3)
            latent = latent_quad = global_latent = None
            if self.use_encoder:
                # bf16 storage halves the gather's traffic; the lerp is float32.
                # The cast stays in the autograd graph when training.
                latent = self.encoder(images_flat, train).to(self.latent_dtype).contiguous()
                if (self.quad_gather and self.encoder.index_interp == "bilinear"
                        and self.encoder.index_padding == "border"):
                    latent_quad = build_quad_features(latent)
            if self.use_global_encoder:
                global_latent = self.global_encoder(images_flat, train)
            w2c = invert_pose(poses.reshape(SB * NS, 4, 4).float())
            image_shape = device_vector((W, H), dev)
            focal = _normalize_intrinsic(focal, SB, "focal", NS, dev)
            focal = focal * device_vector((1.0, -1.0), dev)   # image y is down
            if c is None:
                c = (image_shape * 0.5).expand(SB, 2)
            else:
                c = _normalize_intrinsic(c, SB, "c", NS, dev)
            return SceneEncoding(latent, w2c, focal, c, image_shape, NS, global_latent=global_latent,
                                 latent_quad=latent_quad)

    def query(
        self, enc: SceneEncoding, xyz, viewdirs=None, coarse: bool = True, fast: bool = False,
        use_kernels: bool = True,
    ) -> torch.Tensor:
        """Predict (r, g, b, sigma) at world points: ``query_features`` then
        ``query_mlp``.

        :param xyz: (SB, B, 3) world-space query points
        :param viewdirs: (SB, B, 3) world-space view directions
        :return: (SB, B, 4): sigmoid(rgb), relu(sigma)
        """
        feats = self.query_features(enc, xyz, viewdirs, use_kernels=use_kernels, coarse=coarse)
        return self.query_mlp(enc, feats, coarse=coarse, fast=fast, use_kernels=use_kernels)

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
        differentiable: bool = False, coarse: bool = True,
    ):
        """The per-point feature stage: camera transform, uv projection,
        pixel-aligned gather, positional code.

        Where :meth:`fuses_inputs` holds (the card's inference path of the
        published configs) the stage is one launch of kernel A's field
        instance, its plain mirror with ``use_kernels=False``; the
        ``field.features`` span counts ``inputs_fused`` or ``separate``.

        :param differentiable: gather through kernel C and its backward
            (training) instead of kernel A (inference); the quad-corner
            gather is plain PyTorch either way
        :param coarse: only matters for baked encodings, whose maps are per
            MLP: gather the coarse MLP's injections or the fine MLP's
        :return: (latent or None, z_feature), each (SB*NS, B, D) in the
            MLP's compute dtype; for a baked encoding the latent is the
            gathered injections, (SB*NS, B, n_lin_z*d_hidden); with the
            global encoder its vector comes first, then the gathered latent
        """
        with span("field.features", points=xyz.shape[0] * xyz.shape[1], views=enc.num_views) as s:
            dt = self.mlp_coarse.dtype
            if self.fuses_inputs(enc, xyz.device, viewdirs is not None, differentiable):
                s.count("inputs_fused")
                freqs, phases = self.code.device_tables(xyz.device, torch.float32)
                run = gather_bilerp_field if use_kernels else gather_bilerp_field_plain
                latent, z_feature = run(enc.latent, xyz, viewdirs, enc.poses, enc.focal, enc.c, enc.image_shape,
                                        freqs, phases, dt)
            else:
                s.count("separate")
                latent, z_feature = self._separate_features(enc, xyz, viewdirs, use_kernels, differentiable,
                                                            coarse)
            if latent is not None and self.use_global_encoder:
                glob = ImageEncoder.index(enc.global_latent, latent.shape[1]).to(dt)
                latent = torch.cat([glob, latent], dim=-1)
            return latent, z_feature

    def fuses_inputs(self, enc: SceneEncoding, device, viewdirs_given: bool = True,
                     differentiable: bool = False) -> bool:
        """Whether ``query_features`` takes the feature stage in one launch
        of kernel A's field instance (``ops/gather.py``
        ``gather_bilerp_field``): on a CUDA device, for inference (neither
        ``differentiable`` nor autograd on), from an unbaked spatial latent
        without a quad table, gathered bilinear/border in rows that A serves
        a warp a point, with the model's inputs the instance computes: the
        rotated xyz, its code, then the rotated view directions
        (``use_xyz``, ``normalize_z``, ``use_code``, ``use_viewdirs``, not
        ``use_code_viewdirs``). Every other call composes the stage in
        PyTorch around the gather (``_separate_features``)."""
        lat = enc.latent
        return (
            torch.device(device).type == "cuda" and not differentiable and not torch.is_grad_enabled()
            and self.use_encoder and lat is not None and enc.tz_coarse is None and enc.latent_quad is None
            and self.encoder.index_interp == "bilinear" and self.encoder.index_padding == "border"
            and self.use_xyz and self.normalize_z and self.use_code and self.code.d_in == 3
            and self.code.include_input
            and self.use_viewdirs and not self.use_code_viewdirs and viewdirs_given
            and self.mlp_coarse.dtype in (torch.float32, torch.bfloat16)
            and field_rows_wide(lat.shape[-1], lat.dtype)
        )

    def _separate_features(self, enc: SceneEncoding, xyz, viewdirs, use_kernels: bool, differentiable: bool,
                           coarse: bool):
        """The feature stage composed in PyTorch around the gather:
        ``_point_inputs``, then ``index_latent`` (or the quad table's plain
        gather), each output in the MLP's dtype; the spatial latent alone."""
        z_feature, uv = self._point_inputs(enc, xyz, viewdirs)
        dt = self.mlp_coarse.dtype
        latent = None
        if self.use_encoder:
            if enc.tz_coarse is not None:
                # baked: the gather returns the latent injections directly
                source = enc.tz_coarse if (coarse or self.mlp_fine is None) else enc.tz_fine
                latent = index_latent(
                    source, uv, enc.image_shape, self.encoder.index_interp,
                    self.encoder.index_padding, out_dtype=dt, use_kernels=use_kernels,
                    differentiable=differentiable,
                )
            elif enc.latent_quad is not None:
                Hl, Wl = enc.latent.shape[1:3]
                scale = latent_scaling(Hl, Wl, uv.device) / enc.image_shape
                # lerped in float32, rounded once to the MLP's dtype
                latent = grid_sample_quad(enc.latent_quad, uv * scale - 1.0).to(dt)
            else:
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
        # baked maps make the gathered latent pre-transformed (z @ Wz + b)
        z_pre = latent is not None and enc.tz_coarse is not None
        with span("field.mlp", rows=SB * B):
            out = mlp(
                (latent, z_feature), combine_inner_dims=(NS, B), fast=fast, use_kernels=use_kernels,
                z_pretransformed=z_pre,
            )
            return _heads(out.reshape(SB, B, 4))

    def query_fused(
        self, enc: SceneEncoding, xyz, viewdirs=None, coarse: bool = True, use_kernels: bool = True,
    ) -> torch.Tensor:
        """``query`` through the single-kernel gather+MLP path
        (``ops/fused_field.py``): the pixel-aligned gather runs inside the
        conditioned MLP's kernel. Same function as ``query(fast=True)``.

        Requires a :func:`pack_encoding`'d single-scene single-view encoding
        (``SB*NS == 1``), the spatial encoder as the only latent (no global
        encoder), bilinear/border indexing and an unbaked ReLU ResnetFC
        without SPADE in bf16, and raises otherwise. Inference only.
        """
        if enc.latent_packed is None:
            raise ValueError("pack_encoding() the encoding first")
        if enc.latent_packed.shape[0] != 1 or enc.num_views != 1:
            raise ValueError("the fused gather path is single-scene single-view")
        if not self.use_encoder or self.global_encoder is not None:
            raise ValueError("the fused gather path needs the spatial encoder as the only latent")
        if self.encoder.index_interp != "bilinear":
            raise ValueError("the fused gather path needs bilinear indexing")
        if self.encoder.index_padding != "border":
            raise ValueError("the fused gather path needs border padding")
        if enc.tz_coarse is not None:
            raise ValueError("the fused gather path is incompatible with baked injections")
        SB, B, _ = xyz.shape
        z_feature, uv = self._point_inputs(enc, xyz, viewdirs)
        Hl, Wl = enc.latent.shape[1:3]
        uvn = uv * (latent_scaling(Hl, Wl, uv.device) / enc.image_shape) - 1.0
        px = _compute_source_index(uvn[..., 0], Wl, "border", True)
        py = _compute_source_index(uvn[..., 1], Hl, "border", True)
        base, wg = bilinear_pair_bases(px, py, Hl, Wl)
        mlp = self.mlp_coarse if (coarse or self.mlp_fine is None) else self.mlp_fine
        out = mlp(
            (None, z_feature), combine_inner_dims=(1, B), fast=True, use_kernels=use_kernels,
            gather=(enc.latent_packed[0], base[0], wg[0], Wl),
        )
        return _heads(out.reshape(SB, B, 4))


def _heads(out: torch.Tensor) -> torch.Tensor:
    """The output heads: sigmoid(rgb), relu(sigma)."""
    return torch.cat([torch.sigmoid(out[..., :3]), torch.relu(out[..., 3:4])], dim=-1)


def coarse_only(net: PixelNeRFNet) -> PixelNeRFNet:
    """A ``PixelNeRFNet`` that shares every module of ``net`` but has no
    fine MLP, so the fine pass runs the coarse MLP (the eval apps'
    ``--coarse``; the JAX package's ``net.clone(mlp_fine=None)``). ``net``
    itself is left as it is."""
    return PixelNeRFNet(
        encoder=net.encoder,
        mlp_coarse=net.mlp_coarse,
        mlp_fine=None,
        code=net.code,
        global_encoder=net.global_encoder,
        use_encoder=net.use_encoder,
        use_xyz=net.use_xyz,
        normalize_z=net.normalize_z,
        use_code_viewdirs=net.use_code_viewdirs,
        use_viewdirs=net.use_viewdirs,
        stop_encoder_grad=net.stop_encoder_grad,
        latent_dtype=net.latent_dtype,
        quad_gather=net.quad_gather,
    ).train(net.training)


def pack_encoding(net: PixelNeRFNet, enc: SceneEncoding) -> SceneEncoding:
    """Prepare the feature rows read by the fused gather+MLP kernel
    (:meth:`PixelNeRFNet.query_fused`): the latent map rounded to bf16,
    exactly like the default bf16 gather path, as contiguous rows
    (SB*NS, Hl*Wl, C). Where the JAX package packs each pixel with its
    right-hand neighbour into int32 lanes, the kernel here reads the plain
    map and clamps the neighbour itself."""
    if not net.use_encoder or enc.latent is None:
        raise ValueError("pack_encoding needs an encoded latent")
    n, hl, wl, c = enc.latent.shape
    packed = enc.latent.detach().to(torch.bfloat16).reshape(n, hl * wl, c).contiguous()
    return dataclasses.replace(enc, latent_packed=packed)


@contextlib.contextmanager
def _full_float32_matmul():
    """Float32 matrix products in full float32 (no TF32) inside the block."""
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


@torch.no_grad()
def bake_encoding(net: PixelNeRFNet, enc: SceneEncoding) -> SceneEncoding:
    """Fold the MLPs' latent-injection products into the feature map
    (inference).

    The pixel-aligned latent enters ResnetFC only through the ``lin_z``
    layers, and bilinear interpolation commutes with linear maps, so
    ``lerp(corners) @ Wz + bz == lerp(corners @ Wz + bz)`` exactly (the lerp
    weights sum to 1, so the bias bakes in too; valid for 'border' padding,
    where every fetched row is a real map row). Baking removes the
    d_latent x (n_lin_z*d_hidden) product from the per-sample loop and pays
    it once per encode over Hl*Wl pixels; the gathered rows grow from
    d_latent to n_lin_z*d_hidden wide.

    Returns a new :class:`SceneEncoding` with ``tz_coarse``/``tz_fine`` set
    (one map per MLP, float32 product, then one cast to the latent's dtype);
    ``query`` uses them automatically. Exact in float32; under bf16 storage
    the rounding differs from the unbaked path by ~1 ulp of the injections.
    """
    if not net.use_encoder or enc.latent is None or net.global_encoder is not None:
        raise ValueError("baking requires the spatial encoder as the only latent source")
    if net.encoder.index_padding != "border":
        raise ValueError("zeros-padding would zero the baked bias for out-of-bounds points")
    lat = enc.latent
    n, hl, wl, c = lat.shape
    flat = lat.reshape(-1, c).float()

    def bake_one(mlp):
        # guard on what is used below: a field without lin_z layers (or one
        # that consumes z differently) cannot be baked
        if not hasattr(mlp, "n_blocks") or getattr(mlp, "use_spade", False):
            return None
        n_lin_z = min(mlp.combine_layer, mlp.n_blocks)
        if mlp.d_latent <= 0 or n_lin_z <= 0:
            return None
        K = torch.cat([lin.weight for lin in mlp.lin_z], dim=0).float()
        b = torch.cat([lin.bias for lin in mlp.lin_z]).float()
        with _full_float32_matmul():
            tz = torch.matmul(flat, K.t()) + b
        return tz.reshape(n, hl, wl, -1).to(lat.dtype).contiguous()

    tz_coarse = bake_one(net.mlp_coarse)
    tz_fine = bake_one(net.mlp_fine) if net.mlp_fine is not None else None
    # all-or-nothing: query_mlp derives z_pretransformed from tz_coarse
    # alone, so a half-baked pair would feed one MLP raw latents as tz
    if net.mlp_fine is not None and (tz_coarse is None or tz_fine is None):
        tz_coarse = tz_fine = None
    return dataclasses.replace(enc, tz_coarse=tz_coarse, tz_fine=tz_fine)
