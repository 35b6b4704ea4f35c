"""Camera / ray geometry, pose math and multiview reductions (torch).

Counterpart of ``pixelnerf_tpu/utils/geometry.py``. Conventions, which
checkpoint and metric parity depend on:

- the camera looks down **-Z**, y-up: the unprojection map builds unit
  directions ``(X, -Y, -Z)``
- a ray is the 8-vector ``[origin(3), dir(3), near(1), far(1)]``
- poses handed around are camera-to-world; :func:`invert_pose` gives the
  world-to-camera 3x4 the conditional field uses
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch


def _as_fxfy(f, device) -> torch.Tensor:
    """Normalize focal to a (2,) [fx, fy] tensor (scalar / (2,) accepted)."""
    f = torch.as_tensor(f, dtype=torch.float32, device=device).reshape(-1)
    if f.numel() == 1:
        f = f.repeat(2)
    return f


def unproj_map(width: int, height: int, f, c=None, device="cuda") -> torch.Tensor:
    """Per-pixel unit camera-ray directions, (H, W, 3).

    Pixel (x, y) maps to the unit vector of ``((x - cx)/fx, -(y - cy)/fy, -1)``.
    """
    if c is None:
        c = torch.tensor([width * 0.5, height * 0.5], dtype=torch.float32, device=device)
    else:
        c = torch.as_tensor(c, dtype=torch.float32, device=device).reshape(2)
    f = _as_fxfy(f, device)
    ys = torch.arange(height, dtype=torch.float32, device=device)[:, None] - c[1]
    xs = torch.arange(width, dtype=torch.float32, device=device)[None, :] - c[0]
    X = (xs / f[0]).expand(height, width)
    Y = (ys / f[1]).expand(height, width)
    Z = torch.ones((height, width), dtype=torch.float32, device=device)
    dirs = torch.stack([X, -Y, -Z], dim=-1)
    return dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)


def gen_rays(
    poses, width: int, height: int, focal, z_near, z_far, c=None, device="cuda"
) -> torch.Tensor:
    """Camera rays for each camera-to-world pose (B, 4, 4): (B, H, W, 8)."""
    poses = torch.as_tensor(poses, dtype=torch.float32, device=device)
    unproj = unproj_map(width, height, focal, c, device=device)           # (H, W, 3)
    raydir = torch.einsum("bij,hwj->bhwi", poses[:, :3, :3], unproj)
    B = poses.shape[0]
    centers = poses[:, None, None, :3, 3].expand(B, height, width, 3)
    nears = torch.full((B, height, width, 1), float(z_near), device=device)
    fars = torch.full((B, height, width, 1), float(z_far), device=device)
    return torch.cat([centers, raydir, nears, fars], dim=-1)


def invert_pose(poses: torch.Tensor) -> torch.Tensor:
    """Camera-to-world (..., 4, 4) -> world-to-camera (..., 3, 4): R^T, -R^T t."""
    rot = poses[..., :3, :3].transpose(-1, -2)
    trans = -torch.einsum("...ij,...j->...i", rot, poses[..., :3, 3])
    return torch.cat([rot, trans[..., None]], dim=-1)


# Pose constructors (host-side helpers; numpy in float32)

def trans_t(t: float) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    m[2, 3] = t
    return m


def rot_phi(phi: float) -> np.ndarray:
    c, s = math.cos(phi), math.sin(phi)
    return np.array(
        [[1, 0, 0, 0], [0, c, -s, 0], [0, s, c, 0], [0, 0, 0, 1]], dtype=np.float32
    )


def rot_theta(th: float) -> np.ndarray:
    c, s = math.cos(th), math.sin(th)
    return np.array(
        [[c, 0, -s, 0], [0, 1, 0, 0], [s, 0, c, 0], [0, 0, 0, 1]], dtype=np.float32
    )


def pose_spherical(theta: float, phi: float, radius: float) -> np.ndarray:
    """NeRF-style spherical camera pose."""
    c2w = trans_t(radius)
    c2w = rot_phi(phi / 180.0 * math.pi) @ c2w
    c2w = rot_theta(theta / 180.0 * math.pi) @ c2w
    flip = np.array(
        [[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]], dtype=np.float32
    )
    return flip @ c2w


def look_at(origin, target, world_up=(0.0, 1.0, 0.0)) -> np.ndarray:
    """Camera-to-world matrix for a camera at ``origin`` looking at ``target``."""
    origin = np.asarray(origin, dtype=np.float32)
    target = np.asarray(target, dtype=np.float32)
    world_up = np.asarray(world_up, dtype=np.float32)
    back = origin - target
    back = back / np.linalg.norm(back)
    right = np.cross(world_up, back)
    right = right / np.linalg.norm(right)
    up = np.cross(back, right)
    m = np.eye(4, dtype=np.float32)
    m[:3, 0], m[:3, 1], m[:3, 2], m[:3, 3] = right, up, back, origin
    return m


def coord_from_blender(dtype=np.float32) -> np.ndarray:
    """Blender (x right, y in, z up) -> standard (x right, y up, z out)."""
    return np.array([[1, 0, 0, 0], [0, 0, 1, 0], [0, -1, 0, 0], [0, 0, 0, 1]], dtype=dtype)


def coord_to_blender(dtype=np.float32) -> np.ndarray:
    return np.array([[1, 0, 0, 0], [0, 0, -1, 0], [0, 1, 0, 0], [0, 0, 0, 1]], dtype=dtype)


# Quaternions (numpy, float32; batched (B, 4) <-> (B, 3, 3))

def quat_to_rot(q) -> np.ndarray:
    """Unit-normalised quaternions (..., 4) as (w, x, y, z) -> rotation
    matrices (..., 3, 3)."""
    q = np.asarray(q, np.float32)
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    qr, qi, qj, qk = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r = np.stack(
        [
            1 - 2 * (qj**2 + qk**2), 2 * (qj * qi - qk * qr), 2 * (qi * qk + qr * qj),
            2 * (qj * qi + qk * qr), 1 - 2 * (qi**2 + qk**2), 2 * (qj * qk - qi * qr),
            2 * (qk * qi - qj * qr), 2 * (qj * qk + qi * qr), 1 - 2 * (qi**2 + qj**2),
        ],
        axis=-1,
    )
    return r.reshape(*q.shape[:-1], 3, 3)


def rot_to_quat(R) -> np.ndarray:
    """Rotation matrices (..., 3, 3) -> quaternions (..., 4) as (w, x, y, z):
    w = sqrt(1 + trace) / 2 and the other three over 4w, the JAX package's
    branch (a trace near -1 divides by ~0, as there)."""
    R = np.asarray(R, np.float32)
    w = np.sqrt(1.0 + R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]) / np.float32(2.0)
    x = (R[..., 2, 1] - R[..., 1, 2]) / (4 * w)
    y = (R[..., 0, 2] - R[..., 2, 0]) / (4 * w)
    z = (R[..., 1, 0] - R[..., 0, 1]) / (4 * w)
    return np.stack([w, x, y, z], axis=-1)


# Multiview reductions

def repeat_interleave(x: torch.Tensor, repeats: int) -> torch.Tensor:
    """Repeat along axis 0, interleaved."""
    if repeats == 1:
        return x
    return torch.repeat_interleave(x, repeats, dim=0)


def combine_interleaved(
    t: torch.Tensor, inner_dims: Sequence[int] = (1,), agg_type: str = "average"
) -> torch.Tensor:
    """Reduce over the interleaved views axis.

    ``t`` of shape (prod(inner_dims)*N, ...) is viewed as (N, *inner_dims, ...)
    and reduced over axis 1 (the view count).
    """
    if len(inner_dims) == 1 and inner_dims[0] == 1:
        return t
    t = t.reshape(-1, *inner_dims, *t.shape[1:])
    if agg_type == "average":
        return torch.mean(t, dim=1)
    if agg_type == "max":
        return torch.amax(t, dim=1)
    raise NotImplementedError(f"Unsupported combine type {agg_type}")
