"""Inputs made from the seed on the device: cameras, objects on white and
textured source views, and the target cameras of a traffic mix's
trajectory.

An SRN-like object is a few shaded spheres about the origin, seen by
cameras on the radius-1.3 sphere looking at it (SRN's cars and chairs are
rendered so), on a white background, as uint8 pixels. A DTU-like scene's
source views are smooth colour fields with a little noise, seen from
cameras on an arc about the scan, as DTU's are. Target cameras follow the
video app's paths (``apps/gen_video.py``): a spherical orbit, or a
periodic spline through keyframe rotations."""
from __future__ import annotations

import math

import numpy as np
import torch

from . import seeds

LIGHT = (0.4, 0.8, 0.45)


def focal_pair(cam: dict) -> list:
    """A camera's focal as [fx, fy]."""
    f = cam["focal"]
    return [float(f), float(f)] if np.isscalar(f) else [float(v) for v in f]


def look_at(origins: torch.Tensor) -> torch.Tensor:
    """Camera-to-world (N, 4, 4) of cameras at ``origins`` (N, 3) looking at
    the origin, y up, the camera looking down its -z."""
    back = origins / origins.norm(dim=-1, keepdim=True)
    up = torch.tensor([0.0, 1.0, 0.0], device=origins.device).expand_as(back)
    right = torch.linalg.cross(up, back, dim=-1)
    right = right / right.norm(dim=-1, keepdim=True)
    up = torch.linalg.cross(back, right, dim=-1)
    m = torch.eye(4, device=origins.device).repeat(origins.shape[0], 1, 1)
    m[:, :3, 0], m[:, :3, 1], m[:, :3, 2], m[:, :3, 3] = right, up, back, origins
    return m


def sphere_poses(gen: torch.Generator, n: int, radius: float, device) -> torch.Tensor:
    """n cameras on the sphere: azimuth uniform, elevation in [-10, 60] deg."""
    u = torch.rand(n, 2, generator=gen, device=device)
    az = u[:, 0] * 2 * math.pi
    el = math.radians(-10) + u[:, 1] * math.radians(70)
    o = torch.stack([torch.cos(el) * torch.sin(az), torch.sin(el), torch.cos(el) * torch.cos(az)], dim=-1)
    return look_at(radius * o)


def arc_poses(positions: torch.Tensor, count: int, radius: float, height: float) -> torch.Tensor:
    """Cameras at arc positions (0 .. count - 1, fractional allowed) of an
    arc of 2.2 rad about the scan."""
    a = 2.2 * positions / max(count - 1, 1) - 1.1
    o = torch.stack([radius * torch.sin(a), torch.full_like(a, height), radius * torch.cos(a)], dim=-1)
    return look_at(o)


def orbit_poses(num_views: int, elevation: float, radius: float, device) -> torch.Tensor:
    """NeRF's spherical poses (``pose_spherical``) at ``num_views`` azimuths
    evenly over the circle from -180 degrees, at ``elevation`` degrees and
    ``radius``, looking at the origin."""
    out = []
    for theta in np.linspace(-180, 180, num_views + 1)[:-1]:
        m = np.eye(4)
        m[2, 3] = radius
        p, t = math.radians(elevation), math.radians(theta)
        phi = np.array([[1, 0, 0, 0], [0, math.cos(p), -math.sin(p), 0], [0, math.sin(p), math.cos(p), 0], [0, 0, 0, 1]])
        th = np.array([[math.cos(t), 0, -math.sin(t), 0], [0, 1, 0, 0], [math.sin(t), 0, math.cos(t), 0], [0, 0, 0, 1]])
        flip = np.array([[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]])
        out.append(flip @ th @ phi @ m)
    return torch.tensor(np.stack(out), dtype=torch.float32, device=device)


def keyframe_poses(num_views: int, knots, quats, distance: float, device) -> torch.Tensor:
    """A periodic cubic spline through keyframe rotations (w, x, y, z) at
    ``knots``: ``num_views // 5`` poses a knot unit over all of them, each
    camera at ``distance`` along its own +z, looking at the origin."""
    from scipy.interpolate import CubicSpline

    knots = np.asarray(knots, np.float64)
    n = (num_views // 5) * int(knots[-1])
    q = CubicSpline(knots, np.asarray(quats, np.float64), bc_type="periodic")(np.linspace(knots[0], knots[-1], n))
    w, x, y, z = (q / np.linalg.norm(q, axis=-1, keepdims=True)).T
    r = np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w),
                  2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w),
                  2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], -1).reshape(n, 3, 3)
    m = np.tile(np.eye(4), (n, 1, 1))
    m[:, :3, :3], m[:, :3, 3] = r, distance * r[:, :, 2]
    return torch.tensor(m, dtype=torch.float32, device=device)


def trajectory(spec: dict, cam: dict, device) -> torch.Tensor:
    """The target cameras of a traffic mix's ``trajectory``."""
    if spec["kind"] == "orbit":
        return orbit_poses(spec["num_views"], spec["elevation"], cam["radius"], device)
    if spec["kind"] == "keyframes":
        return keyframe_poses(spec["num_views"], spec["knots"], spec["quats"], spec["distance"], device)
    raise ValueError(f"no trajectory kind {spec['kind']!r}")


def random_objects(gen: torch.Generator, n: int, device, spheres: int = 5) -> dict:
    u = torch.rand(n, spheres, 7, generator=gen, device=device)
    return {"centers": (u[..., :3] - 0.5) * 0.7, "radii": 0.12 + 0.16 * u[..., 3],
            "colors": 0.05 + 0.85 * u[..., 4:7]}


def render_objects(objs: dict, poses: torch.Tensor, height: int, width: int, focal: float, c) -> torch.Tensor:
    """uint8 (N, V, H, W, 3): objects (N) seen by cameras (N, V, 4, 4)."""
    dev = poses.device
    ys, xs = torch.meshgrid(torch.arange(height, device=dev, dtype=torch.float32),
                            torch.arange(width, device=dev, dtype=torch.float32), indexing="ij")
    d = torch.stack([(xs - c[0]) / focal, -(ys - c[1]) / focal, -torch.ones_like(xs)], dim=-1)
    d = d / d.norm(dim=-1, keepdim=True)
    dirs = torch.einsum("nvij,hwj->nvhwi", poses[..., :3, :3], d)              # (N, V, H, W, 3)
    o = poses[..., None, None, :3, 3]                                          # (N, V, 1, 1, 3)
    oc = o[..., None, :] - objs["centers"][:, None, None, None]                # (N, V, 1, 1, K, 3)
    b = (dirs[..., None, :] * oc).sum(-1)                                      # (N, V, H, W, K)
    cc = (oc * oc).sum(-1) - objs["radii"][:, None, None, None] ** 2
    disc = b * b - cc
    t = -b - torch.sqrt(torch.clamp(disc, min=0.0))
    t = torch.where((disc > 0) & (t > 0), t, torch.full_like(t, float("inf")))
    t_hit, k = t.min(dim=-1)
    hit = torch.isfinite(t_hit)
    p = o + torch.where(hit, t_hit, torch.zeros_like(t_hit))[..., None] * dirs
    centers = torch.gather(objs["centers"][:, None, None, None].expand(*k.shape, -1, 3), -2,
                           k[..., None, None].expand(*k.shape, 1, 3))[..., 0, :]
    normal = p - centers
    normal = normal / normal.norm(dim=-1, keepdim=True).clamp(min=1e-6)
    light = torch.tensor(LIGHT, device=dev)
    light = light / light.norm()
    colors = torch.gather(objs["colors"][:, None, None, None].expand(*k.shape, -1, 3), -2,
                          k[..., None, None].expand(*k.shape, 1, 3))[..., 0, :]
    shade = colors * (0.25 + 0.75 * torch.clamp((normal * light).sum(-1, keepdim=True), min=0.0))
    img = torch.where(hit[..., None], torch.clamp(torch.round(shade * 255), 0, 254), torch.full_like(shade, 255))
    return img.to(torch.uint8)


def smooth_views(gen: torch.Generator, n: int, height: int, width: int, device) -> torch.Tensor:
    """(n, H, W, 3) float32 in [-1, 1]: smooth colour fields and noise."""
    u = torch.rand(n, 3, 4, generator=gen, device=device)
    ys, xs = torch.meshgrid(torch.arange(height, device=device, dtype=torch.float32),
                            torch.arange(width, device=device, dtype=torch.float32), indexing="ij")
    fx = (15 + 30 * u[..., 0])[..., None, None]
    fy = (12 + 24 * u[..., 1])[..., None, None]
    field = torch.sin(xs / fx + 6.3 * u[..., 2, None, None]) * torch.cos(ys / fy - 6.3 * u[..., 3, None, None])
    noise = torch.rand(n, 3, height, width, generator=gen, device=device) - 0.5
    return torch.clamp(0.8 * field + 0.2 * noise, -1, 1).permute(0, 2, 3, 1).contiguous()


def to_unit(img_u8: torch.Tensor) -> torch.Tensor:
    """uint8 -> float32 in [-1, 1], as the readers map pixels."""
    return (img_u8.to(torch.float32) / 255.0 - 0.5) / 0.5


def numpy_rng(seed: int, *names) -> np.random.Generator:
    return np.random.default_rng(seeds.derive(seed, *names))
