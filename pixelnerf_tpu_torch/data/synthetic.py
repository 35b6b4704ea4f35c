"""Procedural synthetic dataset: analytically ray-traced sphere scenes (the
port's own copy of ``pixelnerf_tpu/data/synthetic.py``, numpy only, so a
seed gives the same scenes in both packages).

Self-contained replacement for downloaded SRN/DVR data in tests, demos and
benchmarks. Each "object" is a deterministic arrangement of colored lambertian spheres
rendered from known cameras, so poses/intrinsics/geometry are exact and an
overfit run has a well-defined target.
"""
from __future__ import annotations

import numpy as np

from ..utils.geometry import look_at
from .base import DatasetBase, mask_bbox


def _trace_spheres(origins, dirs, centers, radii, colors, light_dir, bg=1.0):
    """Analytic sphere ray-tracer. origins/dirs (N, 3) -> rgb (N, 3), depth, mask."""
    N = origins.shape[0]
    best_t = np.full(N, np.inf, dtype=np.float32)
    rgb = np.full((N, 3), bg, dtype=np.float32)
    for c, r, col in zip(centers, radii, colors):
        oc = origins - c
        b = np.sum(oc * dirs, axis=-1)
        cq = np.sum(oc * oc, axis=-1) - r * r
        disc = b * b - cq
        hit = disc > 0
        sq = np.sqrt(np.maximum(disc, 0.0))
        t = -b - sq
        hit &= (t > 1e-3) & (t < best_t)
        if not hit.any():
            continue
        p = origins[hit] + t[hit, None] * dirs[hit]
        n = (p - c) / r
        lam = np.clip(np.einsum("nd,d->n", n, -light_dir), 0.0, 1.0)
        shade = 0.35 + 0.65 * lam
        rgb[hit] = col[None, :] * shade[:, None]
        best_t[hit] = t[hit]
    mask = np.isfinite(best_t)
    depth = np.where(mask, best_t, 0.0).astype(np.float32)
    return rgb, depth, mask


class SyntheticSphereDataset(DatasetBase):
    """Deterministic multi-view sphere scenes.

    :param num_objects: number of distinct scenes
    :param num_views: cameras per scene (ring + elevation jitter)
    :param image_size: (H, W)
    """

    def __init__(
        self,
        num_objects: int = 8,
        num_views: int = 12,
        image_size=(64, 64),
        num_spheres: int = 3,
        radius: float = 2.0,
        seed: int = 0,
        stage: str = "train",
        white_bkgd: bool = True,
        cache_cap: int = 128,
    ):
        # stage shifts the seed so train/val/test scenes differ
        stage_offset = {"train": 0, "val": 10_000, "test": 20_000}.get(stage, 0)
        self.seed = seed + stage_offset
        self.num_objects = num_objects
        self.num_views = num_views
        self.image_size = tuple(image_size)
        self.num_spheres = num_spheres
        self.radius = radius
        self.z_near = radius - 1.0
        self.z_far = radius + 1.0
        self.white_bkgd = white_bkgd
        H, W = self.image_size
        # focal may be overridden post-init with a scalar or an (fx, fy)
        # pair — per-axis intrinsics are the DTU convention
        # (reference DVRDataset.py:157-238)
        self.focal = 1.2 * W
        self.c = np.array([W * 0.5, H * 0.5], dtype=np.float32)
        # scenes are deterministic per index, so cache decoded objects
        # (bounded FIFO; ~1 MB/object at 8 views 128²) — re-tracing every
        # epoch pull otherwise starves a fast accelerator step. For large
        # num_objects, raise via --override data.cache_cap=<num_objects>
        # (a thrashing cache costs 2-3x step time; 125 GB host RAM holds
        # thousands of scenes easily)
        self._cache_setup(cache_cap)

    def __len__(self):
        return self.num_objects

    def _scene(self, index):
        rng = np.random.default_rng(self.seed + index)
        k = self.num_spheres
        centers = rng.uniform(-0.45, 0.45, size=(k, 3)).astype(np.float32)
        radii = rng.uniform(0.18, 0.32, size=k).astype(np.float32)
        colors = rng.uniform(0.2, 1.0, size=(k, 3)).astype(np.float32)
        light = rng.normal(size=3).astype(np.float32)
        light /= np.linalg.norm(light)
        return centers, radii, colors, light

    def _poses(self, index):
        rng = np.random.default_rng(self.seed + 7919 * (index + 1))
        poses = []
        for v in range(self.num_views):
            theta = 2 * np.pi * v / self.num_views + rng.uniform(0, 0.3)
            phi = rng.uniform(-0.5, 0.5)
            eye = self.radius * np.array(
                [
                    np.cos(phi) * np.sin(theta),
                    np.sin(phi),
                    np.cos(phi) * np.cos(theta),
                ]
            )
            poses.append(look_at(eye.astype(np.float32), np.zeros(3)))
        return np.stack(poses)

    def render_view(self, index: int, pose: np.ndarray):
        """Analytic render of one scene from one camera. Returns
        (rgb (H,W,3) in [0,1], depth (H,W), mask (H,W))."""
        H, W = self.image_size
        centers, radii, colors, light = self._scene(index)
        ys, xs = np.meshgrid(
            np.arange(H, dtype=np.float32), np.arange(W, dtype=np.float32),
            indexing="ij",
        )
        f = np.broadcast_to(
            np.asarray(self.focal, np.float32).reshape(-1), (2,)
        )
        dirs = np.stack(
            [
                (xs - self.c[0]) / f[0],
                -(ys - self.c[1]) / f[1],
                -np.ones_like(xs),
            ],
            axis=-1,
        )
        dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
        dirs_w = dirs.reshape(-1, 3) @ pose[:3, :3].T
        origins = np.broadcast_to(pose[:3, 3], dirs_w.shape).astype(np.float32)
        bg = 1.0 if self.white_bkgd else 0.0
        rgb, depth, mask = _trace_spheres(
            origins.reshape(-1, 3), dirs_w.astype(np.float32),
            centers, radii, colors, light, bg,
        )
        return (
            rgb.reshape(H, W, 3),
            depth.reshape(H, W),
            mask.reshape(H, W),
        )

    def __getitem__(self, index):
        cached = self._cache_get(index)
        if cached is not None:
            return cached
        poses = self._poses(index)
        imgs, masks, bboxes = [], [], []
        for v in range(self.num_views):
            rgb, _depth, mask = self.render_view(index, poses[v])
            imgs.append(rgb * 2.0 - 1.0)
            m = mask.astype(np.float32)[..., None]
            masks.append(m)
            bboxes.append(
                mask_bbox(m)
                if mask.any()
                else np.array([0, 0, self.image_size[1], self.image_size[0]], np.float32)
            )
        data = {
            "path": f"synthetic/{index:04d}",
            "img_id": index,
            "focal": np.asarray(self.focal, np.float32)
            if np.ndim(self.focal) else np.float32(self.focal),
            "c": self.c.copy(),
            "images": np.stack(imgs).astype(np.float32),
            "masks": np.stack(masks),
            "bbox": np.stack(bboxes),
            "poses": poses.astype(np.float32),
        }
        return self._cache_put(index, data)
