"""Fixed-shape ray-batch input pipeline (the port's own copy of
``pixelnerf_tpu/data/pipeline.py``, numpy only, so a seed gives the same
batches in both packages): a host-side pipeline that emits fixed-shape
numpy batches:

    images (SB, NS, H, W, 3) in [-1, 1]   source views
    poses  (SB, NS, 4, 4)                 camera-to-world
    focal  (SB,) or (SB, 2); c (SB, 2) optional
    rays   (SB, R, 8)                     target rays at sampled pixels
    rgb_gt (SB, R, 3) in [0, 1]           ground-truth pixels

Sampling semantics match the reference: bbox-biased pixel sampling until
``no_bbox_step`` then uniform over NV*H*W (train.py:128-176), and a random
1-or-2 source-view count drawn per *batch* (train.py:138-156). All dynamic
shape decisions happen here on the host.
"""
from __future__ import annotations

import queue
import threading
from typing import Optional, Sequence

import numpy as np

from ..utils.sampling import bbox_sample, uniform_pixel_sample


def gen_rays_at(
    poses: np.ndarray,
    pix: np.ndarray,
    focal,
    c,
    z_near: float,
    z_far: float,
) -> np.ndarray:
    """Rays through selected pixels only (host-side numpy).

    :param poses: (NV, 4, 4) camera-to-world
    :param pix: (R, 3) int rows (image_id, y, x)
    :param focal: scalar or (2,) [fx, fy]; c: (2,) [cx, cy]
    :return: (R, 8) [origin, dir, near, far]
    """
    focal = np.broadcast_to(np.atleast_1d(np.asarray(focal, np.float32)), (2,))
    c = np.asarray(c, np.float32)
    ids, ys, xs = pix[:, 0], pix[:, 1].astype(np.float32), pix[:, 2].astype(np.float32)
    dirs = np.stack(
        [
            (xs - c[0]) / focal[0],
            -(ys - c[1]) / focal[1],
            -np.ones_like(xs),
        ],
        axis=-1,
    )
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    rot = poses[ids, :3, :3]                       # (R, 3, 3)
    dirs_w = np.einsum("rij,rj->ri", rot, dirs)
    origins = poses[ids, :3, 3]
    nf = np.empty((pix.shape[0], 2), np.float32)
    nf[:, 0] = z_near
    nf[:, 1] = z_far
    return np.concatenate([origins, dirs_w, nf], axis=-1).astype(np.float32)


class RayBatchPipeline:
    """Infinite iterator of fixed-shape training batches with prefetch."""

    def __init__(
        self,
        dataset,
        batch_size: int = 4,
        rays_per_object: int = 128,
        views: Sequence[int] = (1,),
        no_bbox_step: int = 100000,
        fixed_source_views: Optional[Sequence[int]] = None,
        seed: int = 0,
        prefetch: int = 2,
        workers: int = 4,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.rays_per_object = rays_per_object
        self.views = tuple(views)
        self.no_bbox_step = no_bbox_step
        self.fixed_source_views = fixed_source_views
        self.rng = np.random.default_rng(seed)
        self.prefetch = prefetch
        self.workers = workers
        self.step = 0

    # -- single-object batch entry ------------------------------------------

    def _object_entry(self, data, num_source: int):
        images = data["images"]                    # (NV, H, W, 3) in [-1,1]
        poses = data["poses"]
        NV, H, W, _ = images.shape

        if self.fixed_source_views is not None:
            src = np.asarray(self.fixed_source_views[:num_source])
        else:
            src = self.rng.choice(NV, num_source, replace=False)

        use_bbox = self.step < self.no_bbox_step and data.get("bbox") is not None
        if use_bbox:
            pix = bbox_sample(np.asarray(data["bbox"]), self.rays_per_object, self.rng)
        else:
            pix = uniform_pixel_sample(NV, H, W, self.rays_per_object, self.rng)
        pix[:, 1] = np.clip(pix[:, 1], 0, H - 1)
        pix[:, 2] = np.clip(pix[:, 2], 0, W - 1)

        focal = np.asarray(data["focal"], np.float32)
        c = np.asarray(
            data.get("c", np.array([W * 0.5, H * 0.5], np.float32)), np.float32
        )
        rays = gen_rays_at(
            poses, pix, focal, c, self.dataset.z_near, self.dataset.z_far
        )
        rgb_gt = images[pix[:, 0], pix[:, 1], pix[:, 2]] * 0.5 + 0.5
        return {
            "images": images[src],
            "poses": poses[src],
            "focal": focal,
            "c": c,
            "rays": rays,
            "rgb_gt": rgb_gt.astype(np.float32),
        }

    def _object_stream(self):
        """Shuffled epoch stream of object dicts.

        Objects are fetched by a small thread pool with bounded lookahead —
        real datasets decode ~50 images per object (the reference used 8
        DataLoader workers; trainer.py:16-29), and a single-threaded fetch
        would starve the accelerator."""
        n = len(self.dataset)

        def indices():
            while True:
                yield from self.rng.permutation(n)

        if self.workers <= 1:
            for i in indices():
                data = self.dataset[int(i)]
                if data:  # skip malformed-scene sentinel {}
                    yield data
            return

        import concurrent.futures as cf

        idx_iter = indices()
        with cf.ThreadPoolExecutor(max_workers=self.workers) as pool:
            pending = [
                pool.submit(self.dataset.__getitem__, int(next(idx_iter)))
                for _ in range(self.workers * 2)
            ]
            k = 0
            while True:
                fut = pending[k % len(pending)]
                data = fut.result()
                pending[k % len(pending)] = pool.submit(
                    self.dataset.__getitem__, int(next(idx_iter))
                )
                k += 1
                if data:
                    yield data

    def batches(self):
        stream = self._object_stream()
        while True:
            num_source = int(self.rng.choice(self.views))
            entries = [
                self._object_entry(next(stream), num_source)
                for _ in range(self.batch_size)
            ]
            batch = {
                k: np.stack([e[k] for e in entries]) for k in entries[0]
            }
            batch["step"] = self.step
            # one optimizer step per batch (reference train.py compares
            # global_step, which advances once per batch, to no_bbox_step)
            self.step += 1
            yield batch

    def __iter__(self):
        """Prefetching iterator (daemon thread, bounded queue)."""
        if self.prefetch <= 0:
            yield from self.batches()
            return
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = object()

        def worker():
            try:
                for b in self.batches():
                    q.put(b)
            finally:
                q.put(stop)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            b = q.get()
            if b is stop:
                return
            yield b
