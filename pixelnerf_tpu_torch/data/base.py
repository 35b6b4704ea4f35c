"""Dataset protocol + host-side helpers (numpy, NHWC; the port's own copy
of ``pixelnerf_tpu/data/base.py``, without the image readers' helpers).

Every adapter returns, per object, a dict with the same schema as the
reference's datasets (SURVEY §2: src/data/*):

    {
      "path": str, "img_id": int,
      "focal": float | (2,) array,
      "c": (2,) array (optional),
      "images": (NV, H, W, 3) float32 in [-1, 1],
      "masks":  (NV, H, W, 1) float32 (optional),
      "bbox":   (NV, 4) float32 [x0, y0, x1, y1] (optional),
      "poses":  (NV, 4, 4) float32 camera-to-world,
    }

plus dataset attributes ``z_near``, ``z_far``. Layout is NHWC,
as in the JAX package.
"""
from __future__ import annotations

import numpy as np


def mask_bbox(mask: np.ndarray) -> np.ndarray:
    """Tight bounding box of nonzero mask pixels: [cmin, rmin, cmax, rmax]."""
    m = np.asarray(mask)
    if m.ndim == 3:
        m = m[..., 0]
    rows = np.any(m, axis=1)
    cols = np.any(m, axis=0)
    rnz = np.where(rows)[0]
    cnz = np.where(cols)[0]
    if len(rnz) == 0:
        raise RuntimeError("Empty mask: no nonzero pixels")
    rmin, rmax = rnz[[0, -1]]
    cmin, cmax = cnz[[0, -1]]
    return np.array([cmin, rmin, cmax, rmax], dtype=np.float32)


class DatasetBase:
    """Minimal sequence protocol shared by all adapters, plus an optional
    bounded decoded-object cache (re-decoding every object on every pull
    starves a fast step loop). Adapters opt in by calling
    :meth:`_cache_setup` and wrapping ``__getitem__`` in :meth:`_cache_get`
    / :meth:`_cache_put`. FIFO eviction is pop-defensive because the ray
    pipeline fetches from a thread pool."""

    z_near: float
    z_far: float

    def __len__(self) -> int:  # pragma: no cover - abstract
        raise NotImplementedError

    def __getitem__(self, index: int) -> dict:  # pragma: no cover - abstract
        raise NotImplementedError

    def _cache_setup(self, cache_cap: int) -> None:
        self._cache: dict = {}
        self._cache_cap = int(cache_cap)

    def _cache_get(self, index):
        return self._cache.get(index) if self._cache_cap else None

    def _cache_put(self, index, data):
        if not self._cache_cap:
            return data
        while len(self._cache) >= self._cache_cap:
            try:
                self._cache.pop(next(iter(self._cache)), None)
            except (StopIteration, RuntimeError):
                break
        self._cache[index] = data
        return data
