"""Dataset protocol + host-side image helpers (numpy, NHWC; the port's own
copy of ``pixelnerf_tpu/data/base.py``).

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

plus dataset attributes ``z_near``, ``z_far``, ``lindisp``. Layout is
NHWC, as in the JAX package.
"""
from __future__ import annotations

import numpy as np

from ..ops.resize import _area_matrix


def image_to_tensor(img: np.ndarray) -> np.ndarray:
    """uint8 (H, W, 3) -> float32 [-1, 1] (reference util.py:68-75 transform)."""
    img = np.asarray(img, dtype=np.float32) / 255.0
    return (img - 0.5) / 0.5


def mask_to_tensor(mask: np.ndarray) -> np.ndarray:
    """uint8 (H, W) or (H, W, 1) -> float32 (H, W, 1) in [0, 1]."""
    mask = np.asarray(mask, dtype=np.float32) / 255.0
    if mask.ndim == 2:
        mask = mask[..., None]
    return mask[..., :1]


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


def resize_area_np(images: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Adaptive-average ('area') downscale of (N, H, W, C), torch-compatible."""
    _, h, w, _ = images.shape
    if (h, w) == (out_h, out_w):
        return images
    mh = _area_matrix(out_h, h)
    mw = _area_matrix(out_w, w)
    x = np.einsum("oh,nhwc->nowc", mh, images.astype(np.float32))
    return np.einsum("pw,nowc->nopc", mw, x)


class DatasetBase:
    """Minimal sequence protocol shared by all adapters, plus an optional
    bounded decoded-object cache (re-decoding every object on every pull
    starves a fast step loop). Adapters opt in by calling
    :meth:`_cache_setup` and wrapping ``__getitem__`` in :meth:`_cache_get`
    / :meth:`_cache_put`. FIFO eviction is pop-defensive because the ray
    pipeline fetches from a thread pool."""

    z_near: float
    z_far: float
    lindisp: bool = False

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
