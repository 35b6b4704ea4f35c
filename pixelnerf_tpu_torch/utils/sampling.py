"""Host-side pixel samplers for the training input pipeline (the port's
own copy of ``pixelnerf_tpu/utils/sampling.py``, numpy only, so that a seed
gives the same pixels in both packages)."""
from __future__ import annotations

import numpy as np


def bbox_sample(bboxes: np.ndarray, num_pix: int, rng: np.random.Generator) -> np.ndarray:
    """Sample pixels uniformly inside per-view bounding boxes.

    :param bboxes: (NV, 4) [x0, y0, x1, y1] inclusive boxes per view
    :return: (num_pix, 3) int rows of (image_id, y, x)
    """
    image_ids = rng.integers(0, bboxes.shape[0], size=num_pix)
    pix = bboxes[image_ids]
    x = (rng.random(num_pix) * (pix[:, 2] + 1 - pix[:, 0]) + pix[:, 0]).astype(np.int64)
    y = (rng.random(num_pix) * (pix[:, 3] + 1 - pix[:, 1]) + pix[:, 1]).astype(np.int64)
    return np.stack([image_ids, y, x], axis=-1)


def masked_sample(
    masks: np.ndarray,
    num_pix: int,
    prop_inside: float,
    rng: np.random.Generator,
    thresh: float = 0.5,
) -> np.ndarray:
    """Sample a mix of inside-mask / outside-mask pixels.

    :param masks: (NV, H, W) float masks
    :return: (num_pix, 3) int rows of (image_id, y, x)
    """
    num_inside = int(num_pix * prop_inside + 0.5)
    num_outside = num_pix - num_inside
    inside = np.argwhere(masks >= thresh)
    outside = np.argwhere(masks < thresh)
    pix_inside = inside[rng.integers(0, inside.shape[0], size=num_inside)]
    pix_outside = outside[rng.integers(0, outside.shape[0], size=num_outside)]
    return np.concatenate([pix_inside, pix_outside], axis=0)


def uniform_pixel_sample(
    num_views: int, height: int, width: int, num_pix: int, rng: np.random.Generator
) -> np.ndarray:
    """Uniform pixel sample over all views (reference train/train.py:171)."""
    flat = rng.integers(0, num_views * height * width, size=num_pix)
    image_ids = flat // (height * width)
    rem = flat % (height * width)
    return np.stack([image_ids, rem // width, rem % width], axis=-1)
