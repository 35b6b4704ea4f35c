#!/usr/bin/env python
"""Produce the photo-like raw inputs of the real-image walkthrough with the
PyTorch port's own modules (counterpart of ``scripts/make_real_input.py``:
the same arguments, the same scenes and draws; its PNGs hold the committed
``raw/photo1.png`` and ``raw/photo2.png``).

The stand-in photo is an unseen synthetic sphere scene (a test-stage seed,
never trained on) over a cluttered backdrop that is not white, with a soft
drop shadow, a vignette and sensor noise, placed off centre: everything the
GrabCut preprocessor has to undo (segment, fit the ellipse, crop, composite
on white, resize). OpenCV's ``connectedComponents`` and ``GaussianBlur``
are the port's ``utils/imgproc.py`` ``count_components`` and
``gaussian_blur``.

    python scripts/make_real_input_torch.py --out raw/
then
    python -m pixelnerf_tpu_torch.apps.preproc --input raw --output input
    python -m pixelnerf_tpu_torch.apps.eval_real -n <exp> --input input ...
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pixelnerf_tpu_torch.data.synthetic import SyntheticSphereDataset  # noqa: E402
from pixelnerf_tpu_torch.utils import png  # noqa: E402
from pixelnerf_tpu_torch.utils.imgproc import count_components, gaussian_blur  # noqa: E402


def make_photo(seed: int, size: int = 420, obj_px: int = 240, offset=(0.1, -0.06)):
    """One photo-like image: a rendered unseen scene over clutter."""
    # test stage: scenes disjoint from every training stage. Search a few
    # (scene, view) pairs for one whose silhouette is a single connected
    # component (the segmenter keeps the largest component)
    ds = SyntheticSphereDataset(num_objects=8, num_views=4, image_size=(obj_px, obj_px), stage="test", seed=seed)
    rgb = mask = None
    for obj in range(8):
        for v in range(4):
            r, _d, m = ds.render_view((seed + obj) % 8, ds._poses((seed + obj) % 8)[v])
            if count_components(m.astype(np.uint8)) == 2 and m.mean() > 0.08:  # background + one blob
                rgb, mask = r, m
                break
        if rgb is not None:
            break
    assert rgb is not None, "no single-component view found"

    rng = np.random.default_rng(100 + seed)
    # product-style backdrop: a muted warm gradient and a few faint blobs,
    # not white, so that the white composite is observable
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    base = np.array([0.62, 0.58, 0.52], np.float32)
    bg = base[None, None] * (0.8 + 0.3 * (1 - yy))[..., None]
    for _ in range(5):
        cx, cy, r = rng.uniform(0, 1, 3)
        col = base * rng.uniform(0.85, 1.1)
        d2 = (xx - cx) ** 2 + (yy - cy) ** 2
        w = np.exp(-d2 / (0.03 + 0.1 * r))[..., None]
        bg = bg * (1 - 0.3 * w) + col * 0.3 * w

    # the object off centre with a soft drop shadow
    oy = int(size * (0.5 + offset[1]) - obj_px / 2)
    ox = int(size * (0.5 + offset[0]) - obj_px / 2)
    img = bg.copy()
    m = mask.astype(np.float32)
    sh = gaussian_blur(m, obj_px * 0.04)          # the shadow: the mask blurred, shifted down-right
    sy, sx = oy + int(obj_px * 0.06), ox + int(obj_px * 0.04)
    img[sy:sy + obj_px, sx:sx + obj_px] *= (1 - 0.45 * sh)[..., None]
    patch = img[oy:oy + obj_px, ox:ox + obj_px]
    img[oy:oy + obj_px, ox:ox + obj_px] = patch * (1 - m[..., None]) + rgb * m[..., None]

    # vignette, sensor noise and a mild gamma, like a phone photo
    r2 = (xx - 0.5) ** 2 + (yy - 0.5) ** 2
    img *= (1.0 - 0.35 * r2)[..., None]
    img = np.clip(img + rng.normal(0, 0.012, img.shape), 0, 1) ** 1.05
    return (img * 255).astype(np.uint8)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="raw")
    ap.add_argument("--count", type=int, default=2)
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    for i in range(args.count):
        path = os.path.join(args.out, f"photo{i + 1}.png")
        png.imwrite(path, make_photo(seed=i + 1))
        print("wrote", path)


if __name__ == "__main__":
    main()
