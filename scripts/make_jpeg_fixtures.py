"""Write the committed JPEG fixtures of ``tests/fixtures/jpeg/`` and their
expected decodes.

Each file is written by Pillow (libjpeg-turbo) from content made with numpy
from a seed, or from ``raw/photo1.png``; ``expected.npz`` holds
``imageio.v2.imread``'s decode of each, keyed by the file's name without its
extension. The port's JPEG reader (``pixelnerf_tpu_torch/utils/jpeg.py``) is
held to these decodes on a machine without an imaging library
(``chip_smoke.py``), and ``tests/test_torch_jpeg.py`` holds them to
imageio's decode of the committed files, so that they cannot go stale.

The kinds: 4:4:4, 4:2:2 and 4:2:0 sampling, gray, restart markers, optimised
Huffman tables, Adobe RGB (no colour transform), progressive colour and
gray, quality 1, odd sizes (one whose chroma is 2 samples wide), the photo at
quality 90 and 4:2:0, a 400x300 textured image (the size of a DTU view) at
quality 95, and the views of an NMR-layout object (``nmr_*.jpg``, 64x64).

    python scripts/make_jpeg_fixtures.py [--out tests/fixtures/jpeg]

Needs numpy, Pillow and imageio; the port does not import it.
"""
from __future__ import annotations

import argparse
import os

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NMR_VIEWS = 6


def smooth(rng, h, w, channels=3, noise=12.0):
    """Sinusoids of a few frequencies per channel, and noise."""
    yy, xx = np.mgrid[:h, :w].astype(np.float64)
    planes = [128 + 90 * np.sin(xx / (2.5 + 1.3 * k) + yy / (4.0 + 0.7 * k) + k) for k in range(channels)]
    img = np.stack(planes, -1) + rng.normal(0.0, noise, (h, w, channels))
    img = np.clip(img, 0, 255).astype(np.uint8)
    return img[..., 0] if channels == 1 else img


def fixtures(rng):
    """(name, uint8 image, Pillow save options), in a fixed order."""
    import imageio.v2 as imageio

    photo = imageio.imread(os.path.join(REPO, "raw", "photo1.png"))[..., :3]
    out = [
        ("s444", smooth(rng, 29, 37), dict(quality=90, subsampling=0)),
        ("s422", smooth(rng, 29, 37), dict(quality=90, subsampling=1)),
        ("s420", smooth(rng, 29, 37), dict(quality=90, subsampling=2)),
        ("gray", smooth(rng, 29, 37, 1), dict(quality=90)),
        ("restart", smooth(rng, 45, 61), dict(quality=90, subsampling=2, restart_marker_blocks=3)),
        ("optimize", smooth(rng, 45, 61), dict(quality=90, subsampling=2, optimize=True)),
        ("adobe_rgb", smooth(rng, 29, 37), dict(quality=90, subsampling=0, keep_rgb=True)),
        ("progressive", smooth(rng, 45, 61), dict(quality=90, subsampling=2, progressive=True)),
        ("progressive_gray", smooth(rng, 45, 61, 1), dict(quality=75, progressive=True)),
        ("quality1", smooth(rng, 33, 33), dict(quality=1, subsampling=1)),
        ("odd_3x5", smooth(rng, 5, 3), dict(quality=90, subsampling=2)),
        ("odd_11x7", smooth(rng, 7, 11), dict(quality=90, subsampling=2)),
        ("photo1", photo, dict(quality=90, subsampling=2)),
        ("texture_400x300", smooth(rng, 300, 400, noise=30.0), dict(quality=95, subsampling=2)),
    ]
    out += [(f"nmr_{v:04d}", smooth(rng, 64, 64, noise=6.0), dict(quality=90, subsampling=2))
            for v in range(NMR_VIEWS)]
    return out


def main(argv=None):
    import imageio.v2 as imageio
    from PIL import Image

    parser = argparse.ArgumentParser()
    parser.add_argument("--out", default=os.path.join(REPO, "tests", "fixtures", "jpeg"))
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    expected = {}
    for name, img, opts in fixtures(np.random.default_rng(args.seed)):
        path = os.path.join(args.out, f"{name}.jpg")
        Image.fromarray(img).save(path, **opts)
        expected[name] = imageio.imread(path)
    np.savez_compressed(os.path.join(args.out, "expected.npz"), **expected)
    total = sum(os.path.getsize(os.path.join(args.out, f)) for f in os.listdir(args.out))
    print(f"wrote {len(expected)} JPEG files and expected.npz to {args.out}: {total} bytes")


if __name__ == "__main__":
    main()
