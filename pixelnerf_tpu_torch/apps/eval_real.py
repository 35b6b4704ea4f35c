"""Real-image inference (counterpart of ``pixelnerf_tpu/apps/eval_real.py``):
encode a single preprocessed ``*_normalize.png`` with a dummy pose and
render an orbit around it. Runs on the GPU (``--device cuda``, the
default) unless asked for the CPU.

The SRN-car conventions: the dummy camera at z = ``--radius`` (1.3)
looking at the origin, focal 131.25 for 128x128, z in [0.8, 1.8].

Where the JAX app writes an mp4 (or, with ``--gif`` or without an mp4
encoder, a GIF), the port writes the GIF: its host has no mp4 encoder. An
input whose size differs from ``--size`` is area-resized as OpenCV's
``INTER_AREA`` resizes uint8 images, for factors of 1, 2 and 4 per axis
only; other sizes and JPEG inputs raise ``NotImplementedError``.

    python -m pixelnerf_tpu_torch.apps.eval_real -n srn_car --input input/
"""
from __future__ import annotations

import glob
import os

import numpy as np
import torch

from ..config import ConfigNode
from ..eval.common import FullRenderer, resize_area_like_cv2
from ..render.renderer import RenderConfig
from ..utils import geometry, gif, png
from .args import parse_args
from .eval import load_net_and_state
from .gen_video import render_frames


def extra_args(parser):
    parser.add_argument("--input", type=str, default="input",
                        help="image file, glob, or directory of *_normalize.png")
    parser.add_argument("--output", "-O", type=str, default="real_out")
    parser.add_argument("--size", type=int, default=128)
    parser.add_argument("--focal", type=float, default=131.25)
    parser.add_argument("--radius", type=float, default=1.3)
    parser.add_argument("--z_near", type=float, default=0.8)
    parser.add_argument("--z_far", type=float, default=1.8)
    parser.add_argument("--elevation", type=float, default=0.0)
    parser.add_argument("--num_views", type=int, default=24)
    parser.add_argument("--fps", type=int, default=15)
    parser.add_argument(
        "--out_size", type=str, default=None,
        help="render size, 1 or 2 numbers 'W' or 'W H' (default: --size). "
        "Reference quirk preserved: focal is NOT rescaled, so a larger "
        "out_size widens the field of view",
    )
    parser.add_argument("--gif", action="store_true",
                        help="store a GIF (the port always does: it has no mp4 encoder)")
    parser.add_argument("--no_vid", action="store_true",
                        help="skip the video; only frame PNGs are written")
    parser.add_argument("--seed", type=int, default=0)


def gather_inputs(spec: str):
    if os.path.isdir(spec):
        return sorted(glob.glob(os.path.join(spec, "*_normalize.png")))
    hits = sorted(glob.glob(spec))
    return [h for h in hits if h.lower().endswith((".png", ".jpg", ".jpeg"))]


def resize_uint8_like_cv2(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """``cv2.resize(img, (out_w, out_h), interpolation=cv2.INTER_AREA)`` of
    an (H, W, C) uint8 image, for downscales by 1, 2 or 4 per axis: each
    block's mean (exact in float32 for uint8 sums), rounded half up by
    OpenCV's 2x2 path and half to even by its other integer-factor path.
    Other sizes raise ``NotImplementedError`` (``resize_area_like_cv2``)."""
    mean = resize_area_like_cv2(img.astype(np.float32), out_h, out_w)
    if (img.shape[0] // out_h, img.shape[1] // out_w) == (2, 2):
        return np.floor(mean + 0.5).astype(np.uint8)
    return np.rint(mean).astype(np.uint8)


def read_input(path: str, size: int) -> np.ndarray:
    """The image at ``path`` as a (size, size, 3) array in [-1, 1]."""
    if not path.lower().endswith(".png"):
        raise NotImplementedError(
            f"{path}: the port decodes PNG files only (its machines have no JPEG decoder); "
            "convert the image to PNG"
        )
    img = png.imread(path)[..., :3]
    if img.shape[:2] != (size, size):
        img = resize_uint8_like_cv2(img, size, size)
    return (img.astype(np.float32) / 255.0 - 0.5) / 0.5


def main(argv=None):
    args, conf = parse_args(extra_args, argv=argv)
    device = torch.device(args.device)
    inputs = gather_inputs(args.input)
    if not inputs:
        raise FileNotFoundError(f"no input images matched {args.input!r}")

    cfg = RenderConfig.from_conf(conf.get_config("renderer", ConfigNode()))
    H = W = args.size
    # the render's size; the encode stays at --size
    if args.out_size:
        sz = [int(x) for x in args.out_size.split()]
        out_w, out_h = (sz[0], sz[0]) if len(sz) == 1 else (sz[0], sz[1])
    else:
        out_w, out_h = W, H
    # the dummy camera: identity rotation at z = radius
    cam_pose = np.eye(4, dtype=np.float32)
    cam_pose[2, 3] = args.radius

    net = load_net_and_state(args, conf, device)
    renderer = FullRenderer(net, cfg, ray_chunk=args.ray_batch_size)

    os.makedirs(args.output, exist_ok=True)
    # a spherical orbit, its poses taken from Blender's axes
    from_blender = geometry.coord_from_blender()
    angles = np.linspace(-180, 180, args.num_views + 1)[:-1]
    render_poses = np.stack([from_blender @ geometry.pose_spherical(a, args.elevation, args.radius) for a in angles])
    rays = geometry.gen_rays(render_poses, out_w, out_h, args.focal, args.z_near, args.z_far, device=device)

    generator = torch.Generator(device=device).manual_seed(args.seed)
    for img_path in inputs:
        image = read_input(img_path, args.size)
        with torch.inference_mode():
            enc = net.encode(
                torch.from_numpy(image[None, None]).to(device),
                torch.from_numpy(cam_pose[None, None]).to(device),
                torch.as_tensor(args.focal),
            )
        frames = list(render_frames(renderer, enc, rays, generator))
        base = os.path.splitext(os.path.basename(img_path))[0]
        frames_dir = os.path.join(args.output, f"{base}_frames")
        os.makedirs(frames_dir, exist_ok=True)
        for i, frame in enumerate(frames):
            png.imwrite(os.path.join(frames_dir, f"{i:04}.png"), frame)
        if not args.no_vid:
            gif.mimwrite(os.path.join(args.output, f"{base}.gif"), frames, duration=1000 / args.fps)
        print("Rendered", base)


if __name__ == "__main__":
    main()
