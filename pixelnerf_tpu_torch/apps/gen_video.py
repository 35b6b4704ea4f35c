"""Novel-view video generation (counterpart of
``pixelnerf_tpu/apps/gen_video.py``): encode source views of one object,
render an orbit (ShapeNet-style 360-degree spherical poses), a smooth
spline through the dataset's poses, or DTU's keyframe path, and write the
frames as a GIF beside a source-view strip. Runs on the GPU (``--device
cuda``, the default) unless asked for the CPU.

The JAX app writes an mp4 where imageio-ffmpeg is installed and a GIF
otherwise; the port's host has no mp4 encoder, so it always writes the GIF
(``utils/gif.py``).

    python -m pixelnerf_tpu_torch.apps.gen_video -n srn_car -F srn -D <data>/cars -P "64" \
        --subset 0 --num_views 40
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from ..config import ConfigNode
from ..data import dataset_kwargs_from_conf, get_split_dataset
from ..eval.common import FullRenderer
from ..render.renderer import RenderConfig
from ..utils import geometry, gif, png
from ..parallel.mesh import is_main_process
from .args import device_and_mesh, parse_args
from .eval import load_net_and_state


def extra_args(parser):
    parser.add_argument("--subset", "-S", type=int, default=0, help="object index")
    parser.add_argument("--split", type=str, default="test")
    parser.add_argument("--source", "-P", type=str, default="64")
    parser.add_argument("--num_views", type=int, default=40)
    parser.add_argument("--elevation", type=float, default=-10.0)
    parser.add_argument("--radius", type=float, default=0.0,
                        help="orbit radius; 0 = infer from source poses")
    parser.add_argument("--scale", type=float, default=1.0)
    parser.add_argument("--fps", type=int, default=30)
    parser.add_argument("--traj", type=str, default="auto",
                        choices=["auto", "spherical", "spline", "dtu"],
                        help="auto = dtu keyframes for DTU datasets, "
                             "spherical orbit otherwise (reference behavior)")
    parser.add_argument("--output", "-O", type=str, default="video_out")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--no_mesh", action="store_true",
                        help="no mesh of ranks even under torchrun (each process renders alone)")


def spherical_trajectory(num_views, elevation, radius):
    angles = np.linspace(-180, 180, num_views + 1)[:-1]
    return np.stack([geometry.pose_spherical(a, elevation, radius) for a in angles])


def _poses_from(R: np.ndarray, t: np.ndarray) -> np.ndarray:
    out = np.tile(np.eye(4, dtype=np.float32), (len(R), 1, 1))
    out[:, :3, :3] = R
    out[:, :3, 3] = t
    return out


def spline_trajectory(poses, num_views):
    """Periodic cubic spline through the given camera poses, the loop
    closed through the first pose (quaternions and translations splined
    apart, the quaternions renormalised)."""
    from scipy.interpolate import CubicSpline

    quats = geometry.rot_to_quat(poses[:, :3, :3])
    trans = poses[:, :3, 3]
    quats = np.concatenate([quats, quats[:1]], axis=0)
    trans = np.concatenate([trans, trans[:1]], axis=0)
    ts = np.arange(len(quats), dtype=np.float64)
    q_spline = CubicSpline(ts, quats, bc_type="periodic")
    t_spline = CubicSpline(ts, trans, bc_type="periodic")
    t_eval = np.linspace(0, len(quats) - 1, num_views, endpoint=False)
    q = q_spline(t_eval)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return _poses_from(geometry.quat_to_rot(q.astype(np.float32)), t_spline(t_eval))


# IDR's DTU camera keyframes (the reference's pose interpolation constants,
# dataset metadata like the view lists)
_DTU_T_IN = np.array([0.0, 2.0, 3.0, 5.0, 6.0], dtype=np.float32)
_DTU_KEY_QUATS = np.array(
    [
        [0.9698, 0.2121, 0.1203, -0.0039],
        [0.7020, 0.1578, 0.4525, 0.5268],
        [0.6766, 0.3176, 0.5179, 0.4161],
        [0.9085, 0.4020, 0.1139, -0.0025],
        [0.9698, 0.2121, 0.1203, -0.0039],
    ],
    dtype=np.float32,
)
_DTU_SCALE = 2.0


def dtu_trajectory(num_views):
    """The reference's DTU camera path: a periodic cubic spline through
    IDR's quaternion keyframes at knots [0, 2, 3, 5, 6], the camera centre
    2.0 x the rotated +z axis. ``n_inter = num_views // 5`` poses per knot
    unit over all 6 units, so the path has ``n_inter * 6`` poses, as the
    reference renders it."""
    from scipy.interpolate import CubicSpline

    n_inter = num_views // 5
    if n_inter < 1:
        raise ValueError("the dtu trajectory needs num_views >= 5")
    t_out = np.linspace(_DTU_T_IN[0], _DTU_T_IN[-1], n_inter * int(_DTU_T_IN[-1])).astype(np.float32)
    q = CubicSpline(_DTU_T_IN, _DTU_KEY_QUATS, bc_type="periodic")(t_out)
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    R = geometry.quat_to_rot(q.astype(np.float32))
    return _poses_from(R, R[:, :, 2] * _DTU_SCALE)


def video_render_config(conf, dset) -> RenderConfig:
    """The video's renderer: the dataset's ``lindisp``, and at least 64
    coarse samples with at least 32 fine ones where the config has fewer
    coarse samples (the JAX app's minimum sampling density)."""
    cfg = RenderConfig.from_conf(conf.get_config("renderer", ConfigNode()), lindisp=getattr(dset, "lindisp", False))
    if cfg.n_coarse < 64:
        cfg = dataclasses.replace(cfg, n_coarse=64, n_fine=max(cfg.n_fine, 32))
    return cfg


def render_frames(renderer, enc, rays, generator):
    """Render each (H, W, 8) ray image of ``rays``: yields uint8 frames."""
    for i in range(len(rays)):
        rgb, _ = renderer.render_image(enc, rays[i], generator)
        yield (np.clip(rgb.cpu().numpy(), 0, 1) * 255).astype(np.uint8)


def main(argv=None):
    args, conf = parse_args(extra_args, argv=argv)
    device, mesh = device_and_mesh(args)
    main_rank = is_main_process()     # rank 0 alone writes and prints
    dset = get_split_dataset(
        args.dataset_format, args.datadir, want_split=args.split, training=False,
        **dataset_kwargs_from_conf(conf),
    )
    cfg = video_render_config(conf, dset)

    data = dset[args.subset]
    images, poses = data["images"], data["poses"]
    NV, H, W, _ = images.shape
    source = np.array([int(x) for x in args.source.split()])
    source = source[source < NV]
    if len(source) == 0:
        raise ValueError("no valid source views")

    net = load_net_and_state(args, conf, device)
    renderer = FullRenderer(net, cfg, ray_chunk=args.ray_batch_size, debug_nans=args.debug_nans, mesh=mesh)

    traj = args.traj
    if traj == "auto":
        traj = "dtu" if getattr(dset, "sub_format", None) == "dtu" else "spherical"
    if traj == "spherical":
        radius = args.radius or float(np.linalg.norm(poses[:, :3, 3], axis=-1).mean()) * args.scale
        render_poses = spherical_trajectory(args.num_views, args.elevation, radius)
    elif traj == "dtu":
        render_poses = dtu_trajectory(args.num_views)
    else:
        render_poses = spline_trajectory(poses, args.num_views)

    c_arr = data.get("c", np.array([W / 2.0, H / 2.0], np.float32))
    with torch.inference_mode():
        enc = net.encode(
            torch.from_numpy(images[None, source]).to(device),
            torch.from_numpy(poses[None, source]).to(device),
            torch.as_tensor(data["focal"]),
            c=torch.as_tensor(c_arr[None]),
        )
    rays = geometry.gen_rays(render_poses, W, H, data["focal"], dset.z_near, dset.z_far, c=c_arr, device=device)
    frames = []
    for frame in render_frames(renderer, enc, rays, torch.Generator(device=device).manual_seed(args.seed)):
        frames.append(frame)
        if main_rank:
            print(f"frame {len(frames)}/{len(rays)}")
    if not main_rank:
        return frames

    os.makedirs(args.output, exist_ok=True)
    name = f"{args.name}_obj{args.subset}"
    strip = np.concatenate([((images[s] * 0.5 + 0.5) * 255).astype(np.uint8) for s in source], axis=1)
    png.imwrite(os.path.join(args.output, f"{name}_src.png"), strip)
    path = os.path.join(args.output, f"{name}.gif")
    gif.mimwrite(path, frames, duration=1000 / args.fps)
    print(f"mp4 unavailable (the port writes no mp4: no encoder on its host); wrote {path}")
    return frames


if __name__ == "__main__":
    main()
