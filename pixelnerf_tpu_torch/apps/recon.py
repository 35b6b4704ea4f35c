"""Mesh extraction CLI (counterpart of ``pixelnerf_tpu/apps/recon.py``):
encode source views of one object, evaluate sigma on a ``--reso``^3 grid
through ``net.query`` (coarse, in chunks of 65,536 points: kernel A's
gather on the card), extract the ``--isosurface`` level on the host,
colour the vertices with a second query and write an OBJ. Runs on the GPU
(``--device cuda``, the default) unless asked for the CPU.

    python -m pixelnerf_tpu_torch.apps.recon -n srn_car -F srn -D <data>/cars -P 64 \
        --subset 0 --reso 128 --isosurface 10 -O mesh_out
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..data import dataset_kwargs_from_conf, get_split_dataset
from ..utils.recon import eval_sigma_grid, query_padded, save_obj, surface_from_grid
from .args import parse_args
from .eval import load_net_and_state

# points per query of the grid and of the vertex colours
CHUNK = 65536


def extra_args(parser):
    parser.add_argument("--subset", "-S", type=int, default=0)
    parser.add_argument("--split", type=str, default="test")
    parser.add_argument("--source", "-P", type=str, default="0")
    parser.add_argument("--reso", type=int, default=128)
    parser.add_argument("--bounds", type=float, default=1.0)
    parser.add_argument("--isosurface", type=float, default=10.0)
    parser.add_argument("--output", "-O", type=str, default="mesh_out")


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    """:return: dict with the OBJ's ``path``, ``verts`` (V, 3), ``faces``
    (F, 3), ``colors`` (V, 3) or None, and ``ms``: the host-clock times of
    the encode, the sigma grid, the surface extraction, the colour query
    and the OBJ write"""
    args, conf = parse_args(extra_args, argv=argv)
    device = torch.device(args.device)
    dset = get_split_dataset(
        args.dataset_format, args.datadir, want_split=args.split, training=False,
        **dataset_kwargs_from_conf(conf),
    )
    data = dset[args.subset]
    source = [int(x) for x in args.source.split()]
    H, W = data["images"].shape[1:3]

    net = load_net_and_state(args, conf, device)
    c_arr = data.get("c", np.array([W / 2.0, H / 2.0], np.float32))
    ms = {}
    t0 = time.perf_counter()
    with torch.inference_mode():
        enc = net.encode(
            torch.from_numpy(data["images"][None, source]).to(device),
            torch.from_numpy(data["poses"][None, source]).to(device),
            torch.as_tensor(data["focal"]),
            c=torch.as_tensor(c_arr[None]),
        )
        _sync(device)
        ms["encode"] = (time.perf_counter() - t0) * 1e3

        def query(xyz, viewdirs, coarse):
            return net.query(enc, xyz, viewdirs, coarse=coarse)

        print("Evaluating sigma grid...")
        reso = (args.reso,) * 3
        bounds = (-args.bounds, args.bounds)
        t0 = time.perf_counter()
        sigma = eval_sigma_grid(query, reso, bounds, CHUNK, device=device)
        ms["grid"] = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        verts, faces = surface_from_grid(sigma, bounds, args.isosurface)
        ms["surface"] = (time.perf_counter() - t0) * 1e3
        print(f"{len(verts)} vertices, {len(faces)} faces")

        colors = None
        t0 = time.perf_counter()
        if len(verts):
            colors = query_padded(query, verts, CHUNK, True, device)[:, :3].float().cpu().numpy()
        ms["colors"] = (time.perf_counter() - t0) * 1e3

    os.makedirs(args.output, exist_ok=True)
    out_path = os.path.join(args.output, f"{args.name}_obj{args.subset}.obj")
    t0 = time.perf_counter()
    save_obj(out_path, verts, faces, colors)
    ms["write"] = (time.perf_counter() - t0) * 1e3
    print("Wrote", out_path)
    return {"path": out_path, "verts": verts, "faces": faces, "colors": colors, "ms": ms}


if __name__ == "__main__":
    main()
