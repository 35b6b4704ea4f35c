"""Shared CLI argument handling (counterpart of
``pixelnerf_tpu/apps/args.py``).

Two-stage config: argparse for run-level flags, the HOCON tree for the
architecture. ``expconf.conf`` maps experiment names to default config
files and data directories, so ``-n srn_car`` alone selects both.
"""
from __future__ import annotations

import argparse
import os
from typing import Callable, Optional, Tuple

from ..config import ConfigNode, load_config
from ..config.hocon import _parse_value

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_args(
    callback: Optional[Callable[[argparse.ArgumentParser], None]] = None,
    *,
    default_conf: str = "conf/default_mv.conf",
    default_expname: str = "example",
    default_datadir: str = "data",
    default_ray_batch_size: int = 50000,
    argv=None,
) -> Tuple[argparse.Namespace, ConfigNode]:
    parser = argparse.ArgumentParser()
    parser.add_argument("--conf", "-c", type=str, default=None)
    parser.add_argument("--resume", "-r", action="store_true")
    parser.add_argument("--name", "-n", type=str, default=default_expname)
    parser.add_argument("--dataset_format", "-F", type=str, default=None)
    parser.add_argument("--exp_group_name", "-G", type=str, default=None)
    parser.add_argument("--logs_path", type=str, default="logs")
    parser.add_argument("--checkpoints_path", type=str, default="checkpoints")
    parser.add_argument("--visual_path", type=str, default="visuals")
    parser.add_argument("--epochs", type=int, default=10000000)
    parser.add_argument("--datadir", "-D", type=str, default=None)
    parser.add_argument("--ray_batch_size", "-R", type=int, default=default_ray_batch_size)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to run on; the CPU only when asked for")
    parser.add_argument("--profile_dir", type=str, default=None,
                        help="write a TensorBoard-viewable torch.profiler trace here (the train app)")
    parser.add_argument(
        "--override", action="append", default=[], metavar="KEY=VALUE",
        help="config override, e.g. --override model.mlp_coarse.d_hidden=64",
    )
    if callback is not None:
        callback(parser)
    args = parser.parse_args(argv)

    if args.exp_group_name is not None:
        args.logs_path = os.path.join(args.logs_path, args.exp_group_name)
        args.checkpoints_path = os.path.join(args.checkpoints_path, args.exp_group_name)
        args.visual_path = os.path.join(args.visual_path, args.exp_group_name)

    expconf_path = os.path.join(REPO_ROOT, "expconf.conf")
    expconf = load_config(expconf_path) if os.path.exists(expconf_path) else ConfigNode()
    if args.conf is None:
        args.conf = expconf.get_string(f"config.{args.name}", default_conf)
    if args.datadir is None:
        args.datadir = expconf.get_string(f"datadir.{args.name}", default_datadir)
    if not os.path.isabs(args.conf) and not os.path.exists(args.conf):
        candidate = os.path.join(REPO_ROOT, args.conf)
        if os.path.exists(candidate):
            args.conf = candidate

    conf = load_config(args.conf)
    for ov in args.override:
        key, eq, value = ov.partition("=")
        if not eq or not key:
            parser.error(f"--override expects KEY=VALUE, got {ov!r} (e.g. --override renderer.n_coarse=64)")
        node = conf
        parts = key.split(".")
        for part in parts[:-1]:
            if part not in node:
                dict.__setitem__(node, part, ConfigNode())
            node = node[part]
        dict.__setitem__(node, parts[-1], _parse_value(value))

    if args.dataset_format is None:
        args.dataset_format = conf.get_string("data.format", "dvr")
    return args, conf
