"""The port's apps take every flag of the JAX apps' parsers: ``--gpu_id``
(ignored), ``--cpu`` (``--device cpu``), ``--debug_nans`` (a non-finite
train loss or render output raises) and the mesh flags ``--no_mesh``,
``--mesh_data``, ``--mesh_ray`` (a mesh of ranks only under a process
group of more than one rank), on the CPU. No JAX model is built and no
JAX step compiled."""
import importlib

import numpy as np
import pytest
import torch

from pixelnerf_tpu_torch.apps import args as port_args
from pixelnerf_tpu_torch.config import load_config
from pixelnerf_tpu_torch.eval.common import FullRenderer
from pixelnerf_tpu_torch.models import make_model
from pixelnerf_tpu_torch.render import RenderConfig
from pixelnerf_tpu_torch.train import make_render_loss, make_train_step

from torch_port_utils import FOCAL, W, novel_rays, small_conf, source_view, t

APPS = ["train", "eval", "eval_approx", "gen_video", "eval_real", "recon"]


class _Parser(Exception):
    pass


def _flags(package, app):
    """Every option string of ``<package>.apps.<app>``'s full parser."""
    mod = importlib.import_module(f"{package}.apps.{app}")
    found = {}

    def callback(parser):
        mod.extra_args(parser)
        found["parser"] = parser
        raise _Parser

    with pytest.raises(_Parser):
        mod.parse_args(callback, argv=[])
    return {s for action in found["parser"]._actions for s in action.option_strings}


@pytest.mark.parametrize("app", APPS)
def test_port_apps_take_every_flag_of_the_jax_apps(app):
    jax_flags = _flags("pixelnerf_tpu", app)
    assert {"--gpu_id", "--cpu", "--debug_nans", "--mesh_data", "--mesh_ray"} <= jax_flags
    assert ("--no_mesh" in jax_flags) == (app != "recon")
    assert jax_flags <= _flags("pixelnerf_tpu_torch", app)
    mod = importlib.import_module(f"pixelnerf_tpu_torch.apps.{app}")
    args, _ = mod.parse_args(mod.extra_args, argv=["--gpu_id", "0", "--cpu", "--debug_nans"])
    assert (args.gpu_id, args.device, args.debug_nans) == ("0", "cpu", True)


@pytest.mark.parametrize("argv, device", [
    ([], "cuda"), (["--cpu"], "cpu"), (["--device", "cpu", "--cpu"], "cpu"), (["--device", "cuda:1"], "cuda:1"),
    (["--gpu_id", "3"], "cuda"),
])
def test_cpu_flag_is_device_cpu(argv, device):
    args, _ = port_args.parse_args(argv=argv)
    assert args.device == device and not args.debug_nans


@pytest.mark.parametrize("argv, world", [
    ([], "1"), (["--mesh_data", "2", "--mesh_ray", "1"], None), (["--no_mesh"], "4"),
])
def test_mesh_flags_build_a_mesh_only_over_several_ranks(argv, world, monkeypatch):
    """``device_and_mesh``: no mesh without a process group of more than
    one rank (``WORLD_SIZE`` from torchrun's environment) or with
    ``--no_mesh``; the device is ``--device`` then."""
    from pixelnerf_tpu_torch.apps import train

    if world is None:
        monkeypatch.delenv("WORLD_SIZE", raising=False)
    else:
        monkeypatch.setenv("WORLD_SIZE", world)
    args, _ = train.parse_args(train.extra_args, argv=argv + ["--cpu"])
    assert (args.mesh_data, args.mesh_ray) == ((2, 1) if "--mesh_data" in argv else (None, None))
    device, mesh = port_args.device_and_mesh(args, args.mesh_data, args.mesh_ray)
    assert device == torch.device("cpu") and mesh is None


def test_cpu_and_a_cuda_device_disagree(capsys):
    with pytest.raises(SystemExit):
        port_args.parse_args(argv=["--cpu", "--device", "cuda"])
    assert "disagree" in capsys.readouterr().err


def _tiny_net():
    conf = small_conf(load_config, d_hidden=32)
    return make_model(conf["model"], device="cpu", generator=torch.Generator().manual_seed(0)), conf


def _nan_batch():
    images, poses = source_view()
    rgb_gt = torch.rand((1, 16, 3), generator=torch.Generator().manual_seed(0))
    rgb_gt[0, 3, 1] = float("nan")
    return {"images": t(images), "poses": t(poses), "focal": torch.full((1,), FOCAL),
            "c": torch.full((1, 2), W / 2.0), "rays": t(novel_rays()[:, :16]), "rgb_gt": rgb_gt}


def test_debug_nans_raises_at_a_non_finite_train_loss():
    """A step fed a NaN target runs on without the flag (its loss is NaN
    and Adam steps on it) and raises before its backward with it."""
    net, conf = _tiny_net()
    cfg = RenderConfig.from_conf(conf["renderer"])
    batch = _nan_batch()
    opt = torch.optim.Adam(net.parameters(), lr=1e-4)
    metrics = make_train_step(net, cfg, opt, make_render_loss(conf["loss"]))(
        batch, generator=torch.Generator().manual_seed(1))
    assert not np.isfinite(float(metrics["t"]))
    assert not torch.is_anomaly_enabled()
    step = make_train_step(net, cfg, opt, make_render_loss(conf["loss"]), debug_nans=True)
    with pytest.raises(FloatingPointError, match="train loss"):
        step(batch, generator=torch.Generator().manual_seed(1))
    # the anomaly mode is the step's alone
    assert not torch.is_anomaly_enabled()


def test_debug_nans_raises_at_a_non_finite_render_output():
    net, conf = _tiny_net()
    cfg = RenderConfig.from_conf(conf["renderer"])
    images, poses = source_view()
    with torch.no_grad():
        net.mlp_coarse.lin_out.bias.fill_(float("nan"))
        enc = net.encode(t(images), t(poses), torch.full((1,), FOCAL))
    rays = t(novel_rays()[0, :16])
    out = FullRenderer(net, cfg)(enc, rays, torch.Generator().manual_seed(1))
    assert not torch.isfinite(out["coarse"]["rgb"]).all()
    with pytest.raises(FloatingPointError, match="render output"):
        FullRenderer(net, cfg, debug_nans=True)(enc, rays, torch.Generator().manual_seed(1))


def test_train_app_debug_nans_raises_at_its_first_non_finite_loss(tmp_path, monkeypatch):
    """``apps.train --cpu --debug_nans`` on synthetic scenes whose images
    hold a NaN raises at its first step."""
    from pixelnerf_tpu_torch.apps import train
    from pixelnerf_tpu_torch.data import SyntheticSphereDataset

    item = SyntheticSphereDataset.__getitem__

    def nan_item(self, i):
        d = item(self, i)
        d["images"] = np.array(d["images"])
        d["images"][..., 0, 0, 0] = np.nan
        return d

    monkeypatch.setattr(SyntheticSphereDataset, "__getitem__", nan_item)
    monkeypatch.setenv("PIXELNERF_NO_TB", "1")
    argv = [
        "-c", "conf/exp/srn.conf", "-F", "synthetic", "--epochs", "1", "--epoch_batches", "2",
        "--cpu", "--gpu_id", "0", "--debug_nans", "-B", "1", "-R", "16", "--workers", "1",
        "--checkpoints_path", str(tmp_path / "ck"), "--logs_path", str(tmp_path / "logs"),
        "--visual_path", str(tmp_path / "vis"),
        "--override", "model.encoder.num_layers=2", "--override", "model.mlp_coarse.d_hidden=32",
        "--override", "model.mlp_fine.d_hidden=32", "--override", "renderer.n_coarse=8",
        "--override", "renderer.n_fine=4", "--override", "renderer.n_fine_depth=2",
        "--override", "data.image_size=[32, 32]", "--override", "data.num_objects=2",
        "--override", "data.num_views=3",
    ]
    with pytest.raises(FloatingPointError, match="train loss"):
        train.main(argv)
