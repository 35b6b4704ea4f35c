"""One rank of ``tests/test_torch_parallel.py``: a process of a gloo group
on the CPU that runs the port's multi-GPU layer on the payload the test
wrote and saves what it got. It imports torch and the port only (no JAX),
so that a spawned rank starts in a few seconds."""
from __future__ import annotations

import os

import torch
import torch.distributed as dist

from pixelnerf_tpu_torch.config import ConfigNode
from pixelnerf_tpu_torch.eval.common import FullRenderer
from pixelnerf_tpu_torch.models import make_model
from pixelnerf_tpu_torch.parallel import make_mesh, make_sharded_render, shard_batch, shard_rays
from pixelnerf_tpu_torch.parallel.mesh import batch_spec
from pixelnerf_tpu_torch.render import RenderConfig
from pixelnerf_tpu_torch.train import make_render_loss, make_train_step

# the layouts each world size runs: (data, ray) of the meshes made with
# make_mesh() (every rank on the ray axis) and make_mesh(data=...)
RENDER_LAYOUTS = {2: [(1, 2), (2, 1)], 4: [(1, 4), (2, 2), (4, 1)]}
TRAIN_LAYOUTS = {2: [(1, 2), (2, 1)], 4: [(2, 2), (4, 1)]}


def _net(payload):
    net = make_model(payload["conf"]["model"], device="cpu")
    net.load_state_dict(payload["state_dict"])
    return net


def _mesh(layout):
    return make_mesh() if layout[0] == 1 else make_mesh(data=layout[0])


def main(rank: int, world: int, tmp: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{os.path.join(tmp, f'store_{world}')}",
                            rank=rank, world_size=world)
    try:
        payload = torch.load(os.path.join(tmp, "payload.pt"), weights_only=False)
        out = {"mesh": {}, "shard": {}, "render": {}, "full": {}, "train": {}}
        net = _net(payload).eval()
        r = payload["render"]
        cfg = RenderConfig(**r["cfg"])
        with torch.inference_mode():
            enc = net.encode(r["images"], r["poses"], r["focal"])
            enc1 = net.encode(r["images"][:1], r["poses"][:1], r["focal"])
        for layout in RENDER_LAYOUTS[world]:
            mesh = _mesh(layout)
            out["mesh"][layout] = (dict(mesh.shape), mesh.data_index, mesh.ray_index, mesh.rank)
            probe = payload["probe"]
            out["shard"][layout] = {k: (batch_spec(mesh, v, k in ("rays", "rgb_gt")), v2)
                                    for (k, v), v2 in zip(probe.items(), shard_batch(mesh, probe).values())}
            render = make_sharded_render(net, cfg, mesh)
            out["render"][layout] = render(enc, shard_rays(mesh, r["rays"]), noise=r["noise"])
            p = payload["padded"]
            full = FullRenderer(net, cfg, ray_chunk=p["ray_chunk"], mesh=mesh)
            out["full"][layout] = full.render_batch(enc1, p["rays"], noise=p["noise"])
        tr = payload["train"]
        for layout in TRAIN_LAYOUTS[world]:
            mesh = _mesh(layout)
            net = _net(payload)
            opt = torch.optim.SGD(net.parameters(), lr=1.0)
            step = make_train_step(net, RenderConfig(**tr["cfg"]), opt, make_render_loss(ConfigNode()), mesh=mesh)
            metrics = step(shard_batch(mesh, tr["batch"]), noise=tr["noise"])
            out["train"][layout] = ({k: float(v) for k, v in metrics.items()},
                                    {k: v.clone() for k, v in net.state_dict().items()})
        torch.save(out, os.path.join(tmp, f"out_{world}_{rank}.pt"))
        if "apps" in payload:
            run_apps(payload["apps"])
    finally:
        dist.destroy_process_group()


def run_apps(argv):
    """``apps.train`` then ``apps.eval`` on every rank of the group (which
    they find initialised, as under torchrun), with the same arguments a
    single process would take; a barrier between them, as rank 0 writes
    the checkpoint the eval loads."""
    from pixelnerf_tpu_torch.apps import eval as eval_app
    from pixelnerf_tpu_torch.apps import train

    train.main(argv["common"] + argv["train"])
    dist.barrier()
    eval_app.main(argv["common"] + argv["eval"])
