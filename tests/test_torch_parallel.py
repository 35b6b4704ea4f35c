"""The port's multi-GPU layer (``parallel/``, ``FullRenderer(mesh=)``, the
sharded train step) on the CPU: ranks of a gloo group in spawned processes
(``tests/torch_parallel_worker.py``, one spawn per world size, 2 and 4),
against the single-process port and the JAX package's mesh on as many of
conftest's virtual devices.

- mesh shapes, and ``shard_batch``'s placement against the JAX arrays'
  shards on the same devices (the NS = 3 and ``c (SB, 2)`` cases);
- the sharded render equals the single-process port render bit for bit
  (rays are independent) and the JAX ``make_sharded_render`` at the query
  tolerance; ``FullRenderer(mesh=)`` on a ray count that needs padding
  equals ``FullRenderer`` bit for bit;
- one SGD (lr 1) step of the sharded train step at layouts 1x2, 2x1, 2x2
  and 4x1 against the JAX mesh step of the same layout (the parameter
  change is the gradient): the train-mode batch norms' statistics over the
  data axis, the gradient average and the noise slices all show there.
"""
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pixelnerf_tpu.config import ConfigNode as JaxConfigNode
from pixelnerf_tpu.parallel import make_mesh as jax_make_mesh
from pixelnerf_tpu.parallel import make_sharded_render as jax_make_sharded_render
from pixelnerf_tpu.parallel import shard_batch as jax_shard_batch
from pixelnerf_tpu.parallel.render import shard_rays as jax_shard_rays
from pixelnerf_tpu.render import RenderConfig as JaxRenderConfig
from pixelnerf_tpu.train import TrainState, make_render_loss as jax_make_loss
from pixelnerf_tpu.train import make_train_step as jax_make_train_step
from pixelnerf_tpu.utils import geometry as jax_geometry
from pixelnerf_tpu_torch.eval.common import FullRenderer, field
from pixelnerf_tpu_torch.models import from_jax_variables
from pixelnerf_tpu_torch.render import RenderConfig, render_rays

import torch_parallel_worker as worker
from torch_port_utils import FOCAL, build_pair, jax_chunk_draws, jax_draws, novel_rays, source_view, t

ATOL, RTOL = 5e-4, 1e-3            # the query tolerance (tests/test_torch_models.py)
JOIN_S = 240                       # each spawn's time limit
RENDER_CFG = dict(n_coarse=16, n_fine=8, n_fine_depth=4)
TRAIN_CFG = dict(n_coarse=8, n_fine=4, n_fine_depth=2, white_bkgd=True)
SB, NS, HW, R = 4, 2, 16, 32       # the train batch (tests/test_sharding.py's)


def _np(x):
    return np.asarray(x, np.float32)


def _train_batch():
    rng = np.random.default_rng(1)
    poses = np.stack([np.stack([jax_geometry.look_at(np.array([0.3 * i, 0.2, 2.0]), np.zeros(3))
                                for i in range(NS)]) for _ in range(SB)]).astype(np.float32)
    cam = np.asarray(jax_geometry.gen_rays(jnp.asarray(poses[:, 0]), HW, HW, 20.0, 1.0, 3.0))
    return {
        "images": rng.uniform(-1, 1, (SB, NS, HW, HW, 3)).astype(np.float32),
        "poses": poses,
        "focal": np.full((SB,), 20.0, np.float32),
        "c": np.full((SB, 2), 8.0, np.float32),
        "rays": np.array(cam.reshape(SB, -1, 8)[:, :R]),
        "rgb_gt": rng.uniform(0, 1, (SB, R, 3)).astype(np.float32),
    }


def _probe_batch():
    """shard_batch's cases: rays split on both axes; images with NS = 3,
    c (SB, 2) and rgb_gt with 5 rays, split on the data axis only (on a
    ray axis of more than one rank); a scalar and an entry of an odd
    leading size, replicated."""
    rng = np.random.default_rng(2)
    return {
        "rays": rng.normal(size=(4, 64, 8)).astype(np.float32),
        "images": rng.normal(size=(4, 3, 8, 8, 3)).astype(np.float32),
        "focal": rng.normal(size=(4,)).astype(np.float32),
        "c": rng.normal(size=(4, 2)).astype(np.float32),
        "rgb_gt": rng.normal(size=(4, 5, 3)).astype(np.float32),
        "odd": rng.normal(size=(3, 4)).astype(np.float32),
        "scalar": np.float32(1.5),
    }


def _spawn(world, tmp):
    """Run the worker on ``world`` ranks and load each rank's results."""
    ctx = torch.multiprocessing.start_processes(worker.main, args=(world, str(tmp)), nprocs=world, join=False,
                                                start_method="spawn")
    deadline = time.time() + JOIN_S
    while not ctx.join(timeout=max(1.0, deadline - time.time())):
        if time.time() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"the {world} ranks did not finish within {JOIN_S} s")
    assert not any(p.is_alive() for p in ctx.processes)
    return [torch.load(os.path.join(tmp, f"out_{world}_{r}.pt"), weights_only=False) for r in range(world)]


APP_OVERRIDES = {
    "model.encoder.num_layers": "2", "model.mlp_coarse.d_hidden": "32", "model.mlp_fine.d_hidden": "32",
    "renderer.n_coarse": "8", "renderer.n_fine": "4", "renderer.n_fine_depth": "2",
    "data.image_size": "[32, 32]", "data.num_objects": "2", "data.num_views": "3",
}


def _app_argv(root):
    """The apps' arguments: the synthetic scenes and a narrow SRN model on
    the CPU, apps.train for 2 batches of 2 objects x 16 rays (its eval and
    visual at batch 1), then apps.eval of every object; with a mesh of 2
    ranks on the data axis under a process group."""
    common = ["-c", "conf/exp/srn.conf", "-F", "synthetic", "--cpu", "--checkpoints_path", str(root / "ck"),
              "--mesh_data", "2"] + [a for k, v in APP_OVERRIDES.items() for a in ("--override", f"{k}={v}")]
    return {"common": common,
            "train": ["--epochs", "1", "--epoch_batches", "2", "-B", "2", "-R", "16", "--workers", "1",
                      "--logs_path", str(root / "logs"), "--visual_path", str(root / "vis")],
            "eval": ["-P", "0", "-R", "512", "-O", str(root / "eval")]}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The payload (the port's weights from the JAX model, inputs, the JAX
    draws), the ranks' results at world sizes 2 and 4, and the references:
    the single-process port render, the JAX mesh renders and train steps."""
    tmp = tmp_path_factory.mktemp("parallel")
    jnet, variables, tnet, jconf, tconf = build_pair(d_hidden=32, SB=2)
    images, poses = source_view(SB=2)
    rays = np.ascontiguousarray(np.concatenate([novel_rays(1), novel_rays(2, n_side=8)[:, ::-1]], 0))  # (2, 64, 8)
    key = jax.random.PRNGKey(7)
    rcfg = RenderConfig(**RENDER_CFG)
    noise = jax_draws(key, 2, 64, rcfg)
    pad_rays = np.array(novel_rays(3, n_side=16)[:, :250])         # 250 = 2 chunks of 128, padded
    pad_noise = [jax_draws(k, 1, n, rcfg) for k, n in zip(jax.random.split(key, 2), (128, 122))]
    tcfg = RenderConfig(**TRAIN_CFG)
    batch = _train_batch()
    train_key = jax.random.PRNGKey(3)
    train_noise = jax_chunk_draws(train_key, SB, R, tcfg, None, train=True)
    payload = {
        "conf": tconf, "state_dict": tnet.state_dict(),
        "render": {"cfg": RENDER_CFG, "images": t(images), "poses": t(poses), "focal": FOCAL, "rays": t(rays),
                   "noise": noise},
        "padded": {"rays": t(pad_rays), "noise": pad_noise, "ray_chunk": 128},
        "probe": _probe_batch(),
        "train": {"cfg": TRAIN_CFG, "batch": {k: t(v) for k, v in batch.items()}, "noise": train_noise},
    }
    payload_apps = dict(payload, apps=_app_argv(tmp / "apps_mesh"))
    torch.save(payload_apps, tmp / "payload.pt")
    ranks = {2: _spawn(2, tmp)}
    torch.save(payload, tmp / "payload.pt")
    ranks[4] = _spawn(4, tmp)

    # the single-process port references
    with torch.inference_mode():
        enc = tnet.encode(t(images), t(poses), FOCAL)
        single = render_rays(field(tnet, enc, staged=False), t(rays), rcfg, noise=noise)
        enc1 = tnet.encode(t(images[:1]), t(poses[:1]), FOCAL)
        full = FullRenderer(tnet, rcfg, ray_chunk=128).render_batch(enc1, t(pad_rays), noise=pad_noise)

    # the JAX package's mesh: the render at one layout a world size, the
    # train step at every layout, on the same weights, inputs and draws
    jcfg = JaxRenderConfig(**RENDER_CFG)
    enc_j = jnet.apply(variables, jnp.asarray(images), jnp.asarray(poses), jnp.asarray(FOCAL), method=jnet.encode)
    jax_render = {}
    for data, ray in ((1, 2), (2, 2)):
        mesh = jax_make_mesh(data=data, ray=ray, devices=jax.devices()[: data * ray])
        out = jax_make_sharded_render(jnet, jcfg, mesh)(variables, enc_j, jax_shard_rays(mesh, jnp.asarray(rays)), key)
        jax_render[(data, ray)] = jax.tree_util.tree_map(_np, jax.device_get(out))
    sgd = optax.sgd(1.0)
    step_cfg = JaxRenderConfig(**TRAIN_CFG)
    jax_train = {}
    for layout in ((1, 2), (2, 1), (2, 2), (4, 1)):
        mesh = jax_make_mesh(data=layout[0], ray=layout[1], devices=jax.devices()[: layout[0] * layout[1]])
        state = TrainState(params=jax.tree_util.tree_map(jnp.array, variables["params"]),
                           batch_stats=jax.tree_util.tree_map(jnp.array, variables["batch_stats"]),
                           opt_state=sgd.init(variables["params"]), step=jnp.zeros((), jnp.int32))
        step = jax_make_train_step(jnet, step_cfg, sgd, jax_make_loss(JaxConfigNode()), mesh=mesh)
        st, m = step(state, jax_shard_batch(mesh, batch), train_key)
        jax_train[layout] = ({k: float(v) for k, v in m.items()},
                             from_jax_variables(jax.device_get({"params": st.params, "batch_stats": st.batch_stats})))
    return {"ranks": ranks, "single": single, "full": full, "jax_render": jax_render, "jax_train": jax_train,
            "probe": payload["probe"], "variables": variables, "tmp": tmp}


def test_apps_train_and_eval_on_two_ranks_match_one_process(run, monkeypatch, capsys):
    """``apps.train`` and ``apps.eval`` on 2 gloo ranks (a 2 x 1 mesh from
    ``--mesh_data 2``) against the same commands in this process (no
    process group, so no mesh): rank 0 alone writes the checkpoint, the
    visual and ``finish.txt``; the 2-rank eval of the 2-rank checkpoint
    writes the same ``finish.txt`` bytes as one process (the sharded render
    is bit-equal); the trained weights agree with one process's to Adam's
    step where a gradient's sign is not clear (its float sums differ)."""
    from pixelnerf_tpu_torch.apps import eval as eval_app
    from pixelnerf_tpu_torch.apps import train
    from pixelnerf_tpu_torch.train import load_variables

    monkeypatch.setenv("PIXELNERF_NO_TB", "1")
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    tmp = run["tmp"]
    mesh_root, one_root = tmp / "apps_mesh", tmp / "apps_one"
    assert sorted(os.listdir(mesh_root / "vis")) == ["example"]
    assert os.listdir(mesh_root / "vis" / "example") == ["0000_0001_vis.png"]
    meshed = load_variables(str(mesh_root / "ck" / "example"), "cpu")
    assert meshed["step"] == 2

    argv = _app_argv(one_root)
    train.main(argv["common"] + argv["train"])
    single = load_variables(str(one_root / "ck" / "example"), "cpu")
    lr = 1e-4
    close = 0
    for k, v in single["model"].items():
        d = (meshed["model"][k].float() - v.float()).abs()
        assert float(d.max()) <= 2 * 2 * lr + 1e-6, k
        close += int((d <= 1e-6).sum())
    total = sum(v.numel() for v in single["model"].values())
    assert close > 0.9 * total

    # the 2-rank checkpoint evaluated in one process
    one_eval = _app_argv(mesh_root)
    eval_app.main(one_eval["common"] + ["-P", "0", "-R", "512", "-O", str(tmp / "eval_one")])
    capsys.readouterr()
    finish = (mesh_root / "eval" / "finish.txt").read_text()
    assert finish == (tmp / "eval_one" / "finish.txt").read_text()
    assert len(finish.splitlines()) == 2


@pytest.mark.parametrize("world", [2, 4])
def test_mesh_shapes_and_coordinates(run, world):
    """make_mesh() puts every rank on the ray axis, make_mesh(data=N)
    N-way on the data axis; rank d * ray + r sits at (d, r), as the JAX
    mesh lays its devices out."""
    for layout in worker.RENDER_LAYOUTS[world]:
        for rank, res in enumerate(run["ranks"][world]):
            shape, d, r, mesh_rank = res["mesh"][layout]
            assert shape == {"data": layout[0], "ray": layout[1]}
            assert (d, r, mesh_rank) == (rank // layout[1], rank % layout[1], rank)
            jmesh = jax_make_mesh(data=layout[0], devices=jax.devices()[:world])
            assert dict(jmesh.shape) == shape
            assert jmesh.devices[d, r] == jax.devices()[rank]


@pytest.mark.parametrize("world", [2, 4])
def test_shard_batch_placement_matches_jax(run, world):
    """Each rank's slice of every entry equals the JAX array's shard on the
    device of the same rank, and the port's spec is the JAX spec."""
    probe = run["probe"]
    for layout in worker.RENDER_LAYOUTS[world]:
        jmesh = jax_make_mesh(data=layout[0], devices=jax.devices()[:world])
        placed = jax_shard_batch(jmesh, probe)
        for rank, res in enumerate(run["ranks"][world]):
            for k, (spec, local) in res["shard"][layout].items():
                assert tuple(spec) == tuple(placed[k].sharding.spec), (layout, k)
                shard = [s for s in placed[k].addressable_shards if s.device == jax.devices()[rank]][0]
                np.testing.assert_array_equal(np.asarray(local), np.asarray(shard.data), err_msg=f"{layout} {k}")
        if layout == (2, 2):
            specs = {k: v[0] for k, v in run["ranks"][world][0]["shard"][layout].items()}
            assert specs == {"rays": ("data", "ray"), "images": ("data",), "focal": ("data",), "c": ("data",),
                             "rgb_gt": ("data",), "odd": (), "scalar": ()}


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_render_matches_single_process_and_jax(run, world):
    single, full = run["single"], run["full"]
    jref = run["jax_render"][(1, 2) if world == 2 else (2, 2)]
    for layout in worker.RENDER_LAYOUTS[world]:
        for rank, res in enumerate(run["ranks"][world]):
            out = res["render"][layout]
            for phase in ("coarse", "fine"):
                for k in ("rgb", "depth"):
                    torch.testing.assert_close(out[phase][k], single[phase][k], atol=0, rtol=0,
                                               msg=f"{layout} rank {rank} {phase} {k}")
                    np.testing.assert_allclose(out[phase][k].numpy(), jref[phase][k], atol=ATOL, rtol=RTOL)
                    torch.testing.assert_close(res["full"][layout][phase][k], full[phase][k], atol=0, rtol=0)
    assert float(single["fine"]["rgb"].std()) > 1e-3
    assert full["fine"]["rgb"].shape == (1, 250, 3)


@pytest.mark.parametrize("layout", [(1, 2), (2, 1), (2, 2), (4, 1)])
def test_sharded_train_step_matches_jax_mesh_step(run, layout):
    """One SGD (lr 1) step: the losses, the global gradient norm, every
    parameter (old minus gradient) and running statistic against the JAX
    mesh step of the same layout, with tests/test_sharding.py's
    tolerances; every rank holds the same parameters after it."""
    world = layout[0] * layout[1]
    jm, jsd = run["jax_train"][layout]
    results = [res["train"][layout] for res in run["ranks"][world]]
    metrics, sd = results[0]
    assert abs(metrics["t"] - jm["t"]) < 1e-5
    assert abs(metrics["gnorm"] - jm["gnorm"]) < 1e-4
    for k, v in jsd.items():
        stat = "running" in k
        np.testing.assert_allclose(sd[k].numpy(), v.numpy(), atol=1e-5 if stat else 1e-4, rtol=1e-5 if stat else 0,
                                   err_msg=k)
    before = from_jax_variables(run["variables"])
    # the encoder's parameters took a gradient through the sharded gathers
    assert max(float((sd[k] - v).abs().max()) for k, v in before.items() if k.startswith("encoder.")) > 1e-3
    for other_metrics, other_sd in results[1:]:
        assert other_metrics == metrics
        for k, v in sd.items():
            torch.testing.assert_close(other_sd[k], v, atol=0, rtol=0)
