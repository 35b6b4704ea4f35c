"""The port's training loop around the step, on the CPU: checkpoints
(round trip, backup fallback, partial restore, optimizer-free load), the
synthetic dataset and ray pipeline against the JAX package's for one seed,
the loss, the eval step, the LR and sample-count schedules, gradient
accumulation, and the train app for 2 x 2 batches with a resume."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pixelnerf_tpu.config import ConfigNode as JaxConfigNode
from pixelnerf_tpu.data import RayBatchPipeline as JaxPipeline
from pixelnerf_tpu.data import SyntheticSphereDataset as JaxSynthetic
from pixelnerf_tpu.render import renderer as jr
from pixelnerf_tpu.train import make_eval_step as jax_make_eval_step
from pixelnerf_tpu.train import make_render_loss as jax_make_loss
from pixelnerf_tpu_torch.config import ConfigNode
from pixelnerf_tpu_torch.data import RayBatchPipeline, SyntheticSphereDataset, get_split_dataset
from pixelnerf_tpu_torch.models import load_jax_variables, make_model
from pixelnerf_tpu_torch.render import renderer as tr
from pixelnerf_tpu_torch.train import (
    load_checkpoint,
    load_variables,
    make_eval_step,
    make_render_loss,
    make_train_step,
    save_checkpoint,
)
from pixelnerf_tpu_torch.train.trainer import Trainer

from torch_port_utils import FOCAL, W, build_pair, jax_draws, novel_rays, small_conf, source_view, t


def _tiny_net(seed=0):
    from pixelnerf_tpu_torch.config import load_config

    conf = small_conf(load_config, d_hidden=32)
    return make_model(conf["model"], device="cpu", generator=torch.Generator().manual_seed(seed)), conf


def _opt(net, lr=1e-4):
    return torch.optim.Adam(net.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)


def _moved(net, opt):
    """One Adam update so the optimizer holds state."""
    for p in net.parameters():
        p.grad = torch.ones_like(p)
    opt.step()


def test_checkpoint_roundtrip(tmp_path):
    net, _ = _tiny_net()
    opt = _opt(net)
    _moved(net, opt)
    save_checkpoint(str(tmp_path), net, opt, 17)
    # the second save exercises the backup path
    save_checkpoint(str(tmp_path), net, opt, 17)
    assert os.path.exists(tmp_path / "train_state.pt_backup")
    net2, _ = _tiny_net(seed=1)
    opt2 = _opt(net2)
    assert load_checkpoint(str(tmp_path), net2, opt2) == 17
    for (k, a), b in zip(net.state_dict().items(), net2.state_dict().values()):
        torch.testing.assert_close(a, b, atol=0, rtol=0, msg=k)
    s1, s2 = opt.state_dict()["state"], opt2.state_dict()["state"]
    assert set(s1) == set(s2)
    for i in s1:
        for k in ("step", "exp_avg", "exp_avg_sq"):
            torch.testing.assert_close(s1[i][k], s2[i][k], atol=0, rtol=0)


def test_load_variables_without_optimizer(tmp_path):
    net, _ = _tiny_net()
    save_checkpoint(str(tmp_path), net, _opt(net), 42)
    restored = load_variables(str(tmp_path))
    assert restored is not None and restored["step"] == 42
    assert set(restored["model"]) == set(net.state_dict())
    for k, v in net.state_dict().items():
        torch.testing.assert_close(restored["model"][k], v, atol=0, rtol=0)
    assert load_variables(str(tmp_path / "nothing")) is None


def test_corrupt_checkpoint_falls_back_to_backup(tmp_path):
    net, _ = _tiny_net()
    opt = _opt(net)
    save_checkpoint(str(tmp_path), net, opt, 5)
    save_checkpoint(str(tmp_path), net, opt, 5)   # creates the backup
    with open(tmp_path / "train_state.pt", "wb") as f:
        f.write(b"garbage")
    assert load_checkpoint(str(tmp_path), net, opt) == 5
    assert load_variables(str(tmp_path))["step"] == 5


def test_partial_restore_when_optimizer_changed(tmp_path, capsys):
    """A checkpoint written with Adam restored into a run built with SGD:
    the model and the step come back, the optimizer stays as built."""
    net, _ = _tiny_net()
    opt = _opt(net)
    _moved(net, opt)
    save_checkpoint(str(tmp_path), net, opt, 9)
    net2, _ = _tiny_net(seed=1)
    sgd = torch.optim.SGD(net2.parameters(), lr=0.1, momentum=0.9)
    before = sgd.state_dict()
    assert load_checkpoint(str(tmp_path), net2, sgd) == 9
    assert "partial restore" in capsys.readouterr().out
    for a, b in zip(net.state_dict().values(), net2.state_dict().values()):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    assert sgd.state_dict() == before


def test_synthetic_dataset_and_pipeline_match_jax():
    """The port's own numpy copies: the same scenes and the same ray
    batches as the JAX package's for one seed."""
    kw = dict(num_objects=3, num_views=4, image_size=(24, 24))
    jd, td = JaxSynthetic(**kw), SyntheticSphereDataset(**kw)
    for i in range(3):
        a, b = jd[i], td[i]
        assert set(a) == set(b)
        for k in ("images", "masks", "bbox", "poses", "focal", "c"):
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)
    pk = dict(batch_size=2, rays_per_object=40, views=(1, 2), no_bbox_step=2, seed=3, prefetch=0, workers=1)
    jb, tb = iter(JaxPipeline(jd, **pk)), iter(RayBatchPipeline(td, **pk))
    for _ in range(4):                       # bbox sampling, then uniform
        a, b = next(jb), next(tb)
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)
    assert get_split_dataset("synthetic", None, "val", **kw).seed == JaxSynthetic(stage="val", **kw).seed
    # the other formats' readers: tests/test_torch_data.py, test_torch_readers.py
    with pytest.raises(NotImplementedError):
        get_split_dataset("nerf_llff", "data", "train")


@pytest.mark.parametrize("workers", [1, 2])
def test_pipeline_prefetch_stops_when_its_iterator_closes(workers):
    """A closed prefetching iterator (a trainer that has returned) leaves no
    thread pulling objects: at most the pulls already running finish."""
    import threading
    import time

    class Counting(SyntheticSphereDataset):
        pulls = 0

        def __getitem__(self, i):
            Counting.pulls += 1
            time.sleep(0.01)
            return super().__getitem__(i)

    before = threading.active_count()
    pipe = RayBatchPipeline(Counting(num_objects=3, num_views=2, image_size=(8, 8)), batch_size=2,
                            rays_per_object=4, prefetch=2, workers=workers)
    it = iter(pipe)
    next(it)
    it.close()
    time.sleep(1.0)        # the pulls already running (10 ms each) finish
    pulls = Counting.pulls
    time.sleep(0.5)
    assert Counting.pulls == pulls
    assert threading.active_count() <= before


def test_loss_matches_jax():
    rng = np.random.default_rng(0)
    rgb_c, rgb_f, gt = (rng.uniform(0, 1, (2, 16, 3)).astype(np.float32) for _ in range(3))
    betas = rng.uniform(0.1, 2.0, (2, 16)).astype(np.float32)
    confs = [
        {},
        {"rgb": {"use_l1": True}, "lambda_fine": 0.5},
        {"rgb_fine": {"use_uncertainty": True}},
    ]
    for c in confs:
        ref, rparts = jax_make_loss(JaxConfigNode(c))(
            {"coarse": {"rgb": jnp.asarray(rgb_c)}, "fine": {"rgb": jnp.asarray(rgb_f), "betas": jnp.asarray(betas)}},
            jnp.asarray(gt),
        )
        out, parts = make_render_loss(ConfigNode(c))(
            {"coarse": {"rgb": t(rgb_c)}, "fine": {"rgb": t(rgb_f), "betas": t(betas)}}, t(gt)
        )
        np.testing.assert_allclose(float(out), float(ref), rtol=1e-6)
        assert set(parts) == set(rparts)
    with pytest.raises(ValueError, match="use_uncertainty"):
        make_render_loss(ConfigNode(confs[2]))({"coarse": {"rgb": t(rgb_c)}, "fine": {"rgb": t(rgb_f)}}, t(gt))


def test_eval_step_matches_jax():
    jnet, variables, tnet, jconf, tconf = build_pair()
    jcfg = jr.RenderConfig.from_conf(jconf["renderer"])
    tcfg = tr.RenderConfig.from_conf(tconf["renderer"])
    images, poses = source_view()
    rays = novel_rays()[:, :24]
    gt = np.random.default_rng(1).uniform(0, 1, (1, 24, 3)).astype(np.float32)
    batch = {"images": images, "poses": poses, "focal": np.full((1,), FOCAL, np.float32),
             "c": np.full((1, 2), W / 2.0, np.float32), "rays": rays, "rgb_gt": gt}
    key = jax.random.PRNGKey(5)
    ref = jax_make_eval_step(jnet, jcfg, jax_make_loss(jconf["loss"]))(
        variables, {k: jnp.asarray(v) for k, v in batch.items()}, key
    )
    out = make_eval_step(tnet, tcfg, make_render_loss(tconf["loss"]))(
        {k: t(v) for k, v in batch.items()}, noise=jax_draws(key, 1, 24, jcfg)
    )
    for k in ("rc", "rf", "t"):
        np.testing.assert_allclose(float(out[k]), float(ref[k]), rtol=1e-4, err_msg=k)


def test_lr_and_render_schedules_match_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("PIXELNERF_NO_TB", "1")
    net, conf = _tiny_net()
    conf["train"] = ConfigNode({"num_epoch_repeats": 2, "accu_grad": 3})
    trainer = Trainer(net, [], None, tr.RenderConfig(n_coarse=8), conf, ckpt_dir=str(tmp_path),
                      lr=1e-3, gamma=0.5, epoch_batches=4)
    # optax.exponential_decay(staircase) inside MultiSteps: the schedule's
    # count advances once per accu_grad calls, its stairs are epochs of
    # epoch_batches * num_epoch_repeats updates
    sched = optax.exponential_decay(1e-3, transition_steps=4 * 2, decay_rate=0.5, staircase=True)
    for step in range(0, 100, 7):
        np.testing.assert_allclose(trainer.lr_at(step), float(sched(step // 3)), rtol=1e-6)
    base_j, base_t = jr.RenderConfig(n_coarse=64, n_fine=32), tr.RenderConfig(n_coarse=64, n_fine=32)
    spec = [[0, 10, 20], [16, 32, 64], [8, 16, 32]]
    js, ts = jr.RenderSchedule(base_j, spec), tr.RenderSchedule(base_t, spec)
    for step in (0, 5, 10, 15, 25):
        a, b = js.at_step(step), ts.at_step(step)
        assert (a.n_coarse, a.n_fine) == (b.n_coarse, b.n_fine)
    assert tr.RenderSchedule(base_t, []).at_step(99) is base_t


def test_accumulated_step_equals_one_step_of_the_mean():
    """accu_grad=2 on the same batch and draws twice: the update is the
    mean of two equal gradients, i.e. one plain step's update, and the
    first call leaves the parameters as they were."""
    _, variables, _, _, tconf = build_pair(d_hidden=32, SB=1)
    images, poses = source_view()
    batch = {"images": t(images), "poses": t(poses), "focal": torch.full((1,), FOCAL),
             "c": torch.full((1, 2), W / 2.0), "rays": t(novel_rays()[:, :16]),
             "rgb_gt": torch.rand((1, 16, 3), generator=torch.Generator().manual_seed(0))}
    cfg = tr.RenderConfig.from_conf(tconf["renderer"])
    noise = [tr.draw_noise(batch["rays"], cfg, torch.Generator().manual_seed(1), train=True)]
    states = []
    for accu in (1, 2):
        net = make_model(tconf["model"], device="cpu")
        load_jax_variables(net, variables)
        opt = _opt(net, lr=1e-3)
        step = make_train_step(net, cfg, opt, make_render_loss(tconf["loss"]), accu_grad=accu)
        start = {k: v.clone() for k, v in net.named_parameters()}
        for i in range(accu):
            step(batch, noise=noise)
            if i < accu - 1:
                assert all(torch.equal(start[k], p) for k, p in net.named_parameters())
        states.append({k: p.detach().clone() for k, p in net.named_parameters()})
    for k in states[0]:
        torch.testing.assert_close(states[1][k], states[0][k], atol=1e-7, rtol=0, msg=k)


def test_train_app_synthetic_two_by_two_and_resume(tmp_path, capsys, monkeypatch):
    """``apps.train`` on the synthetic scenes, 2 epochs x 2 batches on the
    CPU with chunked ``remat="features"``, then a resume that continues
    from the saved step."""
    from pixelnerf_tpu_torch.apps import train

    monkeypatch.setenv("PIXELNERF_NO_TB", "1")
    argv = [
        "-c", "conf/exp/srn.conf", "-F", "synthetic", "--epochs", "2", "--epoch_batches", "2",
        "--device", "cpu", "-B", "2", "-R", "32", "--workers", "1",
        "--train_ray_chunk", "16", "--train_remat", "features",
        "--checkpoints_path", str(tmp_path / "ck"), "--logs_path", str(tmp_path / "logs"),
        "--visual_path", str(tmp_path / "vis"),
        "--override", "model.encoder.num_layers=2", "--override", "model.mlp_coarse.d_hidden=32",
        "--override", "model.mlp_fine.d_hidden=32", "--override", "renderer.n_coarse=8",
        "--override", "renderer.n_fine=4", "--override", "renderer.n_fine_depth=2",
        "--override", "data.image_size=[32, 32]", "--override", "data.num_objects=2",
        "--override", "data.num_views=3",
    ]
    trainer = train.main(argv)
    out = capsys.readouterr().out
    assert trainer.step == 4 and trainer.net.encoder.model.conv1.weight.device.type == "cpu"
    lines = [l for l in out.splitlines() if l.startswith("E")]
    assert len(lines) == 2 and all("gnorm:" in l for l in lines), out
    assert "*** eval:" in out
    losses = [float(l.split("t:")[1].split()[0]) for l in lines]
    assert np.all(np.isfinite(losses))
    assert load_variables(str(tmp_path / "ck" / "example"))["step"] == 4
    resumed = train.main(argv + ["--resume", "--epochs", "1"])
    assert "Resumed from step 4" in capsys.readouterr().out
    assert resumed.step == 6


def test_accumulation_resumes_from_a_checkpoint_and_matches_multisteps(tmp_path):
    """accu_grad=2 over two different batches: one call, a checkpoint, the
    model, optimizer and step rebuilt from it, one more call. The update
    equals two calls without the break, and ``optax.MultiSteps(adam, 2)``
    fed the same two gradients (taken from plain steps at lr 0)."""
    _, variables, _, _, tconf = build_pair(d_hidden=32, SB=1)
    images, poses = source_view()
    rng = np.random.default_rng(7)
    batches = [{"images": t(images), "poses": t(poses), "focal": torch.full((1,), FOCAL),
                "c": torch.full((1, 2), W / 2.0), "rays": t(novel_rays()[:, 16 * i:16 * (i + 1)]),
                "rgb_gt": t(rng.uniform(0, 1, (1, 16, 3)).astype(np.float32))} for i in range(2)]
    cfg = tr.RenderConfig.from_conf(tconf["renderer"])
    noise = [[tr.draw_noise(b["rays"], cfg, torch.Generator().manual_seed(i), train=True)]
             for i, b in enumerate(batches)]
    loss_fn = make_render_loss(tconf["loss"])

    def fresh(accu, lr=1e-3):
        # the encoder in eval mode: no running statistics move, so both
        # gradients are taken at the same state
        net = make_model(tconf["model"], device="cpu")
        load_jax_variables(net, variables)
        opt = _opt(net, lr=lr)
        return net, opt, make_train_step(net, cfg, opt, loss_fn, train_encoder=False, accu_grad=accu)

    # two calls without a break
    net_a, _, step_a = fresh(2)
    start = {k: p.detach().clone() for k, p in net_a.named_parameters()}
    for b, n in zip(batches, noise):
        step_a(b, noise=n)
    # one call, save, rebuild everything from the checkpoint, one more call
    net_b, opt_b, step_b = fresh(2)
    step_b(batches[0], noise=noise[0])
    save_checkpoint(str(tmp_path), net_b, opt_b, 1)
    net_c, opt_c, step_c = fresh(2)
    assert load_checkpoint(str(tmp_path), net_c, opt_c) == 1
    assert opt_c.accumulation["mini_step"] == 1
    step_c(batches[1], noise=noise[1])
    assert opt_c.accumulation == {"mini_step": 0, "acc_grads": None}
    for k, p in net_a.named_parameters():
        assert not torch.equal(p, start[k]) or p.grad is None, k
        torch.testing.assert_close(dict(net_c.named_parameters())[k], p, atol=0, rtol=0, msg=k)

    # optax.MultiSteps on the same two gradients
    grads = []
    for b, n in zip(batches, noise):
        net_g, _, step_g = fresh(1, lr=0.0)
        step_g(b, noise=n)
        grads.append({k: p.grad.numpy().copy() for k, p in net_g.named_parameters() if p.grad is not None})
    params = {k: jnp.asarray(start[k].numpy()) for k in grads[0]}
    tx = optax.MultiSteps(optax.adam(1e-3), 2)
    opt_state = tx.init(params)
    for g in grads:
        updates, opt_state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, opt_state, params)
        params = optax.apply_updates(params, updates)
    assert int(opt_state.mini_step) == 0
    moved = 0
    for k, p in net_c.named_parameters():
        if k in params:
            # two libraries' float32 Adam: one ulp of the parameter beside
            # the 1e-7 of test_accumulated_step_equals_one_step_of_the_mean
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(params[k]), atol=1e-7, rtol=1.2e-7, err_msg=k)
            moved += int(not torch.equal(p, start[k]))
    assert moved > 0


def test_accumulation_counter_restored_past_accu_grad_still_updates():
    """A checkpoint taken in the middle of an accumulation of 4, resumed
    with accu_grad=2: the restored counter (2, then 3) is already at the new
    bound, and the next call updates and starts a new accumulation instead
    of never reaching equality."""
    _, variables, _, _, tconf = build_pair(d_hidden=32, SB=1)
    images, poses = source_view()
    batch = {"images": t(images), "poses": t(poses), "focal": torch.full((1,), FOCAL),
             "c": torch.full((1, 2), W / 2.0), "rays": t(novel_rays()[:, :16]),
             "rgb_gt": torch.rand((1, 16, 3), generator=torch.Generator().manual_seed(0))}
    cfg = tr.RenderConfig.from_conf(tconf["renderer"])
    noise = [tr.draw_noise(batch["rays"], cfg, torch.Generator().manual_seed(1), train=True)]
    net = make_model(tconf["model"], device="cpu")
    load_jax_variables(net, variables)
    opt = _opt(net, lr=1e-3)
    step = make_train_step(net, cfg, opt, make_render_loss(tconf["loss"]), accu_grad=2)
    opt.accumulation = {"mini_step": 2, "acc_grads": None}
    start = {k: p.detach().clone() for k, p in net.named_parameters()}
    step(batch, noise=noise)
    assert opt.accumulation == {"mini_step": 0, "acc_grads": None}
    assert any(not torch.equal(start[k], p) for k, p in net.named_parameters())
