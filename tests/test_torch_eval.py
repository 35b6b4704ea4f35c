"""The port's evaluation pieces against the JAX package on the CPU.

- a reference checkpoint (the JAX package's ``export_torch_checkpoint``)
  loads into the port: every tensor equals ``from_jax_variables`` of the
  same state, and every key is accounted for;
- ``apps/eval.py`` ``render_object`` (encode + ``FullRenderer`` over the
  target views) equals the JAX app's per-object render with JAX's draws
  injected, at float32, to the tolerance of
  ``test_full_renderer_matches_jax_f32`` (5e-4), for one and two source
  views, ``--coarse`` and ``--scale 0.5``; ``eval_approx``'s SB = 2 render
  equals JAX's ``render_batch`` the same way;
- ``--pretrained_encoder`` loads what the JAX package's
  ``load_pretrained_encoder`` loads, and raises where it raises.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixelnerf_tpu.data import SyntheticSphereDataset as JaxSynthetic
from pixelnerf_tpu.eval.common import FullRenderer as JaxFullRenderer
from pixelnerf_tpu.models.torch_import import load_pretrained_encoder as jax_load_pretrained_encoder
from pixelnerf_tpu.render import renderer as jr
from pixelnerf_tpu.train.state import TrainState, export_torch_checkpoint
from pixelnerf_tpu.utils import geometry as jax_geometry
from pixelnerf_tpu_torch.apps import eval as eval_app
from pixelnerf_tpu_torch.apps import eval_approx
from pixelnerf_tpu_torch.eval import FullRenderer
from pixelnerf_tpu_torch.models import (
    coarse_only,
    from_jax_variables,
    load_pretrained_encoder,
    load_reference_state_dict,
    make_model,
)

from torch_port_utils import build_pair, jax_draws


@pytest.fixture(scope="module")
def pair():
    return build_pair()


# ---------------------------------------------------------------------------
# the reference checkpoint


def test_reference_checkpoint_from_jax_export_loads_exactly(pair, tmp_path):
    jnet, variables, _, _, tconf = pair
    state = TrainState(params=variables["params"], batch_stats=variables["batch_stats"], opt_state=None,
                       step=jnp.zeros((), jnp.int32))
    path = str(tmp_path / "pixel_nerf_latest")
    export_torch_checkpoint(state, path)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    net = make_model(tconf["model"], device="cpu", generator=torch.Generator().manual_seed(5))
    skipped = load_reference_state_dict(net, sd)
    assert skipped == []
    ref = from_jax_variables(variables)
    own = net.state_dict()
    assert set(ref) == {k for k in own if not k.endswith("num_batches_tracked")}
    for k, v in ref.items():
        torch.testing.assert_close(own[k], v, atol=0, rtol=0, msg=k)


def test_reference_checkpoint_keys_are_accounted_for(pair):
    """The reference's own extra keys are skipped by name (its buffers, the
    trunk's unused stages, batch-norm counters); any other key, a missing
    tensor or a positional code that disagrees with the config raises."""
    _, variables, tnet, _, tconf = pair
    sd = dict(from_jax_variables(variables))
    freqs, phases = tnet.code.tables()
    extra = {
        "code._freqs": torch.from_numpy(freqs).view(1, -1, 1),
        "code._phases": torch.from_numpy(phases).view(1, -1, 1),
        "encoder.latent": torch.zeros(1, 1, 1, 1), "encoder.latent_scaling": torch.zeros(2),
        "poses": torch.zeros(1, 3, 4), "image_shape": torch.zeros(2), "focal": torch.zeros(1, 2),
        "c": torch.zeros(1, 2),
        "encoder.model.layer3.0.conv1.weight": torch.zeros(256, 128, 3, 3),
        "encoder.model.fc.weight": torch.zeros(1000, 512),
        "encoder.model.bn1.num_batches_tracked": torch.tensor(7),
    }
    net = make_model(tconf["model"], device="cpu")
    skipped = load_reference_state_dict(net, {**sd, **extra})
    assert sorted(skipped) == sorted(k for k in extra if k != "encoder.model.bn1.num_batches_tracked")
    assert int(net.encoder.model.bn1.num_batches_tracked) == 7
    with pytest.raises(ValueError, match="unexpected.*mlp_coarse.extra"):
        load_reference_state_dict(net, {**sd, "mlp_coarse.extra.weight": torch.zeros(2)})
    missing = {k: v for k, v in sd.items() if k != "mlp_fine.lin_out.bias"}
    with pytest.raises(ValueError, match="missing.*mlp_fine.lin_out.bias"):
        load_reference_state_dict(net, missing)
    with pytest.raises(ValueError, match="positional code"):
        load_reference_state_dict(net, {**sd, "code._freqs": torch.from_numpy(2 * freqs)})
    wrong = dict(sd)
    wrong["mlp_coarse.lin_in.weight"] = torch.zeros(3, 3)
    with pytest.raises(RuntimeError, match="size mismatch"):
        load_reference_state_dict(net, wrong)


# ---------------------------------------------------------------------------
# the per-object eval render against the JAX app's


SRN_LIKE = types.SimpleNamespace(lindisp=False)     # the dataset attribute the eval config reads


def _data(num_views=3, size=32):
    return JaxSynthetic(num_objects=1, num_views=num_views, image_size=(size, size), radius=1.3)[0]


def _jax_object_render(jnet, variables, jcfg, data, src, targets, scale, near, far, key, chunk):
    """The JAX eval app's per-object steps (encode, rays, ``FullRenderer``)."""
    H, W = data["images"].shape[1:3]
    rH, rW = int(round(H * scale)), int(round(W * scale))
    c_arr = data.get("c", np.array([W / 2.0, H / 2.0], np.float32))
    enc = jnet.apply(variables, jnp.asarray(data["images"][None, src]), jnp.asarray(data["poses"][None, src]),
                     jnp.asarray(data["focal"]), c=jnp.asarray(c_arr[None]), method=jnet.encode)
    rays = np.asarray(jax_geometry.gen_rays(
        jnp.asarray(data["poses"][targets]), rW, rH, jnp.asarray(data["focal"] * scale), near, far,
        c=jnp.asarray(c_arr * scale),
    )).reshape(-1, 8)
    out = JaxFullRenderer(jnet, jcfg, ray_chunk=chunk, scan_chunk=chunk)(variables, enc, rays, key)
    branch = out["fine"] if jcfg.using_fine else out["coarse"]
    return (branch["rgb"].reshape(len(targets), rH, rW, 3), branch["depth"].reshape(len(targets), rH, rW))


def jax_eval_draws(key, SB, n_rays, chunk, cfg):
    """The draws of JAX's ``FullRenderer``: per ray chunk a key split off
    ``key`` and drawn at the full chunk size (the last chunk is padded),
    cut to the chunk's rays."""
    noise = []
    for start in range(0, n_rays, chunk):
        key, sub = jax.random.split(key)
        n = min(chunk, n_rays - start)
        noise.append({k: v[:, :n] for k, v in jax_draws(sub, SB, chunk, cfg).items()})
    return noise


EVAL_CASES = {
    "one_source": dict(src=[0], targets=[1, 2], scale=1.0, coarse=False),
    "two_sources": dict(src=[0, 1], targets=[2], scale=1.0, coarse=False),
    "coarse": dict(src=[0], targets=[2], scale=1.0, coarse=True),
    "scale_half": dict(src=[1], targets=[0, 2], scale=0.5, coarse=False),
}


@pytest.mark.parametrize("case", list(EVAL_CASES))
def test_eval_render_object_matches_jax_app_f32(pair, case):
    jnet, variables, tnet, jconf, tconf = pair
    c = EVAL_CASES[case]
    data = _data()
    near, far = 0.8, 1.8
    # the eval apps' sampling: at least 64 coarse samples; --coarse drops
    # the fine MLP and samples 64 + 128
    jcfg = dataclasses.replace(jr.RenderConfig.from_conf(jconf["renderer"]), n_coarse=64)
    net = tnet
    if c["coarse"]:
        jcfg = dataclasses.replace(jcfg, n_fine=128)
        jnet = jnet.clone(mlp_fine=None)
        net = coarse_only(tnet)
        assert tnet.mlp_fine is not None and net.mlp_fine is None and net.encoder is tnet.encoder
    tcfg = eval_app.eval_render_config(tconf, SRN_LIKE, c["coarse"])
    assert (tcfg.n_coarse, tcfg.n_fine, tcfg.n_fine_depth) == (jcfg.n_coarse, jcfg.n_fine, jcfg.n_fine_depth)
    src, targets = np.array(c["src"]), np.array(c["targets"])
    chunk = 700                                     # several chunks, the last one short
    key = jax.random.PRNGKey(3)
    rgb_j, depth_j = _jax_object_render(jnet, variables, jcfg, data, src, targets, c["scale"], near, far, key, chunk)
    n_rays = rgb_j.shape[0] * rgb_j.shape[1] * rgb_j.shape[2]
    noise = jax_eval_draws(key, 1, n_rays, chunk, jcfg)
    rgb_t, depth_t = eval_app.render_object(FullRenderer(net, tcfg, ray_chunk=chunk), data, src, targets,
                                            near, far, c["scale"], noise=noise)
    assert rgb_t.shape == rgb_j.shape and depth_t.shape == depth_j.shape
    np.testing.assert_allclose(rgb_t.numpy(), rgb_j, atol=5e-4)
    np.testing.assert_allclose(depth_t.numpy(), depth_j, atol=5e-4)
    assert float(np.std(rgb_j)) > 1e-3


def test_eval_approx_render_group_matches_jax_render_batch(pair):
    """Two objects encoded as one SB = 2 batch, each rendering its own
    target view: the gather's table holds both scenes' latents."""
    jnet, variables, tnet, jconf, tconf = pair
    objs = JaxSynthetic(num_objects=2, num_views=3, image_size=(32, 32), radius=1.3)
    group = [(objs[0], np.array([0]), 2, objs[0]["c"]), (objs[1], np.array([1]), 0, objs[1]["c"])]
    near, far = 0.8, 1.8
    jcfg = dataclasses.replace(jr.RenderConfig.from_conf(jconf["renderer"]), n_coarse=64)
    images = jnp.asarray(np.stack([d["images"][s] for d, s, _, _ in group]))
    poses = jnp.asarray(np.stack([d["poses"][s] for d, s, _, _ in group]))
    focal = jnp.asarray(np.stack([np.broadcast_to(np.atleast_1d(np.asarray(d["focal"], np.float32)), (2,))
                                  for d, _, _, _ in group]))
    cc = jnp.asarray(np.stack([ca for _, _, _, ca in group]))
    enc = jnet.apply(variables, images, poses, focal, c=cc, method=jnet.encode)
    rays = np.stack([np.asarray(jax_geometry.gen_rays(
        jnp.asarray(d["poses"][t : t + 1]), 32, 32, jnp.asarray(d["focal"]), near, far, c=jnp.asarray(ca)))[0].reshape(-1, 8)
        for d, _, t, ca in group])
    chunk = 600
    key = jax.random.PRNGKey(8)
    out = JaxFullRenderer(jnet, jcfg, ray_chunk=chunk, scan_chunk=chunk).render_batch(variables, enc, rays, key)
    rgb_j = out["fine"]["rgb"].reshape(2, 32, 32, 3)
    noise = jax_eval_draws(key, 2, 32 * 32, chunk, jcfg)
    tcfg = eval_app.eval_render_config(tconf, SRN_LIKE, False)
    rgb_t = eval_approx.render_group(FullRenderer(tnet, tcfg, ray_chunk=chunk), group, near, far, noise=noise)
    np.testing.assert_allclose(rgb_t.numpy(), rgb_j, atol=5e-4)
    # the two scenes' renders differ: each row base addressed its own scene
    assert float(np.abs(rgb_j[0] - rgb_j[1]).max()) > 1e-2


# ---------------------------------------------------------------------------
# --pretrained_encoder


def test_pretrained_encoder_loads_as_jax_does_and_raises(pair, tmp_path):
    from torchvision_stub import resnet18, resnet34

    _, variables, _, _, tconf = pair
    torch.manual_seed(1)
    sd = resnet34().state_dict()
    jvars = jax_load_pretrained_encoder(variables, _save(tmp_path / "r34.pth", sd))
    ref = from_jax_variables(jvars)
    net = make_model(tconf["model"], device="cpu")
    load_pretrained_encoder(net, torch.load(str(tmp_path / "r34.pth"), weights_only=True))
    own = net.state_dict()
    trunk = [k for k in ref if k.startswith("encoder.model.")]
    assert len(trunk) > 20
    for k in trunk:
        torch.testing.assert_close(own[k], ref[k], atol=0, rtol=0, msg=k)
    assert torch.equal(own["encoder.model.conv1.weight"], sd["conv1.weight"])
    # a wrapped state_dict loads the same
    load_pretrained_encoder(net, {"state_dict": sd})
    with pytest.raises(ValueError, match="missing tensor layer1.2"):
        load_pretrained_encoder(net, resnet18().state_dict())
    bad = dict(sd)
    bad["conv1.weight"] = torch.zeros(64, 3, 5, 5)
    with pytest.raises(ValueError, match="shape mismatch at conv1.weight"):
        load_pretrained_encoder(net, bad)
    with pytest.raises(ValueError):
        jax_load_pretrained_encoder(variables, _save(tmp_path / "bad.pth", bad))


def _save(path, sd):
    torch.save(sd, str(path))
    return str(path)
