"""The port's DVR (NMR ShapeNet and DTU), multi-object and colour-jitter
readers, its factory and its ``lindisp`` sampling against the JAX
package's, on the CPU, on small fixtures written here; and the DTU
geometry through the model: an encode plus staged render at NS = 3 on
non-square images with an off-centre principal point, and one DTU train
step at ``-V 3``, each against JAX.

- items: images, masks and bboxes exact; poses, focal and ``c`` to 1e-6
  (NMR) or 1e-5 (DTU, whose P is decomposed by ``cv2`` in the JAX reader
  and by the port's numpy RQ, float32 P);
- the decomposition against ``cv2.decomposeProjectionMatrix`` on seeded P
  of both signs: K and R to 1e-12, the centre to 1e-6 relative (``cv2``
  returns it in float32);
- the render at the repo's f32 tolerance (5e-4, tests/test_torch_render.py),
  the train step at ``_compare_step``'s (tests/test_torch_train.py).
"""
import dataclasses

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pixelnerf_tpu.data import get_split_dataset as jax_get_split_dataset
from pixelnerf_tpu.data.color_jitter import ColorJitterDataset as JaxColorJitter
from pixelnerf_tpu.data.dvr import DVRDataset as JaxDVR
from pixelnerf_tpu.data.multi_object import MultiObjectDataset as JaxMultiObject
from pixelnerf_tpu.render import renderer as jr
from pixelnerf_tpu.train import TrainState, make_render_loss as jax_make_loss
from pixelnerf_tpu.train import make_train_step as jax_make_train_step
from pixelnerf_tpu_torch.data import (
    ColorJitterDataset,
    DVRDataset,
    MultiObjectDataset,
    RayBatchPipeline,
    get_split_dataset,
)
from pixelnerf_tpu_torch.data.dvr import decompose_projection
from pixelnerf_tpu_torch.render import renderer as tr
from pixelnerf_tpu_torch.train import make_render_loss, make_train_step
from pixelnerf_tpu_torch.utils import geometry

from test_torch_train import LR, _capture_grads, _compare_step, _port
from torch_port_utils import (
    DTU_H,
    DTU_VIEWS,
    DTU_W,
    build_pair,
    jax_chunk_draws,
    jax_draws,
    novel_rays,
    orbit,
    t,
    write_dtu_fixture,
    write_multi_obj_fixture,
    write_nmr_fixture,
)

@pytest.fixture(scope="module")
def data(tmp_path_factory):
    rng = np.random.default_rng(0)
    root = tmp_path_factory.mktemp("readers")
    return {"nmr": write_nmr_fixture(str(root / "nmr"), rng), "dtu": write_dtu_fixture(str(root / "dtu"), rng),
            "multi": write_multi_obj_fixture(str(root / "multi"), rng)}


def _assert_items(ref, got, close=(), atol=0.0):
    """Every key of two items: exact, or to ``atol`` for the keys in ``close``."""
    assert set(ref) == set(got), (set(ref), set(got))
    for k in ref:
        if isinstance(ref[k], str) or isinstance(ref[k], int):
            assert ref[k] == got[k], k
            continue
        a, b = np.asarray(ref[k]), np.asarray(got[k])
        assert a.dtype == b.dtype and a.shape == b.shape, (k, a.dtype, b.dtype, a.shape, b.shape)
        if k in close:
            np.testing.assert_allclose(b, a, atol=atol, rtol=atol, err_msg=k)
        else:
            np.testing.assert_array_equal(b, a, err_msg=k)


@pytest.mark.parametrize("kw", [dict(), dict(scale_focal=False, cache_cap=2), dict(image_size=(8, 8))],
                         ids=["native", "unscaled_cached", "resized"])
def test_dvr_shapenet_matches_jax(data, kw):
    for stage in ("train", "test"):
        ref, got = JaxDVR(data["nmr"], stage=stage, **kw), DVRDataset(data["nmr"], stage=stage, **kw)
        assert len(got) == len(ref) > 0 and got.all_objs == ref.all_objs
        assert (got.z_near, got.z_far, got.lindisp) == (ref.z_near, ref.z_far, ref.lindisp)
        for i in range(len(ref)):
            _assert_items(ref[i], got[i], close=("poses", "focal"), atol=1e-6)
        if kw.get("cache_cap"):
            assert got[0] is got[0]


def test_dvr_dtu_matches_jax(data):
    kw = dict(list_prefix="new_", sub_format="dtu", scale_focal=False, z_near=0.1, z_far=5.0)
    for stage in ("train", "val"):
        ref, got = JaxDVR(data["dtu"], stage=stage, **kw), DVRDataset(data["dtu"], stage=stage, **kw)
        assert len(got) == len(ref) > 0
        for i in range(len(ref)):
            a, b = ref[i], got[i]
            _assert_items(a, b, close=("poses", "focal", "c"), atol=1e-5)
            assert b["images"].shape == (DTU_VIEWS, DTU_H, DTU_W, 3)
            # the off-centre principal point and fx != fy survive; a negative
            # scale of P flips the sign of fx and fy, in both readers
            sign = -1.0 if stage == "val" else 1.0
            assert b["c"][0] - DTU_W / 2 > 2 and sign * b["focal"][0] > 30
            assert abs(b["focal"][0] - b["focal"][1]) > 1e-3


def test_dvr_max_imgs_draws_the_same_views(data):
    """An object of more views than ``max_imgs``: each pull draws its views
    from the reader's seeded generator, the same ones in both readers, and
    is not cached."""
    kw = dict(list_prefix="new_", sub_format="dtu", scale_focal=False, max_imgs=3, seed=5, cache_cap=4)
    ref, got = JaxDVR(data["dtu"], stage="train", **kw), DVRDataset(data["dtu"], stage="train", **kw)
    pulls = [got[0] for _ in range(3)]
    for item in pulls:
        _assert_items(ref[0], item, close=("poses", "focal", "c"), atol=1e-5)
        assert item["images"].shape[0] == 3
    assert not np.array_equal(pulls[0]["images"], pulls[1]["images"]) or \
        not np.array_equal(pulls[1]["images"], pulls[2]["images"])


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_decompose_projection_matches_cv2(sign):
    rng = np.random.default_rng(int(sign > 0))
    for _ in range(50):
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        q[:, 0] *= np.sign(np.linalg.det(q))
        K = np.array([[rng.uniform(500, 900), rng.uniform(-2, 2), rng.uniform(100, 300)],
                      [0, rng.uniform(500, 900), rng.uniform(100, 300)], [0, 0, 1]])
        P = (sign * rng.uniform(0.5, 2) * K @ np.hstack([q, rng.normal(size=(3, 1)) * 100])).astype(np.float32)
        Kc, Rc, tc = cv2.decomposeProjectionMatrix(P)[:3]
        Km, Rm, centre = decompose_projection(P)
        np.testing.assert_allclose(Km, Kc / Kc[2, 2], atol=1e-12 * np.abs(Kc).max(), rtol=0)
        np.testing.assert_allclose(Rm, Rc, atol=1e-12, rtol=0)
        ref_centre = (tc[:3] / tc[3])[:, 0]
        np.testing.assert_allclose(centre, ref_centre, atol=1e-6 * np.abs(ref_centre).max(), rtol=0)


def test_color_jitter_matches_jax(data):
    kw = dict(list_prefix="new_", sub_format="dtu", scale_focal=False, z_near=0.1, z_far=5.0)
    ref = JaxColorJitter(JaxDVR(data["dtu"], **kw), extra_inherit_attrs=["sub_format"], seed=3)
    got = ColorJitterDataset(DVRDataset(data["dtu"], **kw), extra_inherit_attrs=["sub_format"], seed=3)
    for attr in ("z_near", "z_far", "lindisp", "base_path", "sub_format"):
        assert getattr(got, attr) == getattr(ref, attr), attr
    for i in (0, 1, 0):
        a, b = ref[i], got[i]
        np.testing.assert_array_equal(b["images"], a["images"])
        assert b["images"].dtype == np.float32


@pytest.mark.parametrize("n_views", [None, 3])
def test_multi_object_matches_jax(data, n_views):
    ref = JaxMultiObject(data["multi"], stage="train", n_views=n_views)
    got = MultiObjectDataset(data["multi"], stage="train", n_views=n_views)
    assert len(got) == len(ref) == 3 and got.trans_files == ref.trans_files
    for i in range(3):
        a, b = ref[i], got[i]
        if n_views is not None and i == 1:
            assert a == {} and b == {}
            continue
        _assert_items(a, b)
    assert np.array_equal(got[2]["bbox"][1], [0, 0, 12, 12])       # the empty frame's bbox


@pytest.mark.parametrize("fmt", ["dvr", "dvr_gen", "dvr_dtu", "multi_obj"])
def test_get_split_dataset_flags_match_jax(data, fmt):
    path = {"dvr": data["nmr"], "dvr_gen": data["nmr"], "dvr_dtu": data["dtu"], "multi_obj": data["multi"]}[fmt]
    attrs = ("list_prefix", "max_imgs", "sub_format", "scale_focal", "z_near", "z_far", "lindisp", "stage",
             "all_objs", "trans_files", "n_views", "base_path", "image_size")
    for training in (True, False):
        ours = get_split_dataset(fmt, path, training=training)
        theirs = jax_get_split_dataset(fmt, path, training=training)
        for a, b in zip(theirs, ours):
            assert type(a).__name__ == type(b).__name__
            inner_a, inner_b = getattr(a, "base_dset", a), getattr(b, "base_dset", b)
            assert type(inner_a).__name__ == type(inner_b).__name__
            for attr in attrs:
                assert getattr(inner_a, attr, None) == getattr(inner_b, attr, None), (fmt, training, attr)
            assert getattr(a, "sub_format", None) == getattr(b, "sub_format", None)
            if len(a):
                _assert_items(a[0], b[0], close=("poses", "focal", "c"), atol=1e-5)


def test_lindisp_samplers_match_jax():
    cfg = dict(n_coarse=16, n_fine=8, n_fine_depth=4, white_bkgd=False, lindisp=True)
    jcfg, tcfg = jr.RenderConfig(**cfg), tr.RenderConfig(**cfg)
    rays = novel_rays()[:, :12].copy()
    rays[..., 6], rays[..., 7] = 0.1, 5.0                         # DTU's bounds
    key = jax.random.PRNGKey(3)
    noise = jax_draws(key, 1, 12, jcfg)
    k_coarse, k_fine, _, _, _ = jax.random.split(key, 5)
    zc_j = np.asarray(jr.sample_coarse(k_coarse, jnp.asarray(rays), jcfg))
    zc_t = tr.sample_coarse(t(rays), tcfg, noise["coarse"])
    np.testing.assert_allclose(zc_t.numpy(), zc_j, rtol=1e-6)
    # linear in disparity: most samples near the camera, unlike linear depth
    assert np.median(zc_j) < 0.5 and zc_j.min() >= 0.1 and zc_j.max() <= 5.0
    w = np.random.default_rng(0).uniform(0, 1, (1, 12, 16)).astype(np.float32)
    zf_j = jr.sample_fine(k_fine, jnp.asarray(rays), jnp.asarray(w), jcfg)
    zf_t = tr.sample_fine(t(rays), t(w), tcfg, noise["fine_u"], noise["fine_jitter"])
    np.testing.assert_allclose(zf_t.numpy(), np.asarray(zf_j), rtol=1e-5)
    assert tr.RenderConfig.from_conf(_Conf(), lindisp=True).lindisp
    assert tr.NeRFRenderer.from_conf(_Conf(), lindisp=True).cfg.lindisp


class _Conf:
    """A renderer config node with no keys: every default."""

    def get_int(self, key, default):
        return default

    def get_float(self, key, default):
        return default


# --- DTU geometry through the model: NS = 3, 40x30, off-centre c --------------

NS = 3


def _dtu_views(SB, seed=0):
    """SB objects x NS source views at 40x30: images, c2w poses, per-object
    (fx, fy) and an off-centre c."""
    rng = np.random.default_rng(seed)
    images = rng.uniform(-1, 1, (SB, NS, DTU_H, DTU_W, 3)).astype(np.float32)
    poses = np.stack([np.stack([geometry.look_at(orbit(v + s, 5, 1.3), np.zeros(3)) for v in range(NS)])
                      for s in range(SB)])
    focal = np.array([[36.5 + s, 34.0 - s] for s in range(SB)], np.float32)
    c = np.array([[DTU_W / 2 + 3.5, DTU_H / 2 - 2.5]] * SB, np.float32)
    return images, poses, focal, c


@pytest.fixture(scope="module")
def pair():
    return build_pair(SB=2)


def test_encode_and_staged_render_at_ns3_non_square_match_jax(pair):
    jnet, variables, tnet, jconf, tconf = pair
    jcfg = jr.RenderConfig.from_conf(jconf["renderer"])
    tcfg = tr.RenderConfig.from_conf(tconf["renderer"])
    images, poses, focal, c = _dtu_views(1)
    enc_j = jnet.apply(variables, jnp.asarray(images), jnp.asarray(poses), jnp.asarray(focal), c=jnp.asarray(c),
                       method=jnet.encode)
    with torch.no_grad():
        enc_t = tnet.encode(t(images), t(poses), t(focal), c=t(c))
    lat_j = np.asarray(enc_j.latent)
    assert enc_t.latent.shape == lat_j.shape and lat_j.shape[1] != lat_j.shape[2]   # H' != W'
    np.testing.assert_allclose(enc_t.latent.numpy(), lat_j, atol=1e-4)
    target = geometry.look_at(orbit(0.5, 5, 1.3), np.zeros(3))[None]
    rays = np.asarray(geometry.gen_rays(target, 8, 6, focal[0] / 5, 0.8, 1.8, c=c[0] / 5, device="cpu"))
    rays = rays.reshape(1, -1, 8)
    key = jax.random.PRNGKey(7)

    def features_fn(xyz, viewdirs):
        return jnet.apply(variables, enc_j, xyz, viewdirs=viewdirs, method=jnet.query_features)

    def mlp_fn(feats, coarse):
        return jnet.apply(variables, enc_j, feats, coarse=coarse, method=jnet.query_mlp)

    # jitted: compiled once instead of dispatched op by op
    ref = jax.jit(lambda r: jr.render_rays((features_fn, mlp_fn), r, key, jcfg, want_weights=True))(
        jnp.asarray(rays))
    with torch.no_grad():
        out = tr.render_rays(
            (lambda xyz, vd: tnet.query_features(enc_t, xyz, vd),
             lambda feats, coarse: tnet.query_mlp(enc_t, feats, coarse)),
            t(rays), tcfg, noise=jax_draws(key, 1, rays.shape[1], jcfg), want_weights=True,
        )
    for branch in ("coarse", "fine"):
        for k in ("rgb", "depth", "weights"):
            np.testing.assert_allclose(out[branch][k].numpy(), np.asarray(ref[branch][k]), atol=5e-4,
                                       err_msg=f"{branch}/{k}")
    assert float(np.std(np.asarray(ref["fine"]["rgb"]))) > 1e-3


def test_dtu_train_step_at_three_views_matches_jax(pair, data):
    """One step on a batch that the port's pipeline draws from the port's
    DTU reader at ``-V 3`` (2 objects x 16 rays), the same numpy batch
    into both steps, JAX's draws injected."""
    jnet, variables, _, jconf, tconf = pair
    dset = get_split_dataset("dvr_dtu", data["dtu"], "train")
    pipe = RayBatchPipeline(dset, batch_size=2, rays_per_object=16, views=(NS,), seed=1, prefetch=0, workers=1)
    batch = {k: v for k, v in next(iter(pipe)).items() if k != "step"}
    assert batch["images"].shape == (2, NS, DTU_H, DTU_W, 3) and batch["focal"].shape == (2, 2)
    jcfg = dataclasses.replace(jr.RenderConfig.from_conf(jconf["renderer"]), noise_std=0.5, white_bkgd=False)
    opt = optax.chain(_capture_grads(), optax.adam(LR))
    jstep = jax_make_train_step(jnet, jcfg, opt, jax_make_loss(jconf["loss"]), ray_chunk=None, remat=False)
    state = TrainState(params=variables["params"], batch_stats=variables["batch_stats"],
                       opt_state=opt.init(variables["params"]), step=jnp.zeros((), jnp.int32))
    key = jax.random.PRNGKey(31)
    jstate, jmetrics = jstep(state, {k: jnp.asarray(v) for k, v in batch.items()}, key)
    jstate = jax.device_get(jstate)
    net, topt = _port(variables, tconf)
    tcfg = tr.RenderConfig(n_coarse=jcfg.n_coarse, n_fine=jcfg.n_fine, n_fine_depth=jcfg.n_fine_depth,
                           noise_std=jcfg.noise_std, depth_std=jcfg.depth_std, white_bkgd=False)
    step = make_train_step(net, tcfg, topt, make_render_loss(tconf["loss"]))
    metrics = step({k: t(v) for k, v in batch.items()}, noise=jax_chunk_draws(key, 2, 16, jcfg))
    _compare_step(net, metrics, jstate, {k: float(v) for k, v in jmetrics.items()}, jstate.opt_state[0])
