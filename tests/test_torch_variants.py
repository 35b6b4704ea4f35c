"""The port's model variants against the JAX package's on the CPU: the
``feature_scale`` pre-resize, the quad-corner gather, the global image
encoder, the custom conv encoder, SPADE and softplus in ResnetFC, the
ImplicitNet field, a train step of each, and the weight bridge of their
layers. Each variant is a small SRN-shaped model (32x32 images, a 2-stage
ResNet34 encoder, MLPs of width 64) built in the JAX package, its weights
moved off their init with numpy draws and carried into the port."""
import dataclasses
import importlib

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pixelnerf_tpu.config import load_config as jax_load_config
from pixelnerf_tpu.models import bake_encoding as jax_bake_encoding
from pixelnerf_tpu.models import make_model as jax_make_model
from pixelnerf_tpu.models.encoder import ConvEncoder as JaxConvEncoder
from pixelnerf_tpu.models.encoder import ImageEncoder as JaxImageEncoder
from pixelnerf_tpu.models.encoder import SpatialEncoder as JaxSpatialEncoder
from pixelnerf_tpu.models.mlp import ImplicitNet as JaxImplicitNet
from pixelnerf_tpu.models.resnetfc import ResnetFC as JaxResnetFC
from pixelnerf_tpu.models.torch_import import export_state_dict as jax_export_state_dict
from pixelnerf_tpu.models.torch_import import import_state_dict as jax_import_state_dict
from pixelnerf_tpu.ops.resize import resize_area as jax_resize_area
from pixelnerf_tpu.render import renderer as jr
from pixelnerf_tpu.train import TrainState, make_render_loss as jax_make_loss
from pixelnerf_tpu.train import make_train_step as jax_make_train_step
from pixelnerf_tpu_torch.config import load_config
from pixelnerf_tpu_torch.models import (
    ConvEncoder,
    ImageEncoder,
    ImplicitNet,
    ResnetFC,
    SpatialEncoder,
    bake_encoding,
    export_state_dict,
    from_jax_variables,
    load_jax_variables,
    load_reference_state_dict,
    make_model,
    pack_encoding,
)
from pixelnerf_tpu_torch.models import resnetfc as tresnetfc
from pixelnerf_tpu_torch.models.encoder import ConvTranspose
from pixelnerf_tpu_torch.ops import grid_sample as tgs
from pixelnerf_tpu_torch.ops.fused_mlp import (
    KC,
    _tile_matrix,
    fused_resnetfc_infer_plain,
    pack_weights,
    tile_weights,
    z_tile_width,
)
from pixelnerf_tpu_torch.ops.resize import resize_area
from pixelnerf_tpu_torch.render import renderer as tr
from pixelnerf_tpu_torch.train import make_render_loss, make_train_step

from torch_port_utils import FOCAL, H, W, jax_chunk_draws, jax_draws, novel_rays, perturb, small_conf, source_view, t
from test_torch_train import LR, NOISE_STD, R, SB, _batch, _compare_step, _port_cfg

jgs = importlib.import_module("pixelnerf_tpu.ops.grid_sample")


def _np(x):
    return np.asarray(x, np.float32)


# --- the variants, as edits of the small SRN-shaped config -------------------

IMPLICIT = {"type": "mlp", "dims": [48, 48, 48, 48], "skip_in": [2], "combine_layer": 3,
            "dim_excludes_skip": True}


def _edit(m, name):
    if name == "global":
        m["use_global_encoder"] = True
        m["global_encoder"] = {"backbone": "resnet18", "latent_size": 16}
    elif name == "custom":
        m["encoder"]["backbone"] = "custom"
    elif name == "spade_softplus":
        for mlp in ("mlp_coarse", "mlp_fine"):
            m[mlp]["use_spade"] = True
            m[mlp]["beta"] = 3.0
    elif name == "implicit":
        m["mlp_coarse"] = dict(IMPLICIT)
        m["mlp_fine"] = dict(IMPLICIT)
    elif name == "quad":
        m["quad_gather"] = True
    elif name == "feature_scale":
        m["encoder"]["feature_scale"] = 0.5
    elif name != "base":
        raise ValueError(name)


def variant_pair(name, dtype=None, SB=1, seed=0):
    """The JAX net of variant ``name`` with perturbed variables, and the
    port's net on the CPU holding the same weights: (jnet, variables, tnet,
    jconf, tconf). The variables do not depend on ``SB``."""
    jconf, tconf = small_conf(jax_load_config, dtype=dtype), small_conf(load_config, dtype=dtype)
    _edit(jconf["model"], name)
    _edit(tconf["model"], name)
    jnet = jax_make_model(jconf["model"])
    images, poses = source_view(SB)
    variables = jnet.init(
        jax.random.PRNGKey(seed), jnp.asarray(images), jnp.asarray(poses),
        jnp.asarray(FOCAL), jnp.zeros((SB, 4, 3)), jnp.ones((SB, 4, 3)),
    )
    variables = perturb(jax.tree_util.tree_map(np.asarray, jax.device_get(variables)), seed)
    # density bias, so that the renders are not the white background
    for mlp in ("mlp_coarse", "mlp_fine"):
        p = variables["params"][mlp]
        out = p["lin_out"] if "lin_out" in p else p[f"lin{len(IMPLICIT['dims'])}"]
        out["bias"][3] += 3.0
    tnet = make_model(tconf["model"], device="cpu")
    load_jax_variables(tnet, variables)
    return jnet, variables, tnet, jconf, tconf


_PAIRS = {}


def pair_of(name):
    """One f32 pair per variant for the module (the JAX builds dominate);
    a test that changes the port's net makes its own from ``variables``."""
    if name not in _PAIRS:
        _PAIRS[name] = variant_pair(name)
    return _PAIRS[name]


def _encode_both(jnet, variables, tnet, SB=1):
    images, poses = source_view(SB)
    enc_j = jnet.apply(variables, jnp.asarray(images), jnp.asarray(poses), jnp.asarray(FOCAL), method=jnet.encode)
    with torch.no_grad():
        enc_t = tnet.encode(t(images), t(poses), FOCAL)
    return enc_j, enc_t


def _points(n_rays=16, n_z=5):
    rays = novel_rays()[:, :n_rays]
    z = np.linspace(0.9, 1.7, n_z, dtype=np.float32)
    pts = (rays[..., None, :3] + z[:, None] * rays[..., None, 3:6]).reshape(1, -1, 3)
    dirs = np.broadcast_to(rays[..., None, 3:6], (1, n_rays, n_z, 3)).reshape(1, -1, 3)
    return pts, np.ascontiguousarray(dirs)


# --- feature_scale and the area resize ---------------------------------------

@pytest.mark.parametrize("size", [(32, 32, 16, 16), (30, 20, 12, 9), (7, 5, 7, 5)])
def test_resize_area_matches_jax(size):
    h, w, oh, ow = size
    x = np.random.default_rng(0).normal(size=(2, h, w, 3)).astype(np.float32)
    ref = jax_resize_area(jnp.asarray(x), oh, ow)
    out = resize_area(torch.from_numpy(x), oh, ow)
    # two float32 contractions of weights 1/k in other orders
    np.testing.assert_allclose(out.numpy(), _np(ref), atol=1e-6)


@pytest.mark.parametrize("scale", [0.5, 2.0])
def test_feature_scale_encoder_matches_jax(scale):
    """SpatialEncoder with the input resized first: area below 1, bilinear
    with align_corners above."""
    jenc = JaxSpatialEncoder(num_layers=2, feature_scale=scale)
    x = np.random.default_rng(1).uniform(-1, 1, (2, 20, 20, 3)).astype(np.float32)
    variables = perturb(jax.device_get(jenc.init(jax.random.PRNGKey(0), jnp.asarray(x))), 1)
    ref = _np(jenc.apply(variables, jnp.asarray(x)))
    tenc = SpatialEncoder(num_layers=2, feature_scale=scale)
    tenc.load_state_dict(from_jax_variables(variables), strict=False)
    with torch.no_grad():
        out = tenc(torch.from_numpy(x)).numpy()
    side = int(round(20 * scale)) // 2
    assert out.shape == ref.shape == (2, side, side, 128)
    # float32 convolutions through 7 layers in two libraries (the encoder's
    # tolerance in tests/test_torch_models.py)
    np.testing.assert_allclose(out, ref, atol=1e-4)


# --- the quad-corner gather --------------------------------------------------

def test_quad_matches_grid_sample_and_jax():
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(2, 9, 13, 6)).astype(np.float32)
    grid = rng.uniform(-1.3, 1.3, size=(2, 77, 2)).astype(np.float32)
    quad = tgs.build_quad_features(torch.from_numpy(feats))
    np.testing.assert_array_equal(quad.numpy(), _np(jgs.build_quad_features(jnp.asarray(feats))))
    out = tgs.grid_sample_quad(quad, torch.from_numpy(grid))
    ref = tgs.grid_sample(torch.from_numpy(feats), torch.from_numpy(grid), "bilinear", "border", True)
    # the same lerp in float32, association as in grid_sample
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-6)
    jref = jgs.grid_sample_quad(jgs.build_quad_features(jnp.asarray(feats)), jnp.asarray(grid))
    np.testing.assert_allclose(out.numpy(), _np(jref), atol=1e-6)


def test_quad_edges_exact():
    """Corner and edge coordinates read the clamped values exactly."""
    feats = torch.arange(2 * 3 * 4, dtype=torch.float32).reshape(2, 3, 4, 1)
    grid = torch.tensor([[[-1, -1], [1, 1], [1, -1], [-1, 1], [0, 0]]] * 2, dtype=torch.float32)
    out = tgs.grid_sample_quad(tgs.build_quad_features(feats), grid)
    ref = tgs.grid_sample(feats, grid, "bilinear", "border", True)
    torch.testing.assert_close(out, ref, atol=0, rtol=0)


def test_quad_bf16_map_rounds_like_jax():
    """A bf16 map: the lerp runs in float32 from the map's values, as JAX's
    (bf16 * float32 promotes), and the model rounds the result once."""
    rng = np.random.default_rng(3)
    feats = rng.normal(size=(1, 8, 8, 16)).astype(np.float32)
    grid = rng.uniform(-1, 1, size=(1, 50, 2)).astype(np.float32)
    jq = jgs.build_quad_features(jnp.asarray(feats).astype(jnp.bfloat16))
    ref = _np(jgs.grid_sample_quad(jq, jnp.asarray(grid)))
    out = tgs.grid_sample_quad(tgs.build_quad_features(torch.from_numpy(feats).to(torch.bfloat16)),
                               torch.from_numpy(grid))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-6)


def test_quad_model_path_equals_four_corner_path_and_jax():
    """quad_gather = True against the four-corner gather on the same
    weights (in the port and in JAX), and the port's quad query against
    JAX's."""
    jnet, variables, tnet, jconf, tconf = pair_of("quad")
    enc_j, enc_t = _encode_both(jnet, variables, tnet)
    assert enc_t.latent_quad is not None and tuple(enc_t.latent_quad.shape) == (1, 16, 16, 512)
    pts, dirs = _points()
    base_conf = small_conf(load_config)
    four = make_model(base_conf["model"], device="cpu")
    four.load_state_dict(tnet.state_dict())
    with torch.no_grad():
        out_q = tnet.query(enc_t, t(pts), t(dirs))
        enc_4 = four.encode(*[t(a) for a in source_view()], FOCAL)
        assert enc_4.latent_quad is None
        out_4 = four.query(enc_4, t(pts), t(dirs))
    # one gather of pre-shifted rows against four: the same float32 lerp
    np.testing.assert_allclose(out_q.numpy(), out_4.numpy(), atol=1e-5)
    ref = jnet.apply(variables, enc_j, jnp.asarray(pts), jnp.asarray(dirs), method=jnet.query)
    # the encoder's 1e-4 carried through a 5-block MLP (test_torch_models.py)
    np.testing.assert_allclose(out_q.numpy(), _np(ref), atol=5e-4, rtol=1e-3)


# --- the global encoder --------------------------------------------------------

@pytest.mark.parametrize("latent_size", [16, 512])
def test_image_encoder_matches_jax(latent_size):
    """ResNetTrunk and ImageEncoder, with fc (latent_size != 512) and
    without, batch norms in inference and in training mode."""
    jenc = JaxImageEncoder(backbone="resnet18", latent_size=latent_size)
    # 64 px: layer4's maps are 2x2, so training mode's batch statistics are
    # taken over 12 values
    x = np.random.default_rng(2).uniform(-1, 1, (3, 64, 64, 3)).astype(np.float32)
    variables = perturb(jax.device_get(jenc.init(jax.random.PRNGKey(0), jnp.asarray(x))), 2)
    tenc = ImageEncoder(backbone="resnet18", latent_size=latent_size)
    assert (tenc.fc is None) == (latent_size == 512)
    tenc.load_state_dict(from_jax_variables(variables), strict=False)
    ref = _np(jenc.apply(variables, jnp.asarray(x)))
    ref_train, upd = jenc.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    with torch.no_grad():
        out = tenc(torch.from_numpy(x)).numpy()
        out_train = tenc(torch.from_numpy(x), train=True).numpy()
    assert out.shape == ref.shape == (3, latent_size)
    # float32 convolutions through 17 layers and a mean in two libraries
    # float32 convolutions through 17 layers and a mean in two libraries;
    # training mode divides by batch standard deviations of 12 values
    np.testing.assert_allclose(out, ref, atol=2e-4, rtol=1e-4)
    np.testing.assert_allclose(out_train, _np(ref_train), atol=5e-4, rtol=1e-3)
    stats = from_jax_variables({"batch_stats": upd["batch_stats"]})
    sd = tenc.state_dict()
    for k, v in stats.items():
        np.testing.assert_allclose(sd[k].numpy(), v.numpy(), atol=1e-5, rtol=1e-5, err_msg=k)


def test_global_encoder_float32_in_bf16_model():
    """make_model pushes dtype into the global_encoder subtree, but the
    encoder ignores it (as the JAX ImageEncoder does): the trunk and fc run
    in float32, so a bf16 model's global vector equals the f32 model's."""
    _, _, t32, _, _ = pair_of("global")
    conf = small_conf(load_config, dtype="bfloat16")
    _edit(conf["model"], "global")
    t16 = make_model(conf["model"], device="cpu")
    t16.load_state_dict(t32.state_dict())
    images, poses = source_view()
    with torch.no_grad():
        e16 = t16.encode(t(images), t(poses), FOCAL)
        e32 = t32.encode(t(images), t(poses), FOCAL)
    assert e16.global_latent.dtype == torch.float32 and e16.latent.dtype == torch.bfloat16
    torch.testing.assert_close(e16.global_latent, e32.global_latent, atol=0, rtol=0)
    assert t16.mlp_coarse.d_latent == 144


def test_global_model_encode_query_and_render_match_jax():
    jnet, variables, tnet, jconf, tconf = pair_of("global")
    assert tnet.d_latent == jnet.d_latent == 128 + 16
    enc_j, enc_t = _encode_both(jnet, variables, tnet)
    # the encoder's tolerance (float32 convolutions, two libraries)
    np.testing.assert_allclose(enc_t.global_latent.numpy(), _np(enc_j.global_latent), atol=2e-4, rtol=1e-4)
    np.testing.assert_allclose(enc_t.latent.numpy(), _np(enc_j.latent), atol=1e-4)
    pts, dirs = _points()
    feats_j = jnet.apply(variables, enc_j, jnp.asarray(pts), jnp.asarray(dirs), method=jnet.query_features)
    with torch.no_grad():
        feats_t = tnet.query_features(enc_t, t(pts), t(dirs))
    assert feats_t[0].shape == (1, 80, 144)
    # [global | gathered] in that order
    np.testing.assert_allclose(feats_t[0].numpy(), _np(feats_j[0]), atol=2e-4, rtol=1e-4)
    for coarse in (True, False):
        out_j = jnet.apply(variables, enc_j, feats_j, coarse=coarse, method=jnet.query_mlp)
        with torch.no_grad():
            out_t = tnet.query_mlp(enc_t, feats_t, coarse=coarse)
        np.testing.assert_allclose(out_t.numpy(), _np(out_j), atol=5e-4, rtol=1e-3)
    # a staged float32 render on JAX's draws (the 640-wide rows of the
    # card's config are 144 wide here)
    jcfg = jr.RenderConfig.from_conf(jconf["renderer"])
    tcfg = tr.RenderConfig.from_conf(tconf["renderer"])
    rays = novel_rays()
    key = jax.random.PRNGKey(7)
    ref = jr.render_rays(
        (lambda x, v: jnet.apply(variables, enc_j, x, viewdirs=v, method=jnet.query_features),
         lambda f, c: jnet.apply(variables, enc_j, f, coarse=c, method=jnet.query_mlp)),
        jnp.asarray(rays), key, jcfg)
    with torch.no_grad():
        out = tr.render_rays((lambda x, v: tnet.query_features(enc_t, x, v),
                              lambda f, c: tnet.query_mlp(enc_t, f, c)),
                             t(rays), tcfg, noise=jax_draws(key, 1, rays.shape[1], jcfg))
    for branch in ("coarse", "fine"):
        for k in ("rgb", "depth"):
            np.testing.assert_allclose(out[branch][k].numpy(), _np(ref[branch][k]), atol=5e-4,
                                       err_msg=f"{branch}/{k}")
    # non-degeneracy: the coarse field renders the object (this seed's fine
    # field is transparent along these rays, on both sides)
    assert float(np.std(_np(ref["coarse"]["rgb"]))) > 1e-3


def test_global_d_latent_144_kernel_b_plain_matches_jax_kernel():
    """d_latent 144 (a global latent of 16 before a 128-wide spatial one):
    kernel B's plain version against JAX's fused kernel in interpret mode,
    and the tiled image's Wz zero-padded to 192 columns."""
    jmlp = JaxResnetFC(d_in=42, d_latent=144, n_blocks=5, d_hidden=64, combine_layer=3, dtype=jnp.bfloat16)
    rng = np.random.default_rng(7)
    z = rng.normal(size=(300, 144)).astype(np.float32)
    x = rng.normal(size=(300, 42)).astype(np.float32)
    variables = perturb(jax.device_get(jmlp.init(jax.random.PRNGKey(0), (jnp.asarray(z[:8]), jnp.asarray(x[:8])))), 7)
    tmlp = ResnetFC(d_in=42, d_latent=144, n_blocks=5, d_hidden=64, combine_layer=3, dtype=torch.bfloat16)
    load_jax_variables(tmlp, variables)
    ref = _np(jmlp.apply(variables, (jnp.asarray(z), jnp.asarray(x)), combine_inner_dims=(1, 300), fast=True))
    with torch.no_grad():
        out = tmlp((t(z), t(x)), combine_inner_dims=(1, 300), fast=True).numpy()
    assert out.shape == ref.shape
    # tests/test_fused_mlp.py's tolerance: both round every layer to bf16,
    # and sums in another order can flip one rounding
    np.testing.assert_allclose(out, ref, atol=5e-2, rtol=5e-2)
    # and most entries agree to a bf16 ulp of the output (|out| reaches ~8
    # here, where an ulp is 2**-5)
    assert np.mean(np.abs(out - ref) <= 2.0 ** -7 * np.abs(ref) + 1e-3) > 0.95
    w = pack_weights(tmlp)
    assert z_tile_width(144) == 192 and w.image is not None and w.image_key == (KC, 5, 3, True)
    padded = list(w)
    padded[2] = torch.nn.functional.pad(w[2], (0, 48))
    wz_slabs = torch.cat([_tile_matrix(padded[2][i * 64:(i + 1) * 64]) for i in range(3)])
    assert torch.equal(tile_weights(w, KC, 5, 3), w.image)
    assert bool((wz_slabs.reshape(3, -1) != 0).any())
    assert torch.equal(tile_weights(tuple(padded), KC, 5, 3), w.image)


def test_query_fused_and_bake_encoding_refuse_the_global_encoder():
    conf = small_conf(load_config, dtype="bfloat16")
    _edit(conf["model"], "global")
    net = make_model(conf["model"], device="cpu")
    images, poses = source_view()
    with torch.no_grad():
        enc = net.encode(t(images), t(poses), FOCAL)
        with pytest.raises(ValueError, match="only latent"):
            bake_encoding(net, enc)
        pts, dirs = _points(4, 2)
        with pytest.raises(ValueError, match="only latent"):
            net.query_fused(pack_encoding(net, enc), t(pts), t(dirs))


# --- the custom conv encoder -------------------------------------------------

@pytest.mark.parametrize("size", [7, 8])
def test_conv_transpose_matches_flax(size):
    """flax ConvTranspose(VALID) against the port's ConvTranspose on the
    weight bridge's layout, at an odd and an even input size."""
    rng = np.random.default_rng(size)
    x = rng.normal(size=(2, size, size + 1, 5)).astype(np.float32)
    mod = fnn.ConvTranspose(6, (3, 3), strides=(2, 2), padding="VALID", use_bias=True)
    variables = mod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    variables = perturb(jax.device_get(variables), size)
    ref = _np(mod.apply(variables, jnp.asarray(x)))
    tmod = ConvTranspose(5, 6, 3, 2, bias=True)
    sd = from_jax_variables({"params": {"deconv": variables["params"]}})
    tmod.load_state_dict({k.split(".", 1)[1]: v for k, v in sd.items()})
    with torch.no_grad():
        out = tmod(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert out.shape == ref.shape == (2, 2 * size + 1, 2 * size + 3, 6)
    np.testing.assert_allclose(out, ref, atol=1e-5)


@pytest.mark.parametrize("size", [32, 64])
def test_conv_encoder_matches_jax(size):
    """At 32 and 64 px the mid map is 1x1 (128 channels); the layer after
    it is made at the width the loaded weights hold. A 128 px image (a 2x2
    mid map, 512 channels) then raises."""
    jenc = JaxConvEncoder()
    x = np.random.default_rng(size).uniform(-1, 1, (2, size, size, 3)).astype(np.float32)
    variables = perturb(jax.device_get(jenc.init(jax.random.PRNGKey(0), jnp.asarray(x))), size)
    ref = _np(jenc.apply(variables, jnp.asarray(x)))
    tenc = ConvEncoder()
    assert tenc.deconv2_conv is None
    tenc.load_state_dict(from_jax_variables(variables))
    assert tuple(tenc.deconv2_conv.weight.shape) == (256, 128 + 512, 3, 3)
    with torch.no_grad():
        out = tenc(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape == (2, size, size, 128)
    # float32 convolutions and group norms through 9 layers in two libraries
    np.testing.assert_allclose(out, ref, atol=2e-4, rtol=1e-4)
    assert ConvEncoder.mid_channels(128, 128) == 512
    with pytest.raises(ValueError, match="mid map"), torch.no_grad():
        tenc(torch.zeros(1, 128, 128, 3))


def test_conv_encoder_builds_for_an_image_size():
    """make_model(image_size=...) makes the size-dependent layer, drawn
    from the model's generator; without it (and without loaded weights) a
    forward raises, under autograd or not."""
    conf = small_conf(load_config)
    _edit(conf["model"], "custom")
    net = make_model(conf["model"], device="cpu", image_size=(128, 128))
    assert net.encoder.latent_size == 128
    assert tuple(net.encoder.model.deconv2_conv.weight.shape) == (256, 512 + 512, 3, 3)
    with torch.no_grad():
        assert tuple(net.encoder(torch.zeros(1, 128, 128, 3)).shape) == (1, 128, 128, 128)
    seeded = [make_model(conf["model"], device="cpu", generator=torch.Generator().manual_seed(s),
                         image_size=(H, W)).encoder.model.deconv2_conv.weight for s in (1, 1, 2)]
    assert torch.equal(seeded[0], seeded[1]) and not torch.equal(seeded[0], seeded[2])
    missing = make_model(conf["model"], device="cpu")
    assert missing.encoder.model.deconv2_conv is None
    for grad in (True, False):
        with torch.set_grad_enabled(grad), pytest.raises(ValueError, match="build_for"):
            missing.encoder(torch.zeros(1, H, W, 3))


def test_train_app_builds_the_custom_encoder_for_the_readers_images(tmp_path, monkeypatch):
    """``apps.train`` with ``backbone = custom`` makes the size-dependent
    layer from the reader's ``image_size`` and trains a step on the CPU."""
    from pixelnerf_tpu_torch.apps import train

    monkeypatch.setenv("PIXELNERF_NO_TB", "1")
    trainer = train.main([
        "-c", "conf/exp/srn.conf", "-F", "synthetic", "--epochs", "1", "--epoch_batches", "1",
        "--device", "cpu", "-B", "1", "-R", "16", "--workers", "1",
        "--checkpoints_path", str(tmp_path / "ck"), "--logs_path", str(tmp_path / "logs"),
        "--visual_path", str(tmp_path / "vis"),
        "--override", "model.encoder.backbone=custom", "--override", "model.mlp_coarse.d_hidden=32",
        "--override", "model.mlp_fine.d_hidden=32", "--override", "renderer.n_coarse=8",
        "--override", "renderer.n_fine=4", "--override", "renderer.n_fine_depth=2",
        "--override", "data.image_size=[64, 64]", "--override", "data.num_objects=1",
        "--override", "data.num_views=2",
    ])
    assert trainer.step == 1
    # a 1x1 mid map at 64x64: 128 channels before the 512-channel skip
    assert tuple(trainer.net.encoder.model.deconv2_conv.weight.shape) == (256, 128 + 512, 3, 3)


def test_custom_model_encode_and_query_match_jax():
    jnet, variables, tnet, _, _ = pair_of("custom")
    enc_j, enc_t = _encode_both(jnet, variables, tnet)
    assert tuple(enc_t.latent.shape) == (1, H, W, 128)
    np.testing.assert_allclose(enc_t.latent.numpy(), _np(enc_j.latent), atol=2e-4, rtol=1e-4)
    pts, dirs = _points()
    ref = jnet.apply(variables, enc_j, jnp.asarray(pts), jnp.asarray(dirs), method=jnet.query)
    with torch.no_grad():
        out = tnet.query(enc_t, t(pts), t(dirs))
    np.testing.assert_allclose(out.numpy(), _np(ref), atol=5e-4, rtol=1e-3)


# --- SPADE and softplus ------------------------------------------------------

@pytest.mark.parametrize("ns", [1, 2])
def test_spade_softplus_resnetfc_matches_jax(ns):
    """ResnetFC with SPADE and softplus (beta 3), one view and two through
    the mean at combine_layer 3. ``F.softplus`` is linear past 20, where
    the exact value lies within 2.1e-9 of it: below half a float32 ulp, so
    no gap to ``jax.nn.softplus`` shows."""
    jmlp = JaxResnetFC(d_in=42, d_latent=128, n_blocks=5, d_hidden=64, combine_layer=3, beta=3.0,
                       use_spade=True)
    rng = np.random.default_rng(9)
    B = 30
    z = rng.normal(size=(ns * B, 128)).astype(np.float32)
    x = 3 * rng.normal(size=(ns * B, 42)).astype(np.float32)
    variables = perturb(jax.device_get(jmlp.init(jax.random.PRNGKey(0), (jnp.asarray(z[:4]), jnp.asarray(x[:4])))), 9)
    tmlp = ResnetFC(d_in=42, d_latent=128, n_blocks=5, d_hidden=64, combine_layer=3, beta=3.0, use_spade=True)
    load_jax_variables(tmlp, variables)
    ref = jmlp.apply(variables, (jnp.asarray(z), jnp.asarray(x)), combine_inner_dims=(ns, B))
    with torch.no_grad():
        out = tmlp((t(z), t(x)), combine_inner_dims=(ns, B))
    assert tuple(out.shape) == tuple(ref.shape)
    # float32 products of width <= 128 summed in other orders
    np.testing.assert_allclose(out.numpy(), _np(ref), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("field", ["spade", "softplus", "relu"])
def test_fast_gate_routes_spade_and_softplus_to_the_chain(field, monkeypatch):
    """fast=True in bf16: a SPADE or softplus field never reaches kernel B
    (the gate is read from the config, before any launch) and equals its
    dense chain; a ReLU field without SPADE does reach it."""
    calls = []

    def spy(*args, **kwargs):
        calls.append(1)
        return fused_resnetfc_infer_plain(*args, **kwargs)

    monkeypatch.setattr(tresnetfc, "fused_resnetfc_infer", spy)
    mlp = ResnetFC(d_in=42, d_latent=128, n_blocks=5, d_hidden=64, combine_layer=3,
                   beta=3.0 if field == "softplus" else 0.0, use_spade=field == "spade", dtype=torch.bfloat16)
    g = torch.Generator().manual_seed(0)
    z, x = torch.randn((50, 128), generator=g), torch.randn((50, 42), generator=g)
    with torch.no_grad():
        fast = mlp((z, x), combine_inner_dims=(1, 50), fast=True)
        dense = mlp((z, x), combine_inner_dims=(1, 50))
    assert len(calls) == (1 if field == "relu" else 0)
    if field != "relu":
        torch.testing.assert_close(fast, dense, atol=0, rtol=0)
        with pytest.raises(ValueError, match="ReLU, no SPADE"):
            mlp((None, x), combine_inner_dims=(1, 50), fast=True,
                gather=(z.to(torch.bfloat16), torch.zeros(50, 2, dtype=torch.int32), torch.zeros(50, 2), 1))


def test_spade_softplus_bf16_model_matches_jax():
    """The whole bf16 model with SPADE, softplus and feature_scale 0.5,
    fast=True (the dense chain on both sides), against JAX."""
    conf_j, conf_t = small_conf(jax_load_config, dtype="bfloat16"), small_conf(load_config, dtype="bfloat16")
    for c in (conf_j, conf_t):
        _edit(c["model"], "spade_softplus")
        _edit(c["model"], "feature_scale")
    jnet = jax_make_model(conf_j["model"])
    images, poses = source_view()
    variables = jnet.init(jax.random.PRNGKey(0), jnp.asarray(images), jnp.asarray(poses), jnp.asarray(FOCAL),
                          jnp.zeros((1, 4, 3)), jnp.ones((1, 4, 3)))
    variables = perturb(jax.tree_util.tree_map(np.asarray, jax.device_get(variables)), 0)
    tnet = make_model(conf_t["model"], device="cpu")
    load_jax_variables(tnet, variables)
    enc_j, enc_t = _encode_both(jnet, variables, tnet)
    assert tuple(enc_t.latent.shape) == (1, 8, 8, 128) and enc_t.latent.dtype == torch.bfloat16
    pts, dirs = _points()
    ref = _np(jnet.apply(variables, enc_j, jnp.asarray(pts), jnp.asarray(dirs), fast=True, method=jnet.query))
    with torch.no_grad():
        out = tnet.query(enc_t, t(pts), t(dirs), fast=True).numpy()
    # bf16 activations (8 bits of mantissa) through 5 blocks: one rounding
    # that flips carries on; test_torch_render.py's bf16 tolerance
    np.testing.assert_allclose(out, ref, atol=5e-2)
    assert np.mean(np.abs(out - ref) < 1e-2) > 0.9


# --- ImplicitNet -------------------------------------------------------------

@pytest.mark.parametrize("ns", [1, 2])
def test_implicitnet_matches_jax(ns):
    """The skip concat at layer 2 (scaled by 1/sqrt(2)) and, with two views,
    the mean of x and x_init at combine_layer 3."""
    d_in = 170
    jmlp = JaxImplicitNet(d_in=d_in, dims=(48, 48, 48, 48), skip_in=(2,), combine_layer=3, dim_excludes_skip=True)
    rng = np.random.default_rng(11)
    B = 20
    z = rng.normal(size=(ns * B, 128)).astype(np.float32)
    x = rng.normal(size=(ns * B, 42)).astype(np.float32)
    variables = perturb(jax.device_get(jmlp.init(jax.random.PRNGKey(0), (jnp.asarray(z[:4]), jnp.asarray(x[:4])))), 11)
    tmlp = ImplicitNet(d_in=d_in, dims=(48, 48, 48, 48), skip_in=(2,), combine_layer=3, dim_excludes_skip=True)
    load_jax_variables(tmlp, variables)
    ref = jmlp.apply(variables, (jnp.asarray(z), jnp.asarray(x)), combine_inner_dims=(ns, B))
    with torch.no_grad():
        out = tmlp((t(z), t(x)), combine_inner_dims=(ns, B))
    assert tuple(out.shape) == tuple(ref.shape)
    np.testing.assert_allclose(out.numpy(), _np(ref), atol=1e-4, rtol=1e-4)


def test_implicitnet_geometric_init_matches_jax_structure():
    """Zeros, means and biases where the JAX init puts them: the position
    columns kept and the rest zeroed at layer 0 and at the skip layer, the
    output row 0 at -sqrt(pi / in_dim), its bias radius_init, the hidden
    layers at sqrt(2 / out_dim) scale."""
    d_in = 170
    kw = dict(d_in=d_in, dims=(48, 48, 48, 48), skip_in=(2,), combine_layer=3, dim_excludes_skip=True)
    jmlp = JaxImplicitNet(**kw)
    p = jax.device_get(jmlp.init(jax.random.PRNGKey(0), (jnp.zeros((2, 128)), jnp.zeros((2, 42)))))["params"]
    tmlp = ImplicitNet(**kw)
    tmlp.geometric_init_(torch.Generator().manual_seed(0))
    tw = from_jax_variables({"params": p})
    sd = tmlp.state_dict()
    assert set(sd) == set(tw)
    for layer in range(5):
        w_t, w_j = sd[f"lin{layer}.weight"], tw[f"lin{layer}.weight"]
        assert w_t.shape == w_j.shape
        zero_t, zero_j = (w_t == 0).all(dim=0), (w_j == 0).all(dim=0)
        assert torch.equal(zero_t, zero_j), layer
        torch.testing.assert_close(sd[f"lin{layer}.bias"], tw[f"lin{layer}.bias"], atol=0, rtol=0)
    assert sd["lin4.bias"][0].item() == pytest.approx(0.3)
    in_dim = tmlp.dims[4]
    for w in (sd["lin4.weight"], tw["lin4.weight"]):
        assert float(w[0].mean()) == pytest.approx(-np.sqrt(np.pi) / np.sqrt(in_dim), rel=1e-3)
    for w in (sd["lin1.weight"], tw["lin1.weight"]):
        assert float(w.std()) == pytest.approx(np.sqrt(2.0 / 48), rel=0.15)
    # layer 0 keeps its first 3 columns
    assert bool((sd["lin0.weight"][:, :3] != 0).all()) and bool((sd["lin0.weight"][:, 3:] == 0).all())


def test_bake_encoding_skips_implicitnet():
    jnet, variables, tnet, _, _ = pair_of("implicit")
    enc_j, enc_t = _encode_both(jnet, variables, tnet)
    baked_j = jax_bake_encoding(jnet, variables, enc_j)
    baked_t = bake_encoding(tnet, enc_t)
    assert baked_j.tz_coarse is None and baked_t.tz_coarse is None and baked_t.tz_fine is None
    pts, dirs = _points()
    ref = jnet.apply(variables, enc_j, jnp.asarray(pts), jnp.asarray(dirs), method=jnet.query)
    with torch.no_grad():
        out = tnet.query(baked_t, t(pts), t(dirs), fast=True)
    np.testing.assert_allclose(out.numpy(), _np(ref), atol=5e-4, rtol=1e-3)


@pytest.mark.parametrize("name", ["custom", "spade_softplus", "implicit", "quad"])
def test_staged_render_matches_jax(name):
    """The staged float32 render (the fine pass on the cached coarse
    features) of each variant on JAX's draws; the global encoder's is in
    test_global_model_encode_query_and_render_match_jax."""
    jnet, variables, tnet, jconf, tconf = pair_of(name)
    enc_j, enc_t = _encode_both(jnet, variables, tnet)
    jcfg = jr.RenderConfig.from_conf(jconf["renderer"])
    tcfg = tr.RenderConfig.from_conf(tconf["renderer"])
    rays = novel_rays()[:, :32]
    key = jax.random.PRNGKey(9)
    ref = jr.render_rays(
        (lambda x, v: jnet.apply(variables, enc_j, x, viewdirs=v, method=jnet.query_features),
         lambda f, c: jnet.apply(variables, enc_j, f, coarse=c, method=jnet.query_mlp)),
        jnp.asarray(rays), key, jcfg)
    with torch.no_grad():
        out = tr.render_rays((lambda x, v: tnet.query_features(enc_t, x, v),
                              lambda f, c: tnet.query_mlp(enc_t, f, c)),
                             t(rays), tcfg, noise=jax_draws(key, 1, rays.shape[1], jcfg))
    # the encoder's ~1e-4 through the MLP and the compositing
    # (tests/test_torch_render.py's tolerance)
    for branch in ("coarse", "fine"):
        for k in ("rgb", "depth"):
            np.testing.assert_allclose(out[branch][k].numpy(), _np(ref[branch][k]), atol=5e-4,
                                       err_msg=f"{branch}/{k}")
    assert max(float(np.std(_np(ref[b]["rgb"]))) for b in ("coarse", "fine")) > 1e-3


# --- a train step of each variant ---------------------------------------------

def _train_batch(size):
    """tests/test_torch_train.py's batch with source images of ``size`` px
    (the global encoder's layer4 is 1x1 at 32 px, where batch statistics
    over two images are ill-conditioned; at 64 px it is 2x2)."""
    batch = _batch()
    if size != H:
        rng = np.random.default_rng(5)
        batch["images"] = rng.uniform(-1, 1, (SB, 1, size, size, 3)).astype(np.float32)
        batch["c"] = np.full((SB, 2), size / 2.0, np.float32)
    return batch


def _jax_step(jnet, variables, jconf, key, batch):
    """One JAX train step, unchunked; as tests/test_torch_train.py's
    ``_jax_run`` (which it cannot use: a model without batch norms has no
    ``batch_stats``)."""
    from test_torch_train import _capture_grads

    cfg = dataclasses.replace(jr.RenderConfig.from_conf(jconf["renderer"]), noise_std=NOISE_STD)
    opt = optax.chain(_capture_grads(), optax.adam(LR))
    step = jax_make_train_step(jnet, cfg, opt, jax_make_loss(jconf["loss"]))
    # the JAX step reads a model without batch norms wrongly: it then applies
    # encode with mutable=[], which flax answers with an (output, {}) tuple
    # that the step takes for the encoding (ROADMAP.md, section C). A
    # collection the model does not read sidesteps it.
    stats = variables.get("batch_stats") or {"unused": np.zeros(1, np.float32)}
    state = TrainState(
        params=variables["params"], batch_stats=stats,
        opt_state=opt.init(variables["params"]), step=jnp.zeros((), jnp.int32),
    )
    state, metrics = step(state, {k: jnp.asarray(v) for k, v in batch.items()}, key)
    if "unused" in stats:
        state = state.replace(batch_stats={})
    return cfg, jax.device_get(state), {k: float(v) for k, v in metrics.items()}


@pytest.mark.parametrize("name", ["global", "custom", "spade_softplus", "implicit", "quad"])
def test_train_step_matches_jax(name):
    """Loss, metrics, every gradient, updated running statistics (both
    trunks' with the global encoder) and post-Adam parameters against the
    JAX step, at tests/test_torch_train.py's ``_compare_step`` tolerance.
    The gather goes through kernel C's and C-bwd's plain versions, the
    quad gather through torch's indexing."""
    jnet, variables, _, jconf, tconf = pair_of(name)
    tnet = make_model(tconf["model"], device="cpu")
    load_jax_variables(tnet, variables)
    key = jax.random.PRNGKey(21)
    batch = _train_batch(64 if name == "global" else H)
    jcfg, jstate, jmetrics = _jax_step(jnet, variables, jconf, key, batch)
    opt = torch.optim.Adam(tnet.parameters(), lr=LR, betas=(0.9, 0.999), eps=1e-8)
    step = make_train_step(tnet, _port_cfg(jcfg), opt, make_render_loss(tconf["loss"]), remat=False)
    metrics = step({k: t(v) for k, v in batch.items()}, noise=jax_chunk_draws(key, SB, R, jcfg))
    _compare_step(tnet, metrics, jstate, jmetrics, jstate.opt_state[0])
    if name == "global":
        assert any(k.startswith("global_encoder.model.layer4") and k.endswith("running_var")
                   for k in from_jax_variables({"batch_stats": jstate.batch_stats}))


# --- the weight bridge ---------------------------------------------------------

@pytest.mark.parametrize("name", ["global", "custom", "spade_softplus", "implicit"])
def test_weight_bridge_matches_torch_import(name):
    """Every new layer through from_jax_variables (keys and shapes as the
    JAX export_state_dict names them); the port's export_state_dict equal
    to the JAX one bit for bit; load_reference_state_dict of the JAX export
    into a fresh port model, and the JAX import_state_dict of the port's
    export, both back to the same weights."""
    jnet, variables, tnet, _, tconf = pair_of(name)
    ref = jax_export_state_dict(variables)
    ours = export_state_dict(tnet.state_dict())
    assert set(ours) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(v, np.float32), err_msg=k)
    new = {"global": "global_encoder.fc.weight", "custom": "encoder.model.deconv2_conv.weight",
           "spade_softplus": "mlp_fine.scale_z.2.weight", "implicit": "mlp_coarse.lin4.weight"}[name]
    assert new in ours
    fresh = make_model(tconf["model"], device="cpu", generator=torch.Generator().manual_seed(5))
    load_reference_state_dict(fresh, {k: torch.from_numpy(np.asarray(v)) for k, v in ref.items()})
    sd = fresh.state_dict()
    for k, v in ours.items():
        torch.testing.assert_close(sd[k], v, atol=0, rtol=0)
    back = jax_import_state_dict({k: v.numpy() for k, v in ours.items()})
    flat_back = from_jax_variables(back)
    flat_ref = from_jax_variables(variables)
    assert set(flat_back) == set(flat_ref)
    for k, v in flat_ref.items():
        torch.testing.assert_close(flat_back[k], v, atol=0, rtol=0)


def test_global_encoder_staged_remat_features_matches_remat_false():
    """The staged render's feature cache holds [global | gathered] rows;
    under remat="features" (chunked, the MLPs recomputed) the step equals
    the unrecomputed one, and the gradient reaches the global encoder
    through the concat."""
    _, variables, _, _, tconf = pair_of("global")
    batch = {k: t(v) for k, v in _train_batch(64).items()}
    jcfg = dataclasses.replace(jr.RenderConfig.from_conf(small_conf(jax_load_config)["renderer"]),
                               noise_std=NOISE_STD)
    noise = jax_chunk_draws(jax.random.PRNGKey(3), SB, R, jcfg, ray_chunk=16)
    runs = {}
    for remat in (False, "features"):
        net = make_model(tconf["model"], device="cpu")
        load_jax_variables(net, variables)
        opt = torch.optim.Adam(net.parameters(), lr=LR)
        step = make_train_step(net, _port_cfg(jcfg), opt, make_render_loss(tconf["loss"]), ray_chunk=16,
                               remat=remat)
        metrics = step(batch, noise=noise)
        runs[remat] = (metrics, {k: p.grad.clone() for k, p in net.named_parameters()})
    (m0, g0), (m1, g1) = runs[False], runs["features"]
    # the recompute runs the same float32 ops on the same inputs
    for k in ("rc", "rf", "t"):
        torch.testing.assert_close(m1[k], m0[k], atol=0, rtol=1e-6)
    for k, g in g0.items():
        torch.testing.assert_close(g1[k], g, atol=1e-7, rtol=1e-5, msg=k)
    assert float(g0["global_encoder.fc.weight"].abs().max()) > 1e-4
    assert float(g0["global_encoder.model.conv1.weight"].abs().max()) > 1e-6
