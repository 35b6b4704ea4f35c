"""The port's models against the JAX package's on the CPU, on the same
(perturbed) weights carried over by the weight bridge: geometry, the
positional code, the encoder, ResnetFC (dense chain and the fused kernel's
plain version), the query stages, the bridge's names, and the port's
isolation from JAX."""
import ast
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixelnerf_tpu.config import load_config as jax_load_config
from pixelnerf_tpu.models import make_model as jax_make_model
from pixelnerf_tpu.models.code import PositionalEncoding as JaxPE
from pixelnerf_tpu.models.resnetfc import _kernel_params_sub
from pixelnerf_tpu.models.torch_import import export_state_dict
from pixelnerf_tpu.ops.fused_mlp import pack_weights as jax_pack_weights
from pixelnerf_tpu.utils import geometry as jgeo
from pixelnerf_tpu_torch.config import load_config
from pixelnerf_tpu_torch.models import ResnetFC, from_jax_variables, load_jax_variables
from pixelnerf_tpu_torch.models.code import PositionalEncoding
from pixelnerf_tpu_torch.ops.fused_mlp import fused_resnetfc_infer_plain, pack_weights
from pixelnerf_tpu_torch.utils import geometry as tgeo

from torch_port_utils import FOCAL, REPO, SRN_CONF, build_pair, mlp_pair as _mlp_pair, novel_rays, source_view, t


def _np(x):
    return np.asarray(x, np.float32)


def test_config_copy_loads_srn_like_jax():
    assert load_config(SRN_CONF) == jax_load_config(SRN_CONF)


def test_geometry_matches_jax():
    pose = jgeo.look_at(np.array([0.5, 0.2, 1.5], np.float32), np.zeros(3))
    np.testing.assert_array_equal(tgeo.look_at([0.5, 0.2, 1.5], np.zeros(3)), pose)
    np.testing.assert_array_equal(tgeo.pose_spherical(30.0, -20.0, 1.3), jgeo.pose_spherical(30.0, -20.0, 1.3))
    poses = np.stack([pose, jgeo.pose_spherical(10.0, -30.0, 2.0)])
    ref = jgeo.gen_rays(jnp.asarray(poses), 6, 5, 7.0, 0.8, 1.8)
    out = tgeo.gen_rays(poses, 6, 5, 7.0, 0.8, 1.8, device="cpu")
    np.testing.assert_allclose(out.numpy(), _np(ref), atol=1e-6)
    np.testing.assert_allclose(
        tgeo.invert_pose(torch.from_numpy(poses)).numpy(), _np(jgeo.invert_pose(jnp.asarray(poses))), atol=1e-6
    )
    x = np.random.default_rng(0).normal(size=(20, 3)).astype(np.float32)
    for agg in ("average", "max"):
        np.testing.assert_allclose(
            tgeo.combine_interleaved(torch.from_numpy(x), (2, 5), agg).numpy(),
            _np(jgeo.combine_interleaved(jnp.asarray(x), (2, 5), agg)), atol=1e-6,
        )
    np.testing.assert_array_equal(
        tgeo.repeat_interleave(torch.from_numpy(x), 3).numpy(), _np(jgeo.repeat_interleave(jnp.asarray(x), 3))
    )


def test_positional_encoding_matches_jax():
    x = np.random.default_rng(1).normal(size=(4, 7, 3)).astype(np.float32)
    ref = JaxPE(num_freqs=6, d_in=3, freq_factor=1.5)(jnp.asarray(x))
    out = PositionalEncoding(num_freqs=6, d_in=3, freq_factor=1.5)(torch.from_numpy(x))
    assert out.shape == (4, 7, 39)
    # sin of arguments up to ~1.5*32*3: float32 argument rounding ~1e-5
    np.testing.assert_allclose(out.numpy(), _np(ref), atol=2e-5)


@pytest.fixture(scope="module")
def pair():
    return build_pair()


def test_encoder_matches_jax_f32(pair):
    jnet, variables, tnet, _, _ = pair
    images, poses = source_view()
    ref = jnet.apply(variables, jnp.asarray(images), jnp.asarray(poses), jnp.asarray(FOCAL), method=jnet.encode)
    with torch.no_grad():
        enc = tnet.encode(t(images), t(poses), FOCAL)
    assert enc.latent.shape == ref.latent.shape == (1, 16, 16, 128)
    # float32 convolutions through 7 layers in two libraries: sums in other
    # orders, ~1e-6 relative per layer on activations of order 1
    np.testing.assert_allclose(enc.latent.numpy(), _np(ref.latent), atol=1e-4)
    np.testing.assert_allclose(enc.poses.numpy(), _np(ref.poses), atol=1e-6)
    np.testing.assert_allclose(enc.focal.numpy(), _np(ref.focal))
    np.testing.assert_allclose(enc.c.numpy(), _np(ref.c))


@pytest.mark.parametrize("ns", [1, 2])
def test_resnetfc_f32_matches_jax(ns):
    """NS=1, and NS=2 through the mean at combine_layer 3."""
    jmlp, variables, tmlp = _mlp_pair()
    rng = np.random.default_rng(5)
    B = 30
    z = rng.normal(size=(ns * B, 128)).astype(np.float32)
    x = rng.normal(size=(ns * B, 42)).astype(np.float32)
    ref = jmlp.apply(variables, (jnp.asarray(z), jnp.asarray(x)), combine_inner_dims=(ns, B))
    with torch.no_grad():
        out = tmlp((t(z), t(x)), combine_inner_dims=(ns, B))
    assert tuple(out.shape) == tuple(ref.shape)
    # float32 products of width <= 128 summed in other orders
    np.testing.assert_allclose(out.numpy(), _np(ref), atol=1e-4, rtol=1e-4)


def test_pack_weights_matches_jax():
    jmlp, variables, tmlp = _mlp_pair("bfloat16")
    p = variables["params"]
    sub = _kernel_params_sub({
        "lin_in": (p["lin_in"]["kernel"], p["lin_in"]["bias"]),
        "lin_z": [(p[f"lin_z_{i}"]["kernel"], p[f"lin_z_{i}"]["bias"]) for i in range(3)],
        "blocks": [tuple(p[f"block{i}"][f][k] for f in ("fc_0", "fc_1") for k in ("kernel", "bias"))
                   for i in range(5)],
        "lin_out": (p["lin_out"]["kernel"], p["lin_out"]["bias"]),
    })
    ref = jax_pack_weights(sub, 5, 3, 128, 42, 64)
    out = pack_weights(tmlp)
    names = ("win", "bin", "wz", "bz", "w0", "b0", "w1", "b1", "wout", "bout")
    for name, r, o in zip(names, ref, out):
        r = _np(r)
        o = o.float().numpy()
        # matrices are the transposes (torch's (out, in) layout), biases 1-D
        o = o.swapaxes(-1, -2) if name.startswith("w") else o.reshape(r.shape)
        np.testing.assert_array_equal(o, r, err_msg=name)
    # the z_is_tz variant's tuple: the same arrays, wz and bz left out
    # (the JAX side ships zero dummies in their place)
    tz_tuple = pack_weights(tmlp, with_wz=False)
    assert tz_tuple[2] is None and tz_tuple[3] is None
    for name, a, b in zip(names, out, tz_tuple):
        if name not in ("wz", "bz"):
            assert torch.equal(a, b), name


def test_fused_plain_matches_jax_fast_bf16():
    """Kernel B's plain version (through ResnetFC(fast=True) on the CPU)
    against JAX ResnetFC(fast=True) at bf16, which runs the Pallas kernel
    in interpret mode off the TPU."""
    jmlp, variables, tmlp = _mlp_pair("bfloat16", d_hidden=128, d_latent=512)
    rng = np.random.default_rng(6)
    z = rng.normal(size=(300, 512)).astype(np.float32)
    x = rng.normal(size=(300, 42)).astype(np.float32)
    ref = _np(jmlp.apply(variables, (jnp.asarray(z), jnp.asarray(x)), combine_inner_dims=(1, 300), fast=True))
    with torch.no_grad():
        out = tmlp((t(z), t(x)), combine_inner_dims=(1, 300), fast=True).numpy()
    assert out.shape == ref.shape
    # tests/test_fused_mlp.py's tolerance: both round every layer to bf16,
    # and sums in another order can flip one rounding, which the later
    # layers carry; most entries agree far closer
    np.testing.assert_allclose(out, ref, atol=5e-2, rtol=5e-2)
    assert np.mean(np.abs(out - ref) < 1e-2) > 0.95


def test_fused_plain_matches_dense_chain_bf16():
    """The kernel's plain version and the bf16 dense chain compute one
    function (the dense chain is what runs outside the kernel's gate)."""
    _, _, tmlp = _mlp_pair("bfloat16")
    g = torch.Generator().manual_seed(0)
    z = torch.randn((200, 128), generator=g)
    x = torch.randn((200, 42), generator=g)
    with torch.no_grad():
        dense = tmlp((z, x), combine_inner_dims=(1, 200))
        plain = fused_resnetfc_infer_plain(
            z.to(torch.bfloat16), x.to(torch.bfloat16), pack_weights(tmlp), 5, 3
        ).reshape(dense.shape)
    # same bf16 rounding points; products accumulated in other orders
    np.testing.assert_allclose(plain.numpy(), dense.numpy(), atol=5e-2, rtol=5e-2)


def test_query_stages_match_jax(pair):
    jnet, variables, tnet, _, _ = pair
    images, poses = source_view()
    enc_j = jnet.apply(variables, jnp.asarray(images), jnp.asarray(poses), jnp.asarray(FOCAL), method=jnet.encode)
    rays = novel_rays()[:, :20]
    z = np.linspace(0.9, 1.7, 5, dtype=np.float32)
    pts = (rays[..., None, :3] + z[:, None] * rays[..., None, 3:6]).reshape(1, -1, 3)
    dirs = np.broadcast_to(rays[..., None, 3:6], (1, 20, 5, 3)).reshape(1, -1, 3)
    feats_j = jnet.apply(variables, enc_j, jnp.asarray(pts), jnp.asarray(dirs), method=jnet.query_features)
    with torch.no_grad():
        enc_t = tnet.encode(t(images), t(poses), FOCAL)
        feats_t = tnet.query_features(enc_t, t(pts), t(dirs))
        for coarse in (True, False):
            out_j = jnet.apply(variables, enc_j, feats_j, coarse=coarse, method=jnet.query_mlp)
            out_t = tnet.query_mlp(enc_t, feats_t, coarse=coarse)
            # the encoder's 1e-4 carried through a 5-block MLP
            np.testing.assert_allclose(out_t.numpy(), _np(out_j), atol=5e-4, rtol=1e-3)
    np.testing.assert_allclose(feats_t[1].numpy(), _np(feats_j[1]), atol=2e-5)
    np.testing.assert_allclose(feats_t[0].numpy(), _np(feats_j[0]), atol=1e-4)
    assert float(np.std(out_t.numpy()[..., :3])) > 1e-3


def test_weight_bridge_matches_export_state_dict_srn():
    """Names and shapes of the bridge's state_dict equal the JAX package's
    export_state_dict on the full SRN tree, and load into the port's SRN
    model with nothing missing or left over."""
    jconf = jax_load_config(SRN_CONF)
    jnet = jax_make_model(jconf["model"])
    images, poses = source_view()
    shapes = jax.eval_shape(
        jnet.init, jax.random.PRNGKey(0), jnp.asarray(images), jnp.asarray(poses),
        jnp.asarray(FOCAL), jnp.zeros((1, 4, 3)), jnp.ones((1, 4, 3)),
    )
    variables = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    ref = export_state_dict(variables)
    sd = from_jax_variables(variables)
    assert set(sd) == set(ref)
    for k in ref:
        assert tuple(sd[k].shape) == tuple(ref[k].shape), k
    from pixelnerf_tpu_torch.models import make_model

    tnet = make_model(load_config(SRN_CONF)["model"], device="cpu")
    own = {k: tuple(v.shape) for k, v in tnet.state_dict().items() if not k.endswith("num_batches_tracked")}
    assert own == {k: tuple(v.shape) for k, v in sd.items()}


FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "pixelnerf_tpu"}
# the JAX side's user tools that have a counterpart scripts/<name>_torch.py
TOOLS = ("make_multi_obj_dataset", "render_shapenet_objs", "make_real_layout_fixtures", "make_real_input",
         "snapshot_watcher", "quality_curve", "export_demo_checkpoint")


def _imported_roots(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) in (
            "import_module", "__import__"
        ) and node.args and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


def test_port_imports_nothing_of_jax():
    """Every module of the port, chip_smoke.py and the port's profiling
    and gather-study scripts: no import of jax, flax,
    optax or the top-level package pixelnerf_tpu (matched by exact name:
    pixelnerf_tpu_torch shares its prefix). The port's user tools, which
    run where the card is, import no imaging library either (imageio, cv2,
    PIL) and none of the JAX side's scripts."""
    files = [os.path.join(REPO, "chip_smoke.py")] + [
        os.path.join(REPO, "scripts", f"{name}.py")
        for name in ("profile_torch_render", "profile_torch_train", "bench_gather_torch",
                     "probe_gather_kernels_torch", "stress_fused_mlp_torch", "bench_gather_rows_bwd_torch",
                     "bench_gather_a_torch")
    ]
    for root, _, names in os.walk(os.path.join(REPO, "pixelnerf_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 15
    bad = {(os.path.relpath(f, REPO), m) for f in files for m in _imported_roots(f) if m in FORBIDDEN}
    assert not bad, bad
    tools = [os.path.join(REPO, "scripts", f"{name}_torch.py") for name in TOOLS]
    jax_scripts = {n[:-3] for n in os.listdir(os.path.join(REPO, "scripts"))
                   if n.endswith(".py") and not n.endswith("_torch.py")}
    assert all(name in jax_scripts for name in TOOLS)
    forbidden = FORBIDDEN | {"imageio", "cv2", "PIL", "scripts"} | jax_scripts
    bad = {(os.path.relpath(f, REPO), m) for f in tools for m in _imported_roots(f) if m in forbidden}
    assert not bad, bad
    # the lazy-export table names modules as strings
    import pixelnerf_tpu_torch

    assert all(mod.split(".")[0] == "pixelnerf_tpu_torch" for mod, _ in pixelnerf_tpu_torch._LAZY.values())
