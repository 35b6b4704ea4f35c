"""The port's training path against the JAX package's on the CPU: kernel
C's plain version against the Pallas kernel in interpret mode, the
differentiable latent lookup against ``jax.vjp``, train-mode batch norm
against flax, and whole training steps (loss, metrics, every gradient,
updated running statistics, post-Adam parameters) against the JAX
``make_train_step`` on the same weights, batch and random draws, in float32.
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pixelnerf_tpu.models.encoder import index_latent as jax_index_latent
from pixelnerf_tpu.models.resnet import ResNetFeatures as JaxResNetFeatures
from pixelnerf_tpu.ops.gather_pallas import bilinear_corners as jax_corners
from pixelnerf_tpu.ops.gather_pallas import gather_rows_lerp as pallas_gather_rows
from pixelnerf_tpu.render import renderer as jr
from pixelnerf_tpu.train import TrainState, make_render_loss as jax_make_loss
from pixelnerf_tpu.train import make_train_step as jax_make_train_step
from pixelnerf_tpu_torch.models import ResnetFC, from_jax_opt_state, from_jax_variables, load_jax_variables
from pixelnerf_tpu_torch.models.encoder import index_latent
from pixelnerf_tpu_torch.models.resnet import ResNetFeatures
from pixelnerf_tpu_torch.ops import grid_sample as tgs
from pixelnerf_tpu_torch.ops.gather_rows import (
    GatherRowsLerp,
    gather_rows_lerp,
    gather_rows_lerp_bwd,
    gather_rows_lerp_plain,
)
from pixelnerf_tpu_torch.render import renderer as tr
from pixelnerf_tpu_torch.train import make_render_loss, make_train_step

from torch_port_utils import FOCAL, W, build_pair, jax_chunk_draws, novel_rays, perturb, source_view, t

jgs = importlib.import_module("pixelnerf_tpu.ops.grid_sample")


def _np(x):
    return np.asarray(x, np.float32)


def _corner_inputs(hh=12, ww=10, c=32, p=400, seed=0):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(hh, ww, c)).astype(np.float32)
    grid = rng.uniform(-1.2, 1.2, (p, 2)).astype(np.float32)
    return feats, grid


def test_bilinear_corners_matches_jax():
    feats, grid = _corner_inputs()
    hh, ww = feats.shape[:2]
    jix = jgs._compute_source_index(jnp.asarray(grid[:, 0]), ww, "border", True)
    jiy = jgs._compute_source_index(jnp.asarray(grid[:, 1]), hh, "border", True)
    ji, jw = jax_corners(jix, jiy, hh, ww)
    tix = tgs._compute_source_index(torch.from_numpy(grid[:, 0]), ww, "border", True)
    tiy = tgs._compute_source_index(torch.from_numpy(grid[:, 1]), hh, "border", True)
    ti, tw = tgs.bilinear_corners(tix, tiy, hh, ww)
    assert ti.dtype == torch.int32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tw.numpy(), _np(jw), atol=1e-7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_rows_plain_matches_pallas_interpret(dtype):
    """Kernel C's plain version (and its CPU wrapper, which launches
    nothing) against gather_rows_lerp in interpret mode: the same rows,
    the same float32 sum order."""
    feats, grid = _corner_inputs()
    hh, ww, c = feats.shape
    ix = jgs._compute_source_index(jnp.asarray(grid[:, 0]), ww, "border", True)
    iy = jgs._compute_source_index(jnp.asarray(grid[:, 1]), hh, "border", True)
    idx, w = jax_corners(ix, iy, hh, ww)
    table = jnp.asarray(feats).reshape(hh * ww, c).astype(dtype)
    ref = pallas_gather_rows(table, idx, w, out_dtype=jnp.float32, interpret=True)
    ttable = torch.from_numpy(feats).reshape(hh * ww, c).to(getattr(torch, dtype))
    tidx, tw = torch.from_numpy(np.array(idx)), torch.from_numpy(np.array(w))
    out = gather_rows_lerp_plain(ttable, tidx, tw)
    np.testing.assert_allclose(out.numpy(), _np(ref), atol=1e-6)
    before = (gather_rows_lerp.launches, gather_rows_lerp_bwd.launches)
    np.testing.assert_array_equal(gather_rows_lerp(ttable, tidx, tw).numpy(), out.numpy())
    assert (gather_rows_lerp.launches, gather_rows_lerp_bwd.launches) == before


@pytest.mark.parametrize("ns", [1, 2])
def test_index_latent_differentiable_matches_jax_vjp(ns):
    """Value and VJP in the latent and in uv, against jax.vjp of the JAX
    index_latent (XLA's four gathers and lerp, whose transpose is the
    scatter-add). A third of the points lie beyond the border, where the
    clamp zeroes the uv gradient, and four exactly on it."""
    rng = np.random.default_rng(ns)
    hl, wl, c = 6, 7, 16
    latent = rng.normal(size=(ns, hl, wl, c)).astype(np.float32)
    image_shape = np.array([28.0, 24.0], np.float32)   # [W, H]
    uv = rng.uniform(-6, 34, (ns, 60, 2)).astype(np.float32)
    uv[:, :4] = 0.0          # exactly on the border: jnp.clip passes half the gradient
    ct = rng.normal(size=(ns, 60, c)).astype(np.float32)
    ref, vjp = jax.vjp(
        lambda lat, p: jax_index_latent(lat, p, jnp.asarray(image_shape)),
        jnp.asarray(latent), jnp.asarray(uv),
    )
    g_lat, g_uv = vjp(jnp.asarray(ct))
    lat_t = torch.from_numpy(latent).requires_grad_()
    uv_t = torch.from_numpy(uv).requires_grad_()
    out = index_latent(lat_t, uv_t, torch.from_numpy(image_shape), differentiable=True)
    out.backward(torch.from_numpy(ct))
    np.testing.assert_allclose(out.detach().numpy(), _np(ref), atol=1e-5)
    np.testing.assert_allclose(lat_t.grad.numpy(), _np(g_lat), atol=1e-5)
    np.testing.assert_allclose(uv_t.grad.numpy(), _np(g_uv), atol=1e-5)
    outside = (uv < 0) | (uv > image_shape - 1)
    assert outside.any(axis=-1).mean() > 0.2
    assert np.all(uv_t.grad.numpy()[outside] == 0)
    assert np.abs(_np(g_uv)).max() > 1e-2          # the uv term is really there


def test_resnet_train_batch_norm_matches_flax():
    """Train-mode ResNetFeatures: maps and updated running statistics
    against flax apply(train=True, mutable=['batch_stats']). After the stem
    pool layer1's maps are 4x4 per image, 32 entries per channel, so torch's
    unbiased running_var would be off by 32/31 in its batch part. (At 2x2
    entries E[x^2] - E[x]^2 cancels in float32 and the two libraries'
    rounding, not their semantics, decides the maps.)"""
    jm = JaxResNetFeatures(backbone="resnet34", num_layers=3)
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    variables = perturb(jax.tree_util.tree_map(np.asarray, jax.device_get(variables)))
    ref, mutated = jm.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    tm = ResNetFeatures("resnet34", 3)
    res = tm.load_state_dict(from_jax_variables(variables), strict=False)
    assert not res.unexpected_keys
    assert all(k.endswith("num_batches_tracked") for k in res.missing_keys)
    out = tm(torch.from_numpy(x), train=True)
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.detach().numpy(), _np(b), atol=1e-4)
    new = from_jax_variables({"batch_stats": jax.device_get(mutated["batch_stats"])})
    old = from_jax_variables(variables)
    sd = tm.state_dict()
    for k, v in new.items():
        np.testing.assert_allclose(sd[k].numpy(), v.numpy(), atol=1e-6, rtol=1e-5, err_msg=k)
    # the batch part of a layer1 update is large enough for 32/31 to show
    k = "layer1.0.bn1.running_var"
    batch_part = new[k].numpy() - 0.9 * old[k].numpy()
    assert np.median(batch_part / 31 / (1e-6 + 1e-5 * np.abs(new[k].numpy()))) > 10


# --- whole training steps ----------------------------------------------------

SB, R, CHUNK, LR = 2, 32, 16, 1e-3
NOISE_STD = 0.5


def _capture_grads():
    """An optax transformation that keeps the raw gradients in its state."""

    def init(params):
        return jax.tree_util.tree_map(jnp.zeros_like, params)

    def update(updates, state, params=None):
        return updates, updates

    return optax.GradientTransformation(init, update)


def _batch():
    rng = np.random.default_rng(4)
    images, poses = source_view(SB)
    rays = novel_rays().reshape(SB, R, 8)                # an 8x8 view, half per object
    return {
        "images": images, "poses": poses,
        "focal": np.full((SB,), FOCAL, np.float32),
        "c": np.full((SB, 2), W / 2.0, np.float32),
        "rays": np.ascontiguousarray(rays),
        "rgb_gt": rng.uniform(0, 1, (SB, R, 3)).astype(np.float32),
    }


def _jax_run(jnet, variables, jconf, ray_chunk, keys):
    """JAX train steps from ``variables`` (one per key). Returns the state
    and gradients after each step, and the metrics."""
    cfg = dataclasses.replace(jr.RenderConfig.from_conf(jconf["renderer"]), noise_std=NOISE_STD)
    opt = optax.chain(_capture_grads(), optax.adam(LR))
    step = jax_make_train_step(jnet, cfg, opt, jax_make_loss(jconf["loss"]), ray_chunk=ray_chunk, remat=False)
    state = TrainState(
        params=variables["params"], batch_stats=variables["batch_stats"],
        opt_state=opt.init(variables["params"]), step=jnp.zeros((), jnp.int32),
    )
    batch = {k: jnp.asarray(v) for k, v in _batch().items()}
    runs = []
    for key in keys:
        state, metrics = step(state, batch, key)
        runs.append((jax.device_get(state), {k: float(v) for k, v in metrics.items()}))
    return cfg, runs


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX reference, once per chunking: unchunked (R <= ray_chunk) and
    chunked in two (every remat policy gives JAX the same values;
    tests/test_train.py)."""
    jnet, variables, tnet, jconf, tconf = build_pair(SB=SB)
    keys = [jax.random.PRNGKey(21), jax.random.PRNGKey(22)]
    out = {"pair": (variables, tconf), "keys": keys}
    for chunk in (None, CHUNK):
        out[chunk] = _jax_run(jnet, variables, jconf, chunk, keys)
    return out


def _port_cfg(jcfg):
    return tr.RenderConfig(
        n_coarse=jcfg.n_coarse, n_fine=jcfg.n_fine, n_fine_depth=jcfg.n_fine_depth,
        noise_std=jcfg.noise_std, depth_std=jcfg.depth_std, white_bkgd=jcfg.white_bkgd,
    )


def _port(variables, tconf, opt_state=None):
    from pixelnerf_tpu_torch.models import make_model

    net = make_model(tconf["model"], device="cpu")
    load_jax_variables(net, variables)
    opt = torch.optim.Adam(net.parameters(), lr=LR, betas=(0.9, 0.999), eps=1e-8)
    if opt_state is not None:
        opt.load_state_dict(from_jax_opt_state(opt_state, net, opt))
    return net, opt


def _compare_step(net, metrics, jstate, jmetrics, grads_ref):
    """Loss, metrics, every gradient, post-Adam parameters and running
    statistics of one port step against the JAX step's."""
    for k in ("rc", "rf", "t", "gnorm"):
        np.testing.assert_allclose(float(metrics[k]), jmetrics[k], rtol=1e-4, err_msg=k)
    named = dict(net.named_parameters())
    grads = from_jax_variables({"params": grads_ref})
    assert set(grads) == set(named)
    # float32 in two libraries: most gradients agree to ~1e-5 of their
    # tensor's largest entry, but a ReLU unit whose input lies within
    # rounding of 0 at one sample can take the other branch in one of them;
    # that moves the unit's row, and downstream every encoder gradient, by
    # up to ~0.5% of the largest entry (chunked steps at these draws)
    num = den = 0.0
    for k, g in grads.items():
        err = (named[k].grad - g).abs()
        scale = max(float(g.abs().max()), 1e-12)
        assert float(err.max()) <= 1e-2 * scale, (k, float(err.max()) / scale)
        num += float(err.square().sum())
        den += float(g.square().sum())
    assert np.sqrt(num / den) < 2e-3
    ref = from_jax_variables({"params": jstate.params, "batch_stats": jstate.batch_stats})
    sd = net.state_dict()
    for k, v in ref.items():
        if k not in grads:                      # running statistics
            np.testing.assert_allclose(sd[k].numpy(), v.numpy(), atol=1e-5, rtol=1e-5, err_msg=k)
            continue
        # Adam's first moves are ~lr * sign(g): equal wherever the sign is
        # clear of the gradients' tolerance, at most 2 lr apart elsewhere
        g = grads[k]
        clear = g.abs() > 2e-2 * g.abs().max()
        d = (sd[k] - v).abs()
        assert float(torch.where(clear, d, torch.zeros(())).max()) <= 1e-6, k
        assert float(d.max()) <= 2 * LR + 1e-6, k
    encoder_grads = [g for k, g in grads.items() if k.startswith("encoder.")]
    assert max(float(g.abs().max()) for g in encoder_grads) > 1e-4   # the gather's backward reached them


@pytest.mark.parametrize("remat", ["unchunked", False, True, "features"])
def test_train_step_matches_jax(jax_runs, remat):
    variables, tconf = jax_runs["pair"]
    chunk = None if remat == "unchunked" else CHUNK
    jcfg, runs = jax_runs[chunk]
    jstate, jmetrics = runs[0]
    net, opt = _port(variables, tconf)
    cfg = _port_cfg(jcfg)
    step = make_train_step(
        net, cfg, opt, make_render_loss(tconf["loss"]), ray_chunk=chunk,
        remat=False if remat == "unchunked" else remat,
    )
    batch = {k: t(v) for k, v in _batch().items()}
    noise = jax_chunk_draws(jax_runs["keys"][0], SB, R, jcfg, chunk)
    assert len(noise) == (1 if chunk is None else 2) and "noise_f" in noise[0]
    with torch.no_grad():
        # non-degeneracy: a near-constant render would certify nothing
        enc = net.encode(batch["images"], batch["poses"], batch["focal"], batch["c"])
        out = tr.render_rays((lambda p, v: net.query_features(enc, p, v),
                              lambda f, c: net.query_mlp(enc, f, c)),
                             batch["rays"][:, : noise[0]["coarse"].shape[1]], cfg, noise=noise[0])
        assert float(out["fine"]["rgb"].std()) > 1e-3
    metrics = step(batch, noise=noise)
    _compare_step(net, metrics, jstate, jmetrics, jstate.opt_state[0])


def test_second_step_after_from_jax_opt_state(jax_runs):
    """The JAX state after one step (params, running statistics, Adam's
    mu/nu/count) carried into the port, then one more step on each side."""
    variables, tconf = jax_runs["pair"]
    jcfg, runs = jax_runs[CHUNK]
    state1 = runs[0][0]
    net, opt = _port(
        {"params": state1.params, "batch_stats": state1.batch_stats}, tconf,
        state1.opt_state[1][0],                 # optax.adam's ScaleByAdamState
    )
    assert all(int(opt.state[p]["step"]) == 1 for p in net.parameters())
    step = make_train_step(net, _port_cfg(jcfg), opt, make_render_loss(tconf["loss"]),
                           ray_chunk=CHUNK, remat="features")
    metrics = step({k: t(v) for k, v in _batch().items()},
                   noise=jax_chunk_draws(jax_runs["keys"][1], SB, R, jcfg, CHUNK))
    jstate, jmetrics = runs[1]
    _compare_step(net, metrics, jstate, jmetrics, jstate.opt_state[0])


def test_fast_mlp_refuses_autograd():
    """Kernel B has no backward: ResnetFC(fast=True) raises where autograd
    would record it, and runs under no_grad."""
    mlp = ResnetFC(d_in=42, d_latent=64, d_hidden=32, n_blocks=2, combine_layer=1, dtype=torch.bfloat16)
    z = torch.zeros((1, 5, 64))
    x = torch.zeros((1, 5, 42))
    with pytest.raises(RuntimeError, match="inference-only"):
        mlp((z, x), combine_inner_dims=(1, 5), fast=True)
    with torch.no_grad():
        assert mlp((z, x), combine_inner_dims=(1, 5), fast=True).shape == (1, 5, 4)


def test_remat_dots_is_not_ported():
    cfg = tr.RenderConfig(n_coarse=4)
    with pytest.raises(NotImplementedError):
        tr.render_rays_chunked((None, None), torch.zeros((1, 8, 8)), cfg, 4, remat="dots")


def test_gather_rows_autograd_plain_matches_wrapper_on_cpu():
    """GatherRowsLerp through the wrappers (use_kernels=True; the CPU runs
    their plain versions, no launch) equals the plain Function."""
    g = torch.Generator().manual_seed(0)
    table = torch.randn((40, 16), generator=g, requires_grad=True)
    idx = torch.randint(0, 40, (30, 4), generator=g, dtype=torch.int32)
    w = torch.rand((30, 4), generator=g, requires_grad=True)
    before = (gather_rows_lerp.launches, gather_rows_lerp_bwd.launches)
    res = []
    for use_kernels in (True, False):
        out = GatherRowsLerp.apply(table, idx, w, torch.float32, use_kernels)
        res.append((out, *torch.autograd.grad(out.square().sum(), (table, w))))
    for a, b in zip(*res):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    assert (gather_rows_lerp.launches, gather_rows_lerp_bwd.launches) == before
