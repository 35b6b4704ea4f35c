"""The port's renderer against the JAX package's on the CPU: the samplers
and compositing on the same draws, the whole staged ``render_rays`` and
``FullRenderer.render_image`` of a small SRN-shaped model in float32 with
the JAX draws injected, and the bf16 fast path against JAX's (whose MLP is
the Pallas kernel in interpret mode)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixelnerf_tpu.eval.common import FullRenderer as JaxFullRenderer
from pixelnerf_tpu.render import renderer as jr
from pixelnerf_tpu_torch.eval import FullRenderer
from pixelnerf_tpu_torch.ops.fused_mlp import fused_resnetfc_infer
from pixelnerf_tpu_torch.ops.gather import gather_bilerp
from pixelnerf_tpu_torch.render import renderer as tr

from torch_port_utils import FOCAL, build_pair, jax_draws, novel_rays, source_view, t


def _np(x):
    return np.asarray(x, np.float32)


CFG = dict(n_coarse=16, n_fine=8, n_fine_depth=4, white_bkgd=True)


def test_samplers_and_composite_match_jax():
    jcfg, tcfg = jr.RenderConfig(**CFG), tr.RenderConfig(**CFG)
    rays = novel_rays()[:, :12]
    key = jax.random.PRNGKey(3)
    noise = jax_draws(key, 1, 12, jcfg)
    k_coarse, k_fine, k_depth, _, _ = jax.random.split(key, 5)
    zc_j = jr.sample_coarse(k_coarse, jnp.asarray(rays), jcfg)
    zc_t = tr.sample_coarse(t(rays), tcfg, noise["coarse"])
    np.testing.assert_allclose(zc_t.numpy(), _np(zc_j), atol=1e-6)
    rng = np.random.default_rng(0)
    out = rng.uniform(0, 3, (1, 12, 16, 4)).astype(np.float32)
    comp_j = jr.composite_outputs(jnp.asarray(out), jnp.asarray(rays), zc_j, jcfg)
    comp_t = tr.composite_outputs(t(out), t(rays), zc_t, tcfg)
    for k in ("weights", "rgb", "depth"):
        np.testing.assert_allclose(comp_t[k].numpy(), _np(comp_j[k]), atol=1e-5, err_msg=k)
    zf_j = jr.sample_fine(k_fine, jnp.asarray(rays), comp_j["weights"], jcfg)
    zf_t = tr.sample_fine(t(rays), comp_t["weights"], tcfg, noise["fine_u"], noise["fine_jitter"])
    np.testing.assert_allclose(zf_t.numpy(), _np(zf_j), atol=1e-5)
    zd_j = jr.sample_fine_depth(k_depth, jnp.asarray(rays), comp_j["depth"], jcfg)
    zd_t = tr.sample_fine_depth(t(rays), comp_t["depth"], tcfg, noise["depth"])
    np.testing.assert_allclose(zd_t.numpy(), _np(zd_j), atol=1e-5)


def test_stable_sort_keeps_tie_order():
    """Equal depths keep the coarse-first order, like lax.sort(is_stable)."""
    z = jnp.asarray([[[0.5, 0.2, 0.5, 0.2, 0.9]]])
    pay = jnp.arange(5.0)[None, None]
    ref = jax.lax.sort([z, pay], dimension=-1, num_keys=1, is_stable=True)[1]
    zs, order = torch.sort(torch.tensor(np.asarray(z)), dim=-1, stable=True)
    np.testing.assert_array_equal(order.numpy().astype(np.float32), _np(ref))


@pytest.fixture(scope="module")
def pair():
    return build_pair()


def _encodings(jnet, variables, tnet):
    images, poses = source_view()
    enc_j = jnet.apply(variables, jnp.asarray(images), jnp.asarray(poses), jnp.asarray(FOCAL), method=jnet.encode)
    with torch.no_grad():
        enc_t = tnet.encode(t(images), t(poses), FOCAL)
    return enc_j, enc_t


def test_staged_render_rays_matches_jax_f32(pair):
    jnet, variables, tnet, jconf, tconf = pair
    jcfg = jr.RenderConfig.from_conf(jconf["renderer"])
    tcfg = tr.RenderConfig.from_conf(tconf["renderer"])
    enc_j, enc_t = _encodings(jnet, variables, tnet)
    rays = novel_rays()
    key = jax.random.PRNGKey(7)

    def features_fn(xyz, viewdirs):
        return jnet.apply(variables, enc_j, xyz, viewdirs=viewdirs, method=jnet.query_features)

    def mlp_fn(feats, coarse):
        return jnet.apply(variables, enc_j, feats, coarse=coarse, method=jnet.query_mlp)

    ref = jr.render_rays((features_fn, mlp_fn), jnp.asarray(rays), key, jcfg, want_weights=True)
    with torch.no_grad():
        out = tr.render_rays(
            (lambda xyz, vd: tnet.query_features(enc_t, xyz, vd),
             lambda feats, coarse: tnet.query_mlp(enc_t, feats, coarse)),
            t(rays), tcfg, noise=jax_draws(key, 1, rays.shape[1], jcfg), want_weights=True,
        )
    for branch in ("coarse", "fine"):
        for k in ("rgb", "depth", "weights"):
            # the encoder's ~1e-4 through the MLP and the compositing; an
            # importance sample may cross a bin edge where cdf and u agree
            # to float32 rounding, which 64 rays do not hit at this seed
            np.testing.assert_allclose(
                out[branch][k].numpy(), _np(ref[branch][k]), atol=5e-4, err_msg=f"{branch}/{k}"
            )
    # non-degeneracy: two near-constant renders must not certify a match
    assert float(np.std(_np(ref["fine"]["rgb"]))) > 1e-3


def test_full_renderer_matches_jax_f32(pair):
    jnet, variables, tnet, jconf, tconf = pair
    jcfg = jr.RenderConfig.from_conf(jconf["renderer"])
    tcfg = tr.RenderConfig.from_conf(tconf["renderer"])
    enc_j, enc_t = _encodings(jnet, variables, tnet)
    rays = novel_rays().reshape(8, 8, 8)
    n = 64
    # one chunk; scan_chunk >= the chunk keeps JAX's render unscanned
    jfr = JaxFullRenderer(jnet, jcfg, ray_chunk=n, scan_chunk=n)
    rng = jax.random.PRNGKey(11)
    rgb_j, depth_j = jfr.render_image(variables, enc_j, rays, rng)
    _, key = jax.random.split(rng)      # FullRenderer's per-chunk key
    noise = [jax_draws(key, 1, n, jcfg)]
    rgb_t, depth_t = FullRenderer(tnet, tcfg, ray_chunk=n).render_image(enc_t, t(rays), noise=noise)
    assert rgb_t.shape == (8, 8, 3) and depth_t.shape == (8, 8)
    np.testing.assert_allclose(rgb_t.numpy(), rgb_j, atol=5e-4)
    np.testing.assert_allclose(depth_t.numpy(), depth_j, atol=5e-4)
    assert float(np.std(rgb_j)) > 1e-3


def test_full_renderer_fast_bf16_matches_jax():
    """The serving configuration at small size: bf16, fast=True. On the CPU
    the port's gather and fused MLP run their plain versions; JAX's fused
    MLP is the Pallas kernel in interpret mode."""
    jnet, variables, tnet, jconf, tconf = build_pair(d_hidden=128, dtype="bfloat16")
    jcfg = jr.RenderConfig.from_conf(jconf["renderer"])
    tcfg = tr.RenderConfig.from_conf(tconf["renderer"])
    enc_j, enc_t = _encodings(jnet, variables, tnet)
    assert enc_t.latent.dtype == torch.bfloat16
    rays = novel_rays(n_side=6).reshape(6, 6, 8)
    n = 36
    jfr = JaxFullRenderer(jnet, jcfg, ray_chunk=n, scan_chunk=n, fast=True)
    rng = jax.random.PRNGKey(5)
    rgb_j, depth_j = jfr.render_image(variables, enc_j, rays, rng)
    _, key = jax.random.split(rng)
    launches = (gather_bilerp.launches, fused_resnetfc_infer.launches)
    rgb_t, depth_t = FullRenderer(tnet, tcfg, ray_chunk=n, fast=True).render_image(
        enc_t, t(rays), noise=[jax_draws(key, 1, n, jcfg)]
    )
    assert (gather_bilerp.launches, fused_resnetfc_infer.launches) == launches
    # bf16 encoder convolutions and per-layer bf16 rounding in two
    # libraries: a few bf16 ulps on sigma and rgb, integrated along the ray
    np.testing.assert_allclose(rgb_t.numpy(), rgb_j, atol=3e-2)
    np.testing.assert_allclose(depth_t.numpy(), depth_j, atol=3e-2)
    assert float(np.std(rgb_j)) > 1e-3


def test_full_renderer_chunks_match_one_chunk(pair):
    """The ray-chunk loop: 4 chunks of 16 rays, each with its slice of the
    noise, give the one-chunk render of the same 64 rays."""
    _, _, tnet, _, tconf = pair
    tcfg = tr.RenderConfig.from_conf(tconf["renderer"])
    images, poses = source_view()
    with torch.no_grad():
        enc = tnet.encode(t(images), t(poses), FOCAL)
    rays = t(novel_rays()[0])
    noise = tr.draw_noise(rays[None], tcfg, torch.Generator().manual_seed(0))
    whole = FullRenderer(tnet, tcfg, ray_chunk=64, want_weights=True)(enc, rays, noise=[noise])
    parts = [{k: v[:, i : i + 16] for k, v in noise.items()} for i in range(0, 64, 16)]
    chunked = FullRenderer(tnet, tcfg, ray_chunk=16, want_weights=True)(enc, rays, noise=parts)
    for branch in ("coarse", "fine"):
        for k in ("rgb", "depth", "weights"):
            # the same per-ray arithmetic; batched matmuls may block the
            # float32 sums differently at another batch size
            np.testing.assert_allclose(
                chunked[branch][k].numpy(), whole[branch][k].numpy(), atol=1e-5, err_msg=f"{branch}/{k}"
            )
    with pytest.raises(ValueError):
        FullRenderer(tnet, tcfg, ray_chunk=16)(enc, rays)      # no generator, no noise
