"""The fused and baked field paths of the port against the JAX package's on
the CPU: the fused gather+MLP kernel's plain version against the Pallas
kernel in interpret mode, the ``z_is_tz`` variant of the fused MLP, its
multi-view mode against the dense chain and the JAX package's XLA path,
``bake_encoding``, ``query`` / ``query_fused``, the unstaged renderer and
``NeRFRenderer``, ``FullRenderer`` on a baked encoding, and the gather
study's plain version. Inputs come from numpy seeds and go to both sides;
the weights are carried over by the weight bridge."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixelnerf_tpu.eval.common import FullRenderer as JaxFullRenderer
from pixelnerf_tpu.models import bake_encoding as jax_bake_encoding
from pixelnerf_tpu.models.pixelnerf import pack_encoding as jax_pack_encoding
from pixelnerf_tpu.ops import fused_field as jff
from pixelnerf_tpu.ops import fused_mlp as jfm
from pixelnerf_tpu.ops import gather_pallas as jgp
from pixelnerf_tpu.render import renderer as jr
from pixelnerf_tpu_torch.eval import FullRenderer
from pixelnerf_tpu_torch.models import ResnetFC, bake_encoding, pack_encoding
from pixelnerf_tpu_torch.ops import _build
from pixelnerf_tpu_torch.ops import grid_sample as tgs
from pixelnerf_tpu_torch.ops.fused_field import (
    fused_gather_resnetfc_infer,
    fused_gather_resnetfc_infer_plain,
)
from pixelnerf_tpu_torch.ops.fused_mlp import (
    agrees_with_plain, disagreement_with_plain, fused_resnetfc_infer, fused_resnetfc_infer_plain, pack_weights,
)
from pixelnerf_tpu_torch.utils import profiling
from pixelnerf_tpu_torch.ops.gather import gather_bilerp, gather_bilerp_plain
from pixelnerf_tpu_torch.ops.gather_study import FORMULATIONS, gather_study, gather_study_plain
from pixelnerf_tpu_torch.render import renderer as tr

from test_fused_field import COMBINE, D_HIDDEN, D_IN, D_LATENT, N_BLOCKS, _mlp_params
from torch_port_utils import (
    FOCAL, build_pair, jax_draws, mlp_pair, novel_rays, port_weights_from_jax, source_view, t,
)


def _np(x):
    return np.asarray(x, np.float32)


def _bf16_close(out, ref):
    """tests/test_fused_mlp.py's tolerance for two bf16 chains: both round
    every layer to bf16, and float32 sums in another order can flip one
    rounding, which the later layers carry; most entries agree far closer,
    to 1e-2 plus one bf16 ulp (2^-8) of the value: the last layer's bias add
    is rounded to bf16 here, while XLA on the CPU keeps that sum in float32."""
    np.testing.assert_allclose(out, ref, atol=5e-2, rtol=5e-2)
    assert np.mean(np.abs(out - ref) < 1e-2 + 2.0 ** -8 * np.abs(ref)) > 0.95


def _field_points(kind, rng, H, W):
    """Pixel coordinates of the test points: random interior points, every
    exact pixel corner, or points exactly on the right and bottom borders."""
    if kind == "corners":
        ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
        return xs.reshape(-1).astype(np.float32), ys.reshape(-1).astype(np.float32)
    if kind == "borders":
        n = 40
        ix = rng.uniform(0, W - 1, n).astype(np.float32)
        iy = rng.uniform(0, H - 1, n).astype(np.float32)
        ix[: n // 2] = W - 1            # right border: no right-hand neighbour
        iy[n // 4 : 3 * n // 4] = H - 1  # bottom border; the overlap is the last pixel
        return ix, iy
    return (rng.uniform(0, W - 1, kind).astype(np.float32),
            rng.uniform(0, H - 1, kind).astype(np.float32))


@pytest.mark.parametrize("points", [64, 256, 700, "corners", "borders"])
def test_fused_field_plain_matches_jax_kernel(points):
    """The port's wrapper on CPU tensors (its plain version: kernel A's then
    kernel B's) against the Pallas gather+MLP kernel in interpret mode, at
    point counts off the tile, at exact corners and on the borders; and the
    row bases and the gathered rows against the JAX package's."""
    rng = np.random.default_rng(3)
    H, W = (5, 5) if points == "corners" else (9, 9)
    feats = rng.normal(size=(H, W, D_LATENT)).astype(np.float32)
    ix, iy = _field_points(points, rng, H, W)
    n = ix.shape[0]
    x = rng.normal(size=(n, D_IN)).astype(np.float32)
    jweights = jfm.pack_weights(
        jax.tree_util.tree_map(jnp.asarray, _mlp_params(rng)), N_BLOCKS, COMBINE, D_LATENT, D_IN, D_HIDDEN
    )
    jtable = jgp.pack_lr_table(jnp.asarray(feats))
    jbase, jwg = jgp.bilinear_pair_bases(jnp.asarray(ix), jnp.asarray(iy), H, W)
    ref = _np(jff.fused_gather_resnetfc_infer(jtable, jbase, jwg, jnp.asarray(x), jweights, N_BLOCKS, COMBINE,
                                              interpret=True))

    table = t(feats, torch.bfloat16).reshape(H * W, D_LATENT)
    base, wg = tgs.bilinear_pair_bases(t(ix), t(iy), H, W)
    np.testing.assert_array_equal(base.numpy(), np.asarray(jbase))
    np.testing.assert_array_equal(wg.numpy(), _np(jwg))
    # the gathered rows: the same float32 lerp of the same bf16 corners
    rows = gather_bilerp_plain(table, base, wg, W, torch.float32)
    jrows = _np(jgp.gather_packed_lerp(jtable, jbase, jwg, interpret=True))
    np.testing.assert_allclose(rows.numpy(), jrows, atol=1e-6, rtol=0)
    if points == "corners":
        np.testing.assert_array_equal(rows.numpy(), table.float().numpy())

    weights = port_weights_from_jax(jweights)
    before = fused_gather_resnetfc_infer.launches
    out = fused_gather_resnetfc_infer(table, base, wg, t(x, torch.bfloat16), weights, N_BLOCKS, COMBINE, W)
    assert fused_gather_resnetfc_infer.launches == before     # CPU tensors: no launch
    assert out.shape == (n, 4) and out.dtype == torch.float32
    _bf16_close(out.numpy(), ref)
    # the plain version is kernel A's plain version feeding kernel B's
    z = gather_bilerp(table, base, wg, W, torch.bfloat16)
    want = fused_resnetfc_infer(z, t(x, torch.bfloat16), weights, N_BLOCKS, COMBINE)
    assert torch.equal(out, want)
    assert torch.equal(out, fused_gather_resnetfc_infer_plain(
        table, base, wg, t(x, torch.bfloat16), weights, N_BLOCKS, COMBINE, W))


def test_fused_plain_tz_matches_jax_pretransformed():
    """Kernel B's plain version with z_is_tz against JAX ResnetFC(fast=True,
    z_pretransformed=True) (the Pallas kernel in interpret mode), the
    injections baked exactly as bake_encoding bakes them."""
    jmlp, variables, tmlp = mlp_pair("bfloat16", d_hidden=128, d_latent=512)
    rng = np.random.default_rng(3)
    z = rng.normal(size=(300, 512)).astype(np.float32)
    x = rng.normal(size=(300, 42)).astype(np.float32)
    p = variables["params"]
    K = np.concatenate([p[f"lin_z_{i}"]["kernel"] for i in range(3)], axis=1)
    b = np.concatenate([p[f"lin_z_{i}"]["bias"] for i in range(3)])
    tz = z @ K + b
    ref = _np(jmlp.apply(variables, (jnp.asarray(tz), jnp.asarray(x)), combine_inner_dims=(1, 300),
                         fast=True, z_pretransformed=True)).reshape(300, 4)
    weights = pack_weights(tmlp, with_wz=False)
    before = fused_resnetfc_infer.launches
    out = fused_resnetfc_infer(t(tz, torch.bfloat16), t(x, torch.bfloat16), weights, 5, 3, z_is_tz=True)
    assert fused_resnetfc_infer.launches == before
    _bf16_close(out.numpy(), ref)
    with torch.no_grad():
        via_module = tmlp((t(tz), t(x)), combine_inner_dims=(1, 300), fast=True, z_pretransformed=True)
        unbaked = tmlp((t(z), t(x)), combine_inner_dims=(1, 300), fast=True)
    assert torch.equal(via_module.reshape(300, 4), out)
    # baked against unbaked: the baked injections are float32 products of
    # float32 weights rounded once, the unbaked ones bf16 products of bf16
    # latents and weights: ~1 bf16 ulp of every injection, carried through
    # five blocks to outputs of magnitude ~8
    np.testing.assert_allclose(out.numpy(), unbaked.reshape(300, 4).numpy(), atol=1e-1, rtol=5e-2)
    # the dummy-free tuple and the full one give the same result
    full = fused_resnetfc_infer_plain(t(tz, torch.bfloat16), t(x, torch.bfloat16), pack_weights(tmlp), 5, 3, True)
    assert torch.equal(full, out)


@pytest.mark.parametrize("ns,sb,b", [(2, 1, 70), (2, 2, 130), (3, 1, 100), (3, 2, 70)])
def test_fused_plain_views_matches_dense_chain_bf16(ns, sb, b):
    """Kernel B's plain multi-view version (ns views averaged at combine
    layer 3) against the port's dense bf16 chain, within the MLP contract;
    ``ResnetFC(fast=True)`` on the CPU runs the plain version."""
    _, _, tmlp = mlp_pair("bfloat16", d_hidden=64, d_latent=128, seed=ns + sb)
    g = torch.Generator().manual_seed(10 * ns + sb)
    z = torch.randn((sb * ns * b, 128), generator=g)
    x = torch.randn((sb * ns * b, 42), generator=g)
    with torch.no_grad():
        dense = tmlp((z, x), combine_inner_dims=(ns, b))
        fast = tmlp((z, x), combine_inner_dims=(ns, b), fast=True)
    ref, peak = fused_resnetfc_infer_plain(z.to(torch.bfloat16), x.to(torch.bfloat16), pack_weights(tmlp), 5, 3,
                                           hidden_max=True, views=ns, points=b)
    assert dense.shape == fast.shape == (sb, b, 4) and ref.shape == (sb * b, 4)
    d = disagreement_with_plain(dense.reshape(-1, 4).float(), ref, peak)
    assert agrees_with_plain(d), d
    assert torch.equal(fast.reshape(-1, 4), ref)
    # the mean's rows are the views' of one point: views of one scene
    # permuted give the same result within the contract
    perm = torch.arange(sb * ns * b).reshape(sb, ns, b).flip(1).reshape(-1)
    other = fused_resnetfc_infer_plain(z[perm].to(torch.bfloat16), x[perm].to(torch.bfloat16), pack_weights(tmlp),
                                       5, 3, views=ns, points=b)
    assert agrees_with_plain(disagreement_with_plain(other, ref, peak))


def test_fused_plain_views_matches_jax_xla_at_three_views():
    """Kernel B's plain multi-view version against the JAX package's
    ResnetFC(fast=True) at three views, where the JAX package gates its
    kernel off and runs the bf16 chain through XLA; the weights carried by
    the weight bridge."""
    jmlp, variables, tmlp = mlp_pair("bfloat16", d_hidden=128, d_latent=512)
    rng = np.random.default_rng(8)
    sb, ns, b = 2, 3, 90
    z = rng.normal(size=(sb * ns * b, 512)).astype(np.float32)
    x = rng.normal(size=(sb * ns * b, 42)).astype(np.float32)
    ref = _np(jmlp.apply(variables, (jnp.asarray(z), jnp.asarray(x)), combine_inner_dims=(ns, b), fast=True))
    out = fused_resnetfc_infer_plain(t(z, torch.bfloat16), t(x, torch.bfloat16), pack_weights(tmlp), 5, 3,
                                     views=ns, points=b)
    assert ref.shape == (sb, b, 4)
    _bf16_close(out.numpy(), ref.reshape(-1, 4))


@pytest.mark.parametrize("case", ["average", "max", "softplus", "spade", "float32", "baked", "autograd",
                                  "combine_0", "combine_past_blocks"])
def test_resnetfc_multi_view_gate(case):
    """At three views ``fast=True`` takes kernel B's multi-view mode only for
    an averaged, ReLU, SPADE-free bf16 field on latents that are not baked,
    averaged after at least one block; the rest takes the dense chain, and
    autograd raises as at one view. A combine layer past the blocks never
    averages: each row is a view of its own, the single-view kernel's."""
    kw = dict(d_in=42, d_latent=64, d_hidden=32, n_blocks=5, combine_layer=3, dtype=torch.bfloat16)
    if case == "combine_0":
        kw["combine_layer"] = 0
    elif case == "combine_past_blocks":
        kw["combine_layer"] = 1000      # ResnetFC.from_conf's default: the views are never averaged
    elif case == "max":
        kw["combine_type"] = "max"
    elif case == "softplus":
        kw["beta"] = 5.0
    elif case == "spade":
        kw["use_spade"] = True
    elif case == "float32":
        kw["dtype"] = torch.float32
    mlp = ResnetFC(**kw)
    g = torch.Generator().manual_seed(0)
    z = torch.randn((3 * 10, 3 * 32 if case == "baked" else 64), generator=g)
    x = torch.randn((3 * 10, 42), generator=g)
    call = dict(combine_inner_dims=(3, 10), fast=True, z_pretransformed=case == "baked")
    if case == "autograd":
        with pytest.raises(RuntimeError, match="inference-only"):
            mlp((z, x), **call)
        return
    profiling.enable()
    try:
        with torch.no_grad(), profiling.span("field.mlp"):
            if case == "combine_0":
                # the chain, as the JAX package's, has no injection to
                # concatenate when the views are averaged before block 0
                with pytest.raises(ValueError, match="non-empty"):
                    mlp((z, x), **call)
            else:
                out = mlp((z, x), **call)
    finally:
        profiling.disable()
    (rec,) = profiling.take()
    if case == "combine_0":
        assert rec.counts == {"dense": 1}
        return
    assert out.shape == ((30, 4) if case == "combine_past_blocks" else (1, 10, 4))
    if case == "combine_past_blocks":
        assert rec.counts == {"kernel_b": 1}
    elif case == "average":
        assert rec.counts == {"kernel_b": 1, "kernel_b_views": 3}
        want = fused_resnetfc_infer_plain(z.to(torch.bfloat16), x.to(torch.bfloat16), pack_weights(mlp), 5, 3,
                                          views=3, points=10)
        assert torch.equal(out.reshape(-1, 4), want)
    else:
        assert rec.counts == {"dense": 1}


def test_resnetfc_pretransformed_dense_chain_matches_jax_f32():
    jmlp, variables, tmlp = mlp_pair()
    rng = np.random.default_rng(4)
    z = rng.normal(size=(30, 128)).astype(np.float32)
    x = rng.normal(size=(30, 42)).astype(np.float32)
    p = variables["params"]
    K = np.concatenate([p[f"lin_z_{i}"]["kernel"] for i in range(3)], axis=1)
    b = np.concatenate([p[f"lin_z_{i}"]["bias"] for i in range(3)])
    tz = (z @ K + b).astype(np.float32)
    ref = _np(jmlp.apply(variables, (jnp.asarray(tz), jnp.asarray(x)), combine_inner_dims=(1, 30),
                         z_pretransformed=True))
    with torch.no_grad():
        out = tmlp((t(tz), t(x)), combine_inner_dims=(1, 30), z_pretransformed=True)
        unbaked = tmlp((t(z), t(x)), combine_inner_dims=(1, 30))
    # float32 products of width <= 128 summed in other orders
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(out.numpy(), unbaked.numpy(), atol=1e-4, rtol=1e-4)
    with pytest.raises(ValueError, match="z width"):
        tmlp((t(z), t(x)), combine_inner_dims=(1, 30), z_pretransformed=True)   # raw z, 128 wide


@pytest.fixture(scope="module")
def pair():
    return build_pair()


@pytest.fixture(scope="module")
def pair_bf16():
    return build_pair(d_hidden=128, dtype="bfloat16")


def _encodings(jnet, variables, tnet, share_latent=False):
    """Both sides' encodings of the source view; with ``share_latent`` the
    port's holds the JAX latent, so that what follows is compared without
    the two encoders' own difference."""
    images, poses = source_view()
    enc_j = jnet.apply(variables, jnp.asarray(images), jnp.asarray(poses), jnp.asarray(FOCAL), method=jnet.encode)
    with torch.no_grad():
        enc_t = tnet.encode(t(images), t(poses), FOCAL)
    if share_latent:
        enc_t = dataclasses.replace(enc_t, latent=t(enc_j.latent, enc_t.latent.dtype))
    return enc_j, enc_t


def _query_points(n_rays=20, n_z=5):
    rays = novel_rays()[:, :n_rays]
    z = np.linspace(0.9, 1.7, n_z, dtype=np.float32)
    pts = (rays[..., None, :3] + z[:, None] * rays[..., None, 3:6]).reshape(1, -1, 3)
    dirs = np.broadcast_to(rays[..., None, 3:6], (1, n_rays, n_z, 3)).reshape(1, -1, 3)
    return pts, np.ascontiguousarray(dirs)


def test_bake_encoding_maps_match_jax(pair):
    jnet, variables, tnet, _, _ = pair
    enc_j, enc_t = _encodings(jnet, variables, tnet, share_latent=True)
    baked_j = jax_bake_encoding(jnet, variables, enc_j)
    baked_t = bake_encoding(tnet, enc_t)
    n_lin_z = min(tnet.mlp_coarse.combine_layer, tnet.mlp_coarse.n_blocks)
    assert baked_t.tz_coarse.shape == enc_t.latent.shape[:3] + (n_lin_z * tnet.mlp_coarse.d_hidden,)
    assert baked_t.tz_coarse.dtype == enc_t.latent.dtype and baked_t.latent is enc_t.latent
    for name in ("tz_coarse", "tz_fine"):
        ref = _np(getattr(baked_j, name))
        # float32 products of width 128 summed in other orders
        np.testing.assert_allclose(getattr(baked_t, name).numpy(), ref, atol=1e-5 * np.abs(ref).max(), rtol=0,
                                   err_msg=name)
    assert not torch.equal(baked_t.tz_coarse, baked_t.tz_fine)      # one map per MLP


def test_baked_query_matches_unbaked_and_jax(pair):
    jnet, variables, tnet, _, _ = pair
    enc_j, enc_t = _encodings(jnet, variables, tnet)
    baked_j = jax_bake_encoding(jnet, variables, enc_j)
    baked_t = bake_encoding(tnet, enc_t)
    pts, dirs = _query_points()
    for coarse in (True, False):
        ref = _np(jnet.apply(variables, baked_j, jnp.asarray(pts), viewdirs=jnp.asarray(dirs), coarse=coarse,
                             method=jnet.query))
        with torch.no_grad():
            baked = tnet.query(baked_t, t(pts), t(dirs), coarse=coarse)
            plain = tnet.query(enc_t, t(pts), t(dirs), coarse=coarse)
        # exact but for float32 reassociation (tests/test_pixelnerf.py's tolerance)
        np.testing.assert_allclose(baked.numpy(), plain.numpy(), atol=3e-5, rtol=1e-4)
        # the two encoders' 1e-4 carried through a 5-block MLP
        np.testing.assert_allclose(baked.numpy(), ref, atol=5e-4, rtol=1e-3)
    assert float(np.std(plain.numpy()[..., :3])) > 1e-3


def test_bake_encoding_guards(pair):
    _, _, tnet, _, _ = pair
    images, poses = source_view()
    with torch.no_grad():
        enc = tnet.encode(t(images), t(poses), FOCAL)
    tnet.encoder.index_padding = "zeros"
    try:
        with pytest.raises(ValueError, match="zeros-padding"):
            bake_encoding(tnet, enc)
    finally:
        tnet.encoder.index_padding = "border"
    with pytest.raises(ValueError, match="spatial encoder"):
        bake_encoding(tnet, dataclasses.replace(enc, latent=None))
    # all-or-nothing: a fine MLP without latent injections leaves both unbaked
    fine = tnet.mlp_fine
    tnet.mlp_fine = ResnetFC(d_in=fine.d_in, d_latent=0, d_hidden=fine.d_hidden)
    try:
        half = bake_encoding(tnet, enc)
    finally:
        tnet.mlp_fine = fine
    assert half.tz_coarse is None and half.tz_fine is None


def test_query_matches_jax_f32(pair):
    jnet, variables, tnet, _, _ = pair
    enc_j, enc_t = _encodings(jnet, variables, tnet)
    pts, dirs = _query_points()
    for coarse in (True, False):
        ref = _np(jnet.apply(variables, enc_j, jnp.asarray(pts), viewdirs=jnp.asarray(dirs), coarse=coarse,
                             method=jnet.query))
        with torch.no_grad():
            out = tnet.query(enc_t, t(pts), t(dirs), coarse=coarse)
            staged = tnet.query_mlp(enc_t, tnet.query_features(enc_t, t(pts), t(dirs)), coarse=coarse)
        assert torch.equal(out, staged)          # query is the two stages in a row
        # the encoder's 1e-4 carried through a 5-block MLP
        np.testing.assert_allclose(out.numpy(), ref, atol=5e-4, rtol=1e-3)
    assert float(np.std(ref[..., :3])) > 1e-3


def test_query_fused_matches_query_and_jax(pair_bf16):
    """query_fused on a packed encoding against JAX query_fused (the Pallas
    gather+MLP kernel in interpret mode) on the same latent, and against the
    port's own query(fast=True)."""
    jnet, variables, tnet, _, _ = pair_bf16
    enc_j, enc_t = _encodings(jnet, variables, tnet, share_latent=True)
    penc_j = jax_pack_encoding(jnet, enc_j)
    penc_t = pack_encoding(tnet, enc_t)
    n, hl, wl, c = enc_t.latent.shape
    assert penc_t.latent_packed.shape == (1, hl * wl, c) and penc_t.latent_packed.dtype == torch.bfloat16
    assert penc_t.latent_packed.is_contiguous()
    assert torch.equal(penc_t.latent_packed.reshape(enc_t.latent.shape).float(), enc_t.latent.float())
    pts, dirs = _query_points(n_rays=37, n_z=9)          # 333 points: off every tile size
    for coarse in (True, False):
        ref = _np(jnet.apply(variables, penc_j, jnp.asarray(pts), viewdirs=jnp.asarray(dirs), coarse=coarse,
                             method=jnet.query_fused))
        with torch.no_grad():
            fused = tnet.query_fused(penc_t, t(pts), t(dirs), coarse=coarse)
            fast = tnet.query(enc_t, t(pts), t(dirs), coarse=coarse, fast=True)
        assert fused.shape == (1, 333, 4)
        _bf16_close(fused.numpy(), ref)
        # on the CPU both run kernel A's plain version feeding kernel B's
        assert torch.equal(fused, fast)
    assert float(np.std(ref[..., :3])) > 1e-3


@pytest.mark.parametrize(
    "case", ["not_packed", "two_scenes", "two_views", "no_encoder", "nearest", "zeros", "baked"]
)
def test_query_fused_raises(pair_bf16, case):
    _, _, tnet, _, _ = pair_bf16
    images, poses = source_view()
    with torch.no_grad():
        enc = pack_encoding(tnet, tnet.encode(t(images), t(poses), FOCAL))
    pts, dirs = _query_points(4, 2)
    attr, saved = None, None
    if case == "not_packed":
        enc = dataclasses.replace(enc, latent_packed=None)
    elif case == "two_scenes":
        enc = dataclasses.replace(enc, latent_packed=enc.latent_packed.repeat(2, 1, 1))
    elif case == "two_views":
        enc = dataclasses.replace(enc, num_views=2)
    elif case == "no_encoder":
        attr, saved, tnet.use_encoder = "use_encoder", tnet.use_encoder, False
    elif case == "nearest":
        attr, saved, tnet.encoder.index_interp = "index_interp", tnet.encoder.index_interp, "nearest"
    elif case == "zeros":
        attr, saved, tnet.encoder.index_padding = "index_padding", tnet.encoder.index_padding, "zeros"
    elif case == "baked":
        enc = dataclasses.replace(bake_encoding(tnet, enc), latent_packed=enc.latent_packed)
    before = fused_gather_resnetfc_infer.launches
    try:
        with torch.no_grad(), pytest.raises(ValueError):
            tnet.query_fused(enc, t(pts), t(dirs))
    finally:
        if attr == "use_encoder":
            tnet.use_encoder = saved
        elif attr is not None:
            setattr(tnet.encoder, attr, saved)
    assert fused_gather_resnetfc_infer.launches == before


@pytest.mark.parametrize("case", ["not_fast", "z_given", "pretransformed", "float32", "multi_view", "autograd"])
def test_resnetfc_gather_raises(case):
    """gather= is a deliberate opt-in: every condition it needs raises when
    unmet, none falls back to the dense chain."""
    dtype = torch.float32 if case == "float32" else torch.bfloat16
    mlp = ResnetFC(d_in=42, d_latent=64, d_hidden=32, n_blocks=5, combine_layer=3, dtype=dtype)
    table = torch.zeros((16, 64), dtype=torch.bfloat16)
    gather = (table, torch.zeros((1, 6, 2), dtype=torch.int32), torch.zeros((1, 6, 2)), 4)
    x = torch.zeros((1, 6, 42))
    z = torch.zeros((1, 6, 64)) if case == "z_given" else None
    kw = dict(combine_inner_dims=(2, 3) if case == "multi_view" else (1, 6), fast=case != "not_fast",
              z_pretransformed=case == "pretransformed", gather=gather)
    if case == "autograd":
        with pytest.raises(RuntimeError, match="inference-only"):
            mlp((z, x), **kw)
        with torch.no_grad():
            assert mlp((z, x), **kw).shape == (1, 6, 4)
        return
    with torch.no_grad(), pytest.raises(ValueError):
        mlp((z, x), **kw)


def _render_setup(pair):
    jnet, variables, tnet, jconf, tconf = pair
    jcfg = jr.RenderConfig.from_conf(jconf["renderer"])
    tcfg = tr.RenderConfig.from_conf(tconf["renderer"])
    enc_j, enc_t = _encodings(jnet, variables, tnet)
    return jnet, variables, tnet, jcfg, tcfg, enc_j, enc_t


def _stages(tnet, enc):
    return (lambda xyz, vd: tnet.query_features(enc, xyz, vd),
            lambda feats, coarse: tnet.query_mlp(enc, feats, coarse))


def test_unstaged_render_rays_matches_jax_and_staged_f32(pair):
    jnet, variables, tnet, jcfg, tcfg, enc_j, enc_t = _render_setup(pair)
    rays = novel_rays()
    key = jax.random.PRNGKey(7)

    def jquery(xyz, viewdirs, coarse):
        return jnet.apply(variables, enc_j, xyz, viewdirs=viewdirs, coarse=coarse, method=jnet.query)

    ref = jr.render_rays(jquery, jnp.asarray(rays), key, jcfg, want_weights=True)
    noise = jax_draws(key, 1, rays.shape[1], jcfg)
    with torch.no_grad():
        out = tr.render_rays(lambda xyz, vd, coarse: tnet.query(enc_t, xyz, vd, coarse=coarse),
                             t(rays), tcfg, noise=noise, want_weights=True)
        staged = tr.render_rays(_stages(tnet, enc_t), t(rays), tcfg, noise=noise, want_weights=True)
    assert out["fine"]["weights"].shape == (1, 64, tcfg.n_coarse + tcfg.n_fine)
    for branch in ("coarse", "fine"):
        for k in ("rgb", "depth", "weights"):
            # the encoder's ~1e-4 through the MLP and the compositing
            np.testing.assert_allclose(out[branch][k].numpy(), _np(ref[branch][k]), atol=5e-4,
                                       err_msg=f"{branch}/{k}")
            # staged and unstaged: the same per-sample arithmetic in batches
            # of another size and order, so the float32 matrix products may
            # block their sums differently; not bit-identical in torch
            np.testing.assert_allclose(out[branch][k].numpy(), staged[branch][k].numpy(), atol=1e-5,
                                       err_msg=f"staged {branch}/{k}")
    assert float(np.std(_np(ref["fine"]["rgb"]))) > 1e-3


def test_composite_matches_jax():
    jcfg, tcfg = jr.RenderConfig(n_coarse=8, white_bkgd=True), tr.RenderConfig(n_coarse=8, white_bkgd=True)
    rays = novel_rays()[:, :10]
    z = np.sort(np.random.default_rng(0).uniform(0.8, 1.8, (1, 10, 8)).astype(np.float32), axis=-1)

    def field(mod, points, viewdirs, coarse):
        s = mod.sin(3.0 * points) * 0.5 + 0.5
        sigma = (2.0 if coarse else 4.0) * mod.abs(points[..., :1]) + viewdirs[..., 1:2] * 0.1
        return jnp.concatenate([s, sigma], -1) if mod is jnp else torch.cat([s, sigma], -1)

    for coarse in (True, False):
        ref = jr.composite(lambda p, v, c: field(jnp, p, v, c), jnp.asarray(rays), jnp.asarray(z), coarse, jcfg)
        out = tr.composite(lambda p, v, c: field(torch, p, v, c), t(rays), t(z), coarse, tcfg)
        for k in ("weights", "rgb", "depth"):
            np.testing.assert_allclose(out[k].numpy(), _np(ref[k]), atol=1e-5, err_msg=k)


def test_nerf_renderer_bind(pair):
    _, _, tnet, _, tconf = pair
    images, poses = source_view()
    with torch.no_grad():
        enc = tnet.encode(t(images), t(poses), FOCAL)
    renderer = tr.NeRFRenderer.from_conf(tconf["renderer"])
    assert renderer.cfg == tr.RenderConfig.from_conf(tconf["renderer"])
    rays = t(novel_rays())
    noise = tr.draw_noise(rays, renderer.cfg, torch.Generator().manual_seed(0))
    with torch.no_grad():
        out = renderer.bind(tnet, enc)(rays, noise=noise, want_weights=True)
        want = tr.render_rays(lambda p, v, c: tnet.query(enc, p, v, coarse=c), rays, renderer.cfg, noise=noise,
                              want_weights=True)
        rgb, depth = renderer.bind(tnet, enc, simple_output=True)(rays, noise=noise)
        parts = [{k: v[:, i : i + 16] for k, v in noise.items()} for i in range(0, 64, 16)]
        chunked = renderer.bind(tnet, enc)(rays, noise=parts, ray_chunk=16)
        drawn = renderer.bind(tnet, enc)(rays, generator=torch.Generator().manual_seed(0))
    for branch in ("coarse", "fine"):
        for k in ("rgb", "depth", "weights"):
            assert torch.equal(out[branch][k], want[branch][k])
    assert torch.equal(rgb, want["fine"]["rgb"]) and torch.equal(depth, want["fine"]["depth"])
    # the same per-ray arithmetic at another batch size
    np.testing.assert_allclose(chunked["fine"]["rgb"].numpy(), want["fine"]["rgb"].numpy(), atol=1e-5)
    assert torch.equal(drawn["fine"]["rgb"], want["fine"]["rgb"])      # the same generator, the same draws
    assert "weights" not in chunked["fine"]
    with pytest.raises(ValueError):
        renderer.bind(tnet, enc)(rays)                                  # no generator, no noise


def test_remat_features_needs_the_staged_pair():
    cfg = tr.RenderConfig(n_coarse=4)
    with pytest.raises(ValueError, match="staged"):
        tr.render_rays_chunked(lambda p, v, c: None, torch.zeros((1, 8, 8)), cfg, 4, remat="features",
                               generator=torch.Generator())


def test_full_renderer_baked_with_separate_fine_mlp_falls_back(pair):
    """A baked encoding holds one injection map per MLP. With a separate
    fine MLP the staged pair would feed the fine MLP the coarse MLP's
    injections, so FullRenderer renders it unstaged: the baked render equals
    the unbaked one and the JAX package's."""
    jnet, variables, tnet, jcfg, tcfg, enc_j, enc_t = _render_setup(pair)
    assert tnet.mlp_fine is not None
    baked_t = bake_encoding(tnet, enc_t)
    rays = novel_rays().reshape(8, 8, 8)
    n = 64
    rng = jax.random.PRNGKey(11)
    jfr = JaxFullRenderer(jnet, jcfg, ray_chunk=n, scan_chunk=n, staged=True)
    rgb_j, depth_j = jfr.render_image(variables, jax_bake_encoding(jnet, variables, enc_j), rays, rng)
    _, key = jax.random.split(rng)
    noise = [jax_draws(key, 1, n, jcfg)]
    fr = FullRenderer(tnet, tcfg, ray_chunk=n, staged=True)
    rgb_b, depth_b = fr.render_image(baked_t, t(rays), noise=noise)
    rgb_p, depth_p = fr.render_image(enc_t, t(rays), noise=noise)
    rgb_u, depth_u = FullRenderer(tnet, tcfg, ray_chunk=n, staged=False).render_image(enc_t, t(rays), noise=noise)
    # exact but for float32 reassociation (tests/test_full_renderer.py's tolerance)
    np.testing.assert_allclose(rgb_b.numpy(), rgb_p.numpy(), atol=2e-5, rtol=0)
    np.testing.assert_allclose(depth_b.numpy(), depth_p.numpy(), atol=2e-5, rtol=0)
    np.testing.assert_allclose(rgb_u.numpy(), rgb_p.numpy(), atol=2e-5, rtol=0)      # staged=False
    # the two encoders' ~1e-4 through the MLP and the compositing
    np.testing.assert_allclose(rgb_b.numpy(), rgb_j, atol=5e-4)
    np.testing.assert_allclose(depth_b.numpy(), depth_j, atol=5e-4)
    for rgb in (rgb_b.numpy(), rgb_p.numpy(), rgb_j):
        assert float(np.std(rgb)) > 1e-3
    # the trap itself: the staged pair on the baked encoding is wrong
    with torch.no_grad():
        trap = tr.render_rays(_stages(tnet, baked_t), t(rays).reshape(1, n, 8), tcfg, noise=noise[0])
    assert float((trap["fine"]["rgb"][0].reshape(8, 8, 3) - rgb_p).abs().max()) > 1e-3


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_study_plain_matches_einsum_and_jax(dtype):
    """The study's plain version at the probe's shapes against the probe's
    einsum reference and the Pallas weighted 4-row gather in interpret mode
    (the study's own Pallas bodies take no interpret argument)."""
    R, C, N = 256, 512, 512
    rng = np.random.default_rng(0)
    table = t(rng.normal(size=(R, C)).astype(np.float32), getattr(torch, dtype))
    idx = rng.integers(0, R, (N, 4)).astype(np.int32)
    w = rng.uniform(0, 1, (N, 4)).astype(np.float32)
    tab32 = table.float().numpy()
    ref = np.einsum("nk,nkc->nc", w, tab32[idx])
    out = gather_study_plain(table, torch.from_numpy(idx), torch.from_numpy(w))
    assert out.dtype == torch.float32
    # float32 sums of 4 products of the same table values, in another order
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)
    jout = jgp.gather_rows_lerp(jnp.asarray(tab32).astype(getattr(jnp, dtype)), jnp.asarray(idx), jnp.asarray(w),
                                out_dtype=jnp.float32, interpret=True)
    np.testing.assert_allclose(out.numpy(), _np(jout), atol=1e-6)


@pytest.mark.parametrize("formulation", sorted(FORMULATIONS))
def test_gather_study_wrapper_on_cpu_runs_plain_without_launch(formulation):
    g = torch.Generator().manual_seed(0)
    table = torch.randn((64, 16), generator=g)
    idx = torch.randint(0, 64, (50, 4), generator=g, dtype=torch.int32)
    w = torch.rand((50, 4), generator=g)
    before = dict(gather_study.launches)
    out = gather_study(table, idx, w, formulation, tile=16)
    assert gather_study.launches == before
    assert torch.equal(out, gather_study_plain(table, idx, w))


@pytest.mark.parametrize("case", ["formulation", "tile", "idx_int64", "w_f64", "table_f16", "channels", "idx_shape"])
def test_gather_study_wrapper_rejects_bad_inputs(case):
    table = torch.zeros((64, 16))
    idx = torch.zeros((5, 4), dtype=torch.int32)
    w = torch.zeros((5, 4))
    formulation, tile = "block_stage", 128
    if case == "formulation":
        formulation = "k_take"
    elif case == "tile":
        tile = 0
    elif case == "idx_int64":
        idx = idx.long()
    elif case == "w_f64":
        w = w.double()
    elif case == "table_f16":
        table = table.half()
    elif case == "channels":
        table = torch.zeros((64, 12))
    elif case == "idx_shape":
        idx = idx[:, :2]
    with pytest.raises((TypeError, ValueError)):
        gather_study(table, idx, w, formulation, tile)


def _field_args(n=7, c=16, dh=32, d_in=10):
    from test_torch_kernels import _mlp_weights

    table = torch.zeros((16, c), dtype=torch.bfloat16)
    base = torch.zeros((n, 2), dtype=torch.int32)
    wg = torch.zeros((n, 2))
    x = torch.zeros((n, d_in), dtype=torch.bfloat16)
    return [table, base, wg, x, _mlp_weights(dh=dh, d_in=d_in, d_z=c), 3, 2, 4]


@pytest.mark.parametrize(
    "case", ["table_f32", "base_int64", "wg_f64", "x_f32", "x_rows", "width", "nine_weights", "wz_shape"]
)
def test_fused_field_wrapper_rejects_bad_inputs(case):
    args = _field_args()
    if case == "table_f32":
        args[0] = args[0].float()
    elif case == "base_int64":
        args[1] = args[1].long()
    elif case == "wg_f64":
        args[2] = args[2].double()
    elif case == "x_f32":
        args[3] = args[3].float()
    elif case == "x_rows":
        args[3] = args[3][:5]
    elif case == "width":
        args[7] = 5
    elif case == "nine_weights":
        args[4] = args[4][:9]
    elif case == "wz_shape":
        args[4] = args[4][:2] + (args[4][2][:, :8],) + args[4][3:]
    before = fused_gather_resnetfc_infer.launches
    with pytest.raises((TypeError, ValueError)):
        fused_gather_resnetfc_infer(*args)
    assert fused_gather_resnetfc_infer.launches == before
    assert fused_gather_resnetfc_infer(*_field_args()).shape == (7, 4)       # the untouched arguments pass


@pytest.mark.parametrize("case", ["tz_width", "tz_given_as_latent", "wz_none_without_flag"])
def test_fused_mlp_tz_wrapper_checks(case):
    from test_torch_kernels import _mlp_weights

    weights = _mlp_weights()                     # dh 32, d_z 16, 3 blocks, 2 injections
    x = torch.zeros((7, 10), dtype=torch.bfloat16)
    tz = torch.zeros((7, 64), dtype=torch.bfloat16)
    no_wz = weights[:2] + (None, None) + weights[4:]
    assert fused_resnetfc_infer(tz, x, no_wz, 3, 2, z_is_tz=True).shape == (7, 4)
    with pytest.raises((TypeError, ValueError)):
        if case == "tz_width":
            fused_resnetfc_infer(tz[:, :48], x, no_wz, 3, 2, z_is_tz=True)
        elif case == "tz_given_as_latent":
            fused_resnetfc_infer(tz, x, weights, 3, 2)               # 64 wide against wz's 16
        elif case == "wz_none_without_flag":
            fused_resnetfc_infer(tz[:, :16], x, no_wz, 3, 2)


def test_build_key_follows_included_headers(tmp_path, monkeypatch):
    """A kernel is rebuilt when a header it includes changes: the library's
    name hashes the source and every header reached from it."""
    (tmp_path / "k.cu").write_text('#include "a.cuh"\n#include <cuda_runtime.h>\nint k;\n')
    (tmp_path / "a.cuh").write_text('  #  include "b.cuh"\nint a;\n')
    (tmp_path / "b.cuh").write_text("int b;\n")
    (tmp_path / "other.cuh").write_text("int o;\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    assert [p.name for p in _build.sources_of("k")] == ["k.cu", "a.cuh", "b.cuh"]
    first = _build._target("k")
    (tmp_path / "other.cuh").write_text("int o2;\n")
    assert _build._target("k") == first            # not included: no rebuild
    (tmp_path / "b.cuh").write_text("int b2;\n")
    assert _build._target("k") != first
    # the real sources: the lerp and the MLP chain have one definition each
    monkeypatch.undo()
    names = {n: [p.name for p in _build.sources_of(n)] for n in ("gather", "fused_mlp", "fused_field")}
    assert "gather_common.cuh" in names["gather"] and "gather_common.cuh" in names["fused_field"]
    assert "mlp_body.cuh" in names["fused_mlp"] and "mlp_body.cuh" in names["fused_field"]


def test_ptxas_entries_reads_registers_and_spills():
    log = (
        "ptxas info    : Compiling entry function '_Z1aIfEvv' for 'sm_90a'\\n"
        "ptxas info    : Function properties for _Z1aIfEvv\\n"
        "    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads\\n"
        "ptxas info    : Used 40 registers, 400 bytes cmem[0]\\n"
        "ptxas info    : Compiling entry function '_Z1bv' for 'sm_90a'\\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\\n"
        "ptxas info    : Used 136 registers\\n"
    ).replace("\\n", "\n")
    assert _build.ptxas_entries(log) == {
        "_Z1aIfEvv": {"spill_stores": 8, "spill_loads": 4, "registers": 40},
        "_Z1bv": {"spill_stores": 0, "spill_loads": 0, "registers": 136},
    }
