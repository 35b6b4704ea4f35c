"""The port's ops against the JAX package's on the CPU: grid_sample in every
mode, the latent lookup, the resize, and the plain version of the gather kernel
against the Pallas kernel run in interpret mode. The kernel wrappers
themselves are tested in ``test_torch_kernels.py``."""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixelnerf_tpu.models.encoder import index_latent as jax_index_latent
from pixelnerf_tpu.models.encoder import latent_scaling as jax_latent_scaling
from pixelnerf_tpu.ops.gather_pallas import (
    bilinear_pair_bases as jax_pair_bases,
    gather_packed_lerp,
    pack_lr_table,
)
from pixelnerf_tpu.ops.resize import resize_bilinear as jax_resize
from pixelnerf_tpu_torch.models.encoder import index_latent, latent_scaling
from pixelnerf_tpu_torch.ops import grid_sample as tgs
from pixelnerf_tpu_torch.ops.gather import gather_bilerp_plain
from pixelnerf_tpu_torch.ops.resize import resize_bilinear

# the JAX package's ops/__init__ re-exports a function under the module's name
jgs = importlib.import_module("pixelnerf_tpu.ops.grid_sample")


def _np(x):
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("align_corners", [True, False])
@pytest.mark.parametrize("padding", ["border", "zeros", "reflection"])
@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
def test_grid_sample_matches_jax(mode, padding, align_corners):
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(2, 9, 11, 8)).astype(np.float32)
    grid = rng.uniform(-1.3, 1.3, (2, 50, 2)).astype(np.float32)
    ref = jgs.grid_sample(jnp.asarray(feats), jnp.asarray(grid), mode, padding, align_corners)
    out = tgs.grid_sample(torch.from_numpy(feats), torch.from_numpy(grid), mode, padding, align_corners)
    # the same float32 arithmetic; pixel coordinates of order 10 carry ulps
    # of ~1e-6 where XLA fuses or reorders (reflection's remainder), and the
    # features vary by O(1) per pixel
    np.testing.assert_allclose(out.numpy(), _np(ref), atol=1e-5)


def test_grid_sample_one_map_many_point_sets():
    rng = np.random.default_rng(1)
    feats = rng.normal(size=(1, 6, 7, 8)).astype(np.float32)
    grid = rng.uniform(-1, 1, (3, 20, 2)).astype(np.float32)
    ref = jgs.grid_sample(jnp.asarray(feats), jnp.asarray(grid))
    out = tgs.grid_sample(torch.from_numpy(feats), torch.from_numpy(grid))
    np.testing.assert_allclose(out.numpy(), _np(ref), atol=1e-6)


def test_resize_bilinear_matches_jax():
    x = np.random.default_rng(2).normal(size=(2, 5, 7, 3)).astype(np.float32)
    ref = jax_resize(jnp.asarray(x), 16, 12, align_corners=True)
    out = resize_bilinear(torch.from_numpy(x), 16, 12, align_corners=True)
    # both are float32 contractions with the same matrices
    np.testing.assert_allclose(out.numpy(), _np(ref), atol=1e-5)


def test_latent_scaling_matches_jax():
    np.testing.assert_allclose(latent_scaling(16, 24).numpy(), _np(jax_latent_scaling(16, 24)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_index_latent_matches_jax(dtype):
    """Two views folded into one flat table; the port's bilinear/border
    lookup goes through the gather wrapper (its plain version on the CPU)."""
    rng = np.random.default_rng(3)
    lat = rng.normal(size=(2, 16, 16, 24)).astype(np.float32)
    uv = rng.uniform(-8, 70, (2, 100, 2)).astype(np.float32)
    shape = np.array([64.0, 64.0], np.float32)
    jdt = getattr(jnp, dtype)
    ref = jax_index_latent(jnp.asarray(lat).astype(jdt), jnp.asarray(uv), jnp.asarray(shape))
    tdt = getattr(torch, dtype)
    out = index_latent(
        torch.from_numpy(lat).to(tdt), torch.from_numpy(uv), torch.from_numpy(shape),
        out_dtype=torch.float32,
    )
    # the JAX lerp is v00*(1-wx)+v01*wx, the kernel's l0+wx*(r0-l0): equal
    # up to float32 rounding of values of order 1
    np.testing.assert_allclose(out.numpy(), _np(ref), atol=2e-6)


def test_index_latent_other_modes_use_grid_sample():
    rng = np.random.default_rng(4)
    lat = rng.normal(size=(1, 8, 8, 8)).astype(np.float32)
    uv = rng.uniform(-4, 36, (1, 30, 2)).astype(np.float32)
    shape = np.array([32.0, 32.0], np.float32)
    ref = jax_index_latent(jnp.asarray(lat), jnp.asarray(uv), jnp.asarray(shape), "nearest", "zeros")
    out = index_latent(torch.from_numpy(lat), torch.from_numpy(uv), torch.from_numpy(shape), "nearest", "zeros")
    np.testing.assert_allclose(out.numpy(), _np(ref), atol=1e-6)


def _pair_inputs(hh=16, ww=16, c=128, p=300, seed=0):
    rng = np.random.default_rng(seed)
    grid = rng.uniform(-1.2, 1.2, (p, 2)).astype(np.float32)
    feats = rng.normal(size=(hh, ww, c)).astype(np.float32)
    return feats, grid


def test_bilinear_pair_bases_matches_jax():
    feats, grid = _pair_inputs()
    hh, ww = feats.shape[:2]
    jix = jgs._compute_source_index(jnp.asarray(grid[:, 0]), ww, "border", True)
    jiy = jgs._compute_source_index(jnp.asarray(grid[:, 1]), hh, "border", True)
    jb, jw = jax_pair_bases(jix, jiy, hh, ww)
    tix = tgs._compute_source_index(torch.from_numpy(grid[:, 0]), ww, "border", True)
    tiy = tgs._compute_source_index(torch.from_numpy(grid[:, 1]), hh, "border", True)
    tb, tw = tgs.bilinear_pair_bases(tix, tiy, hh, ww)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-6)


@pytest.mark.parametrize("c", [8, 64, 128, 512])
def test_gather_plain_matches_pallas_interpret(c):
    """Kernel A's plain version against gather_packed_lerp in interpret
    mode: the same bf16 rows, the same float32 lerp order, at widths from
    one 16-byte piece a row (8 channels) to the SRN latent's 512."""
    feats, grid = _pair_inputs(c=c)
    hh, ww, c = feats.shape
    ix = jgs._compute_source_index(jnp.asarray(grid[:, 0]), ww, "border", True)
    iy = jgs._compute_source_index(jnp.asarray(grid[:, 1]), hh, "border", True)
    base, w = jax_pair_bases(ix, iy, hh, ww)
    f16 = jnp.asarray(feats).astype(jnp.bfloat16)
    ref = gather_packed_lerp(pack_lr_table(f16), base, w, interpret=True)
    table = torch.from_numpy(feats).to(torch.bfloat16).reshape(hh * ww, c)
    out = gather_bilerp_plain(
        table, torch.from_numpy(np.array(base)), torch.from_numpy(np.array(w)), ww
    )
    np.testing.assert_allclose(out.numpy(), _np(ref), atol=1e-6)
