"""Kernel E's binning (``block_stage`` of ``csrc/gather_study.cu``) in its
plain mirror, on the CPU: the permutation, the bin offsets and which points
the slab serves, on bilinear rows of a map built as the study's bench
builds its inputs and on the probe's random rows; the slab reduction in
that order against the plain version (bit for bit) and the Pallas
weighted 4-row gather in interpret mode; the widths the wrapper refuses."""
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixelnerf_tpu.ops import gather_pallas as jgp
from pixelnerf_tpu_torch.ops.gather_study import (
    HIST_BINS,
    MIN_SLAB_ROWS,
    block_stage_plain,
    block_stage_plan,
    block_stage_plan_plain,
    block_stage_served,
    gather_study,
    gather_study_plain,
    slab_rows,
)

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts"))
import bench_gather_torch as bench  # noqa: E402

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _assert_plan(plan, idx, rows, c, size):
    """A permutation grouped by bin of the lowest tap row, ascending
    within a bin; offsets that cut it there."""
    n = idx.shape[0]
    perm = plan.perm.to(torch.int64)
    offsets = plan.offsets.to(torch.int64)
    assert plan.perm.dtype == torch.int32 and plan.offsets.dtype == torch.int32
    assert torch.equal(torch.sort(perm).values, torch.arange(n))      # each point once
    assert offsets[0] == 0 and offsets[-1] == n and bool((offsets[1:] >= offsets[:-1]).all())
    assert offsets.shape[0] - 1 == -(-rows // plan.step) <= HIST_BINS
    assert plan.step >= max(slab_rows(c, size) // 8, 1, -(-rows // HIST_BINS))
    bins = idx.to(torch.int64).min(1).values // plan.step
    for b in range(offsets.shape[0] - 1):
        points = perm[offsets[b]:offsets[b + 1]]
        assert bool((bins[points] == b).all())
        assert bool((points[1:] > points[:-1]).all())                 # stable


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("c", [32, 512])
def test_block_stage_mirror_on_bilinear_rows(c, dtype):
    """A 16x16 map's bilinear taps (span W + 1 = 17 rows): every point is
    served from its bin's slab; 1000 points, off every tile. At 32
    channels one slab holds the map; at 512, 96 float32 rows (4 bins of
    79) or 192 bf16 rows (2 bins of 175)."""
    feats, _, idx, w = bench.inputs("cpu", 16, 16, c, 1000)
    table = feats[0].reshape(256, c).to(DTYPES[dtype])
    size = table.element_size()
    plan = block_stage_plan(table, idx)
    _assert_plan(plan, idx, 256, c, size)
    assert plan.step == slab_rows(c, size) - 17
    assert plan.offsets.shape[0] - 1 == -(-256 // plan.step)
    assert bool(block_stage_served(idx, plan, c, size).all())
    out = block_stage_plain(table, idx, w, plan)
    assert torch.equal(out, gather_study_plain(table, idx, w))
    assert torch.equal(gather_study(table, idx, w, "block_stage"), out)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_block_stage_mirror_on_the_probes_random_rows_matches_pallas(dtype):
    """The probe's shape (a 256 x 512 table, 512 points of 4 random taps):
    no span leaves room, so the bins are S rows wide and a point whose taps
    leave its slab is reduced from the table."""
    R, C, N = 256, 512, 512
    rng = np.random.default_rng(0)
    table = torch.from_numpy(rng.normal(size=(R, C)).astype(np.float32)).to(DTYPES[dtype])
    idx = rng.integers(0, R, (N, 4)).astype(np.int32)
    w = rng.uniform(0, 1, (N, 4)).astype(np.float32)
    tidx, tw = torch.from_numpy(idx), torch.from_numpy(w)
    size = table.element_size()
    plan = block_stage_plan(table, tidx)
    _assert_plan(plan, tidx, R, C, size)
    assert plan.step == slab_rows(C, size)
    served = block_stage_served(tidx, plan, C, size)
    assert 0 < int(served.sum()) < N
    out = block_stage_plain(table, tidx, tw, plan)
    assert torch.equal(out, gather_study_plain(table, tidx, tw))
    jout = jgp.gather_rows_lerp(jnp.asarray(table.float().numpy()).astype(getattr(jnp, dtype)), jnp.asarray(idx),
                                jnp.asarray(w), out_dtype=jnp.float32, interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-6)


@pytest.mark.parametrize("rows, span, step", [
    (4096, 65, 31),        # the bench's 64-wide map at float32
    (4096, 90, 96),        # too wide: bins of S rows
    (100_000, 1, 95),      # many rows, a narrow span
    (100_000, 65, 96),     # many rows: no bin under ceil(rows / HIST_BINS) = 49 rows
    (10_000_000, 1, 4883),  # bins wider than the slab
])
def test_block_stage_step_and_bins(rows, span, step):
    """The bins' width at 512 float32 channels (S = 96) and at most
    HIST_BINS bins, from rows with the given tap span."""
    lo = torch.arange(0, rows - span, max(1, (rows - span) // 700), dtype=torch.int32)
    idx = torch.stack([lo, lo + 1, lo + span, lo], 1).contiguous()
    plan = block_stage_plan_plain(idx, rows, 512, 4)
    assert plan.step == step
    _assert_plan(plan, idx, rows, 512, 4)
    assert bool(block_stage_served(idx, plan, 512, 4).all()) == (span <= slab_rows(512, 4) - step)


def test_block_stage_rejects_a_width_whose_slab_does_not_fit():
    """Fewer than MIN_SLAB_ROWS float32 rows of 6152 channels fit the slab
    (bf16 rows do); the other formulations take that width, and
    thread_global_idx and thread_smem_idx more than their block's 128
    groups of 8 channels."""
    c = 6152
    assert slab_rows(c, 4) < MIN_SLAB_ROWS <= slab_rows(c, 2)
    idx = torch.zeros((3, 4), dtype=torch.int32)
    w = torch.zeros((3, 4))
    table = torch.zeros((16, c))
    with pytest.raises(ValueError, match="slab"):
        gather_study(table, idx, w, "block_stage")
    with pytest.raises(ValueError, match="slab"):
        block_stage_plan(table, idx)
    assert torch.equal(gather_study(table.bfloat16(), idx, w, "block_stage"), torch.zeros((3, c)))
    assert torch.equal(gather_study(table, idx, w, "warp_direct"), torch.zeros((3, c)))
    for formulation in ("thread_global_idx", "thread_smem_idx"):
        for width in (1024, 1032, c):
            assert torch.equal(gather_study(torch.zeros((16, width)), idx, w, formulation), torch.zeros((3, width)))
