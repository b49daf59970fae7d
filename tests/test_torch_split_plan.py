"""The split plans of the 1-NN scans K1 and K5 (`ops.knn.nn_split_plan`,
`ops.banded_nn.banded_split_plan`), and the split-and-merge rule itself,
on the CPU.

A plan cuts a window of references into contiguous slices, one scan block
each; the merge takes the least (distance bits, index) key over the
slices. The plans are pinned at the main paths' shapes, and the rule is
replayed here in PyTorch with the kernels' own staging (K1: a masked
reference at +inf; K5: none found is (kBig, -1)) against the plain twins.
"""
import importlib

import numpy as np
import pytest
import torch

from aicp_mapping_tpu_torch.ops import banded_nn
from aicp_mapping_tpu_torch.registration.icp import banded_band

knn = importlib.import_module("aicp_mapping_tpu_torch.ops.knn")
BIG = 3.4e38

# (M, N) -> (queries per thread, splits, split_len): K1 against the whole
# reference (the frame path's fine and coarse ICP phases, the Hausdorff
# check), K5 against its auto band (localization's fine and coarse phases
# on both crops, `register`) and at the NN API's band 64.
K1_PLANS = {
    (8192, 8192): (4, 33, 252),
    (1024, 8192): (4, 64, 128),
    (65536, 65536): (4, 5, 13108),
    (8192, 65536): (4, 33, 1988),
    (1024, 65536): (4, 261, 252),
    (8192, 131072): (4, 33, 3972),
    (1024, 131072): (4, 263, 500),
}
K5_PLANS = {
    (8192, 8192, 8): (4, 33, 252),
    (1024, 8192, 8): (4, 64, 128),
    (8192, 65536, 16): (4, 33, 500),
    (1024, 65536, 64): (4, 261, 252),
    (8192, 131072, 32): (4, 33, 996),
    (1024, 131072, 128): (4, 263, 500),
    (8192, 65536, 64): (4, 33, 1988),
}


def _slices(plan, width):
    return [(s * plan.split_len, min(width, (s + 1) * plan.split_len))
            for s in range(plan.splits)]


def _assert_covers(plan, width, query_blocks):
    """Every reference of the window in exactly one slice, in order; no
    slice empty; every slice 16-byte aligned for (N, 3) f32 rows and (N,)
    penalties; and as many slices as give every SM 4 blocks, but none
    shorter than MIN_SPLIT: split_len is that many slices' length rounded
    up to a multiple of 4."""
    sl = _slices(plan, width)
    assert sl[0][0] == 0 and sl[-1][1] == width
    assert all(a < b for a, b in sl)
    assert all(b == c for (_, b), (c, _) in zip(sl, sl[1:]))
    assert plan.split_len % 4 == 0
    assert all(12 * a % 16 == 0 and 4 * a % 16 == 0 for a, _ in sl)
    want = max(1, min(-(-knn.SMS * knn.BLOCKS_PER_SM // query_blocks),
                      width // knn.MIN_SPLIT))
    assert (plan.split_len - 4) * want < width <= plan.split_len * want


@pytest.mark.parametrize("M,N", sorted(K1_PLANS))
def test_nn_split_plan_at_main_path_shapes(M, N):
    plan = knn.nn_split_plan(M, N)
    assert tuple(plan) == K1_PLANS[(M, N)]
    _assert_covers(plan, N, -(-M // (knn.THREADS * plan.queries_per_thread)))
    knn.nn_split_plan.cache_clear()
    assert knn.nn_split_plan(M, N) == plan        # deterministic


@pytest.mark.parametrize("M,N,band", sorted(K5_PLANS))
def test_banded_split_plan_at_main_path_shapes(M, N, band):
    if band < 64 or N // M > 64:
        assert band == banded_band(M, N)          # the ICP's own band
    plan = banded_nn.banded_split_plan(M, band)
    assert tuple(plan) == K5_PLANS[(M, N, band)]
    qb = M // (knn.THREADS * plan.queries_per_thread)
    _assert_covers(plan, band * 1024, qb)
    banded_nn.banded_split_plan.cache_clear()
    assert banded_nn.banded_split_plan(M, band) == plan


@pytest.mark.parametrize("M,N", [(1, 1), (1000, 1777), (513, 129),
                                 (77, 5001), (0, 8)])
def test_nn_split_plan_on_ragged_shapes(M, N):
    plan = knn.nn_split_plan(M, N)
    assert plan.splits * plan.split_len >= N > (plan.splits - 1) \
        * plan.split_len
    _assert_covers(plan, N, max(1, -(-M // 512)))


@pytest.mark.parametrize("tm,qpt", [(512, 4), (1024, 4), (256, 2),
                                    (384, 1), (128, 1)])
def test_banded_split_plan_keeps_a_block_in_one_tile(tm, qpt):
    """A block of 128 x queries_per_thread queries must share one window:
    it lies inside one query tile of `tm`."""
    plan = banded_nn.banded_split_plan(4 * tm, 4, tm=tm, tn=1024)
    assert plan.queries_per_thread == qpt
    assert tm % (knn.THREADS * qpt) == 0


def _grid_points(rng, n):
    return torch.as_tensor(rng.integers(0, 6, (n, 3)).astype(np.float32))


def _key(d, j):
    """The kernels' 64-bit key: distance bits above the index bits."""
    return (d.view(torch.int32).to(torch.int64) << 32) | (j & 0xFFFFFFFF)


def _split_scan(q, r, masked, plan, width, k1):
    """The kernels' rule, replayed: each slice's first minimum as a key
    (K1 stages a masked reference at +inf and starts from (+inf, slice
    start); K5 sees +inf for a masked one and starts from (kBig, -1)), the
    least key over the slices, then K1's +inf -> kBig."""
    keys = []
    for a, b in _slices(plan, width):
        d = knn.sq_dists(q, r[a:b])
        d = torch.where(masked[None, a:b], float("inf"), d)
        init = torch.full((q.shape[0], 1), float("inf") if k1 else BIG)
        best, j = torch.min(torch.cat([init, d], 1), dim=1)
        j = torch.where(j == 0, a if k1 else -1, j - 1 + a)
        keys.append(_key(best, j))
    key = torch.stack(keys).amin(0)
    d = (key >> 32).to(torch.int32).view(torch.float32)
    j = (key & 0xFFFFFFFF).to(torch.int32).to(torch.int64)
    return torch.where(torch.isinf(d), BIG, d) if k1 else d, j


@pytest.mark.parametrize("M,N,share", [(1024, 8192, 0.3), (513, 1777, 0.0),
                                       (300, 1000, 1.0)])
def test_split_merge_gives_the_first_minimum_k1(M, N, share):
    """K1's rule against `nn_argmin` on integer-grid points (many exact
    ties, within and across slices), with a share of masked references
    (all of them in the last case: kBig and index 0)."""
    rng = np.random.default_rng(N)
    q, r = _grid_points(rng, M), _grid_points(rng, N)
    rmask = torch.as_tensor(rng.random(N) >= share)
    rmask[:knn.nn_split_plan(M, N).split_len] &= share >= 1.0
    plan = knn.nn_split_plan(M, N)
    assert plan.splits > 1
    d, j = _split_scan(q, r, ~rmask, plan, N, k1=True)
    qm = torch.ones(M, dtype=torch.bool)
    dw, jw = knn.nn_argmin(q, qm, r, rmask)
    assert torch.equal(d, dw) and torch.equal(j, jw)


@pytest.mark.parametrize("M,band,dead", [(1024, 8, False), (1024, 4, True)])
def test_split_merge_gives_the_first_minimum_k5(M, band, dead):
    """K5's rule against `banded_nn_argmin` on one window (starts 0) of
    integer-grid points, the first slice masked, or every reference
    (-1 and kBig)."""
    rng = np.random.default_rng(band)
    N = band * 1024
    q, rs = _grid_points(rng, M), _grid_points(rng, N)
    plan = banded_nn.banded_split_plan(M, band)
    masked = torch.zeros(N, dtype=torch.bool)
    masked[:plan.split_len] = True
    if dead:
        masked[:] = True
    rpen = torch.where(masked, BIG, 0.0)
    d, j = _split_scan(q, rs, masked, plan, N, k1=False)
    starts = torch.zeros(M // 512, dtype=torch.int32)
    dw, jw = banded_nn.banded_nn_argmin(q, rs, rpen, starts, band)
    assert torch.equal(d, dw) and torch.equal(j, jw)
    assert bool((j == -1).all()) == dead
