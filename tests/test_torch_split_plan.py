"""The split plans of the scans (`ops.knn.nn_split_plan` for K1 and K3,
`ops.banded_nn.banded_split_plan` for K5 and K2), and the split-and-merge
rules themselves, on the CPU.

A 1-NN plan cuts a window of references into contiguous slices, one scan
block each, and the merge takes the least (distance bits, index) key over
the slices; a moments plan deals the window to its blocks in pieces of 16
references, round-robin, and the merge adds the blocks' f64 partial sums
in block order. The plans are pinned at the main paths' shapes, and the rules are
replayed here in PyTorch with the kernels' own staging (K1: a masked
reference at +inf; K5: none found is (kBig, -1)) against the plain twins.
"""
import importlib

import numpy as np
import pytest
import torch

from aicp_mapping_tpu_torch.ops import banded_nn, normals
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
    # the KITTI widths (eval/kitti_runner.py): fine ICP at 16,384^2 and the
    # coarse phase's 2,048 x 16,384
    (16384, 16384): (4, 17, 964),
    (2048, 16384): (4, 128, 128),
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

# (kind, N, tm) -> (queries per thread, splits, references per block) of
# the moments scans' plan: K2 (a tile tm, band 8 of 1024-point blocks) on the
# prefilter's 16,384 points and the map's 262,144, and at tm = 256; K3 (the
# whole cloud, tm None) at the golden scenario's 4,096, at 8,192 and
# ragged.
MOMENTS_PLANS = {
    ("K2", 16384, 512): (4, 16, 512),
    ("K2", 262144, 512): (4, 1, 8192),
    ("K2", 32768, 512): (4, 8, 1024),      # the KITTI prefilter's voxels
    ("K2", 16384, 256): (2, 8, 1024),
    ("K3", 4096, None): (4, 32, 128),
    ("K3", 8192, None): (4, 32, 256),
    ("K3", 1000, None): (4, 7, 144),
}
L2_BYTES = 50 * 2**20


def _moments_plan(kind, N, tm):
    width = 8 * 1024 if kind == "K2" else N
    return normals.moments_split_plan(N, width, tm), width


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


# (kind, M or N) -> the grid's blocks (query blocks x splits) at the KITTI
# widths: one wave is 132 SMs x 4 blocks = 528
KITTI_GRIDS = {("K1", 16384, 16384): 32 * 17, ("K1", 2048, 16384): 4 * 128,
               ("K2", 32768, 32768): 64 * 8}


@pytest.mark.parametrize("kind,M,N", sorted(KITTI_GRIDS))
def test_kitti_widths_fill_one_wave(kind, M, N):
    """At the KITTI widths each scan's grid is one wave of the card: K1's
    rounds its slices up to a whole wave (or stops at MIN_SPLIT-reference
    slices), K2's stays within one."""
    wave = knn.SMS * knn.BLOCKS_PER_SM
    if kind == "K1":
        plan = knn.nn_split_plan(M, N)
        width = N
    else:
        plan, width = _moments_plan("K2", N, 512)
    blocks = -(-M // (knn.THREADS * plan.queries_per_thread))
    assert blocks * plan.splits == KITTI_GRIDS[(kind, M, N)]
    assert 0.96 * wave <= blocks * plan.splits <= 1.04 * wave
    if kind == "K1":
        assert (blocks * plan.splits >= wave
                or plan.split_len == knn.MIN_SPLIT)
    else:
        assert blocks * plan.splits <= wave
        # every reference of the 8-block window in exactly one block
        refs = _pieces(plan, width)
        assert torch.equal(torch.sort(torch.cat(refs)).values,
                           torch.arange(width))


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


def _pieces(plan, width):
    """The references block s of a moments plan scans, in its order: pieces
    s, s + splits, ... of MOMENTS_PIECE references."""
    P = normals.MOMENTS_PIECE
    pieces = -(-width // P)
    return [torch.cat([torch.arange(g * P, min(width, (g + 1) * P))
                       for g in range(s, pieces, plan.splits)])
            for s in range(plan.splits)]


@pytest.mark.parametrize("kind,N,tm", list(MOMENTS_PLANS))
def test_moments_split_plan_at_main_path_shapes(kind, N, tm):
    """K2's and K3's plan, pinned at their shapes: every reference of the
    window in exactly one block, no block with more than split_len (a
    multiple of 16) or fewer than MIN_SPLIT of them (unless it is the only
    one); as many blocks as fit the grid into one wave of 4 blocks per SM,
    less what dealing whole pieces leaves empty (no more, unlike the 1-NN
    plans); a K2 block inside one query tile (2
    queries per thread at tm = 256); the (splits, N, 10) f64 scratch of
    partial sums inside the 50 MB L2."""
    plan, width = _moments_plan(kind, N, tm)
    assert tuple(plan) == MOMENTS_PLANS[(kind, N, tm)]
    refs = _pieces(plan, width)
    assert torch.equal(torch.sort(torch.cat(refs)).values,
                       torch.arange(width))
    assert plan.split_len % normals.MOMENTS_PIECE == 0
    assert max(len(r) for r in refs) == plan.split_len
    assert plan.splits == 1 or min(len(r) for r in refs) >= knn.MIN_SPLIT
    blocks = -(-N // (knn.THREADS * plan.queries_per_thread))
    wave = knn.SMS * knn.BLOCKS_PER_SM
    want = max(1, min(wave // blocks, width // knn.MIN_SPLIT))
    pieces = -(-width // normals.MOMENTS_PIECE)
    per_block = -(-pieces // want)
    assert plan.split_len == per_block * normals.MOMENTS_PIECE
    assert blocks * plan.splits <= max(wave, blocks)
    if kind == "K2":
        assert tm % (knn.THREADS * plan.queries_per_thread) == 0
    assert plan.splits * N * 10 * 8 <= L2_BYTES
    normals.moments_split_plan.cache_clear()
    assert normals.moments_split_plan(N, width, tm) == plan


def _split_moments(p, m, plan, window_of, width, radius):
    """The moments rule, replayed: each block's f64 partial sums of the
    valid neighbours' features among its pieces of the window
    (`window_of`: per query tile, its window start and its queries), the
    blocks added in block order, rounded to f32 once."""
    F = normals._features(p, m)
    rad2 = normals._rad2(radius)
    total = None
    for refs in _pieces(plan, width):
        rows = []
        for lo, q in window_of:
            j = lo + refs
            rows.append(normals._window_moments(q, p[j], m[j], F[j], rad2))
        part = torch.cat(rows)
        total = part if total is None else total + part
    return total.float()


@pytest.mark.parametrize("kind,N,tm", [("K3", 1000, None),
                                       ("K3", 4096, None),
                                       ("K2", 16384, 256)])
def test_split_merge_gives_the_moments(kind, N, tm):
    """The moments rule against the twins on integer-grid points (pairs
    exactly at the radius, coincident points) with the first pieces masked:
    counts equal, every value within 2 f32 ulps of the twin's, and nearly
    every row equal to the bit (both sum in f64 and round once)."""
    rng = np.random.default_rng(N)
    p = _grid_points(rng, N)
    m = torch.as_tensor(rng.random(N) > 0.1)
    plan, width = _moments_plan(kind, N, tm)
    m[:4 * normals.MOMENTS_PIECE] = False
    if kind == "K3":
        got = _split_moments(p, m, plan, [(0, p)], width, 2.0)
        want = normals.radius_moments(p, m, 2.0)
    else:
        codes = banded_nn.morton_codes(p, m, p.amin(0), 2.0)
        cs, perm = torch.sort(codes, stable=True)
        p, m = p[perm].contiguous(), m[perm]
        starts = banded_nn.banded_window_starts(cs, cs, N // 1024, 8, tm,
                                                1024)
        tiles = [(s * 1024, p[g * tm:(g + 1) * tm])
                 for g, s in enumerate(starts.tolist())]
        got = _split_moments(p, m, plan, tiles, width, 2.0)
        want = normals.sorted_radius_moments(p, m, cs, 2.0, tm=tm)
    assert torch.equal(got[:, 9], want[:, 9])
    ulp = torch.abs(want).clamp(min=1e-30) * 2.0**-23
    assert bool(((got - want).abs() <= 2 * ulp).all())
    assert (got == want).all(1).float().mean().item() >= 0.99
