"""The port's CUDA kernels against their plain PyTorch twins.

The tests marked `cuda` need an NVIDIA GPU and skip without one. This file
imports neither JAX nor the JAX package, so on a machine with a card and
no JAX they run with

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py -q

(`--noconftest` because tests/conftest.py configures JAX). The unmarked
tests check the kernel library's bindings and run everywhere.
"""
import importlib
import re

import numpy as np
import pytest
import torch

from aicp_mapping_tpu_torch import _kernels
from aicp_mapping_tpu_torch.ops import banded_nn, normals, segmentation
from aicp_mapping_tpu_torch.ops.segmentation import moments_for
from aicp_mapping_tpu_torch.ops.voxel import voxel_downsample
from aicp_mapping_tpu_torch.tools.synthetic import room_cloud

torch.set_num_threads(1)
knn = importlib.import_module("aicp_mapping_tpu_torch.ops.knn")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    _kernels.library()
    return torch.device("cuda")


def _lidar_room(n, seed):
    """A synthetic room ~59 m from the origin, as a lidar sees it."""
    pts = room_cloud(n=n * 6 // 5 + 12, size=20.0, seed=seed,
                     noise=0.01)[:n]
    return (pts + np.float32([45.0, -38.0, 1.5])).astype(np.float32)


def _c_entry_points():
    pattern = re.compile(r'extern "C" int (\w+)\(([^)]*)\)', re.S)
    found = {}
    for src in _kernels.CSRC.glob("*.cu"):
        for name, params in pattern.findall(src.read_text()):
            found[name] = len([p for p in params.split(",") if p.strip()])
    return found


def test_bindings_match_the_c_entry_points():
    """Every C entry point in csrc/ has a ctypes signature with as many
    arguments, and nothing else is bound."""
    found = _c_entry_points()
    assert found.keys() == _kernels._SIGNATURES.keys()
    for name, argtypes in _kernels._SIGNATURES.items():
        assert found[name] == len(argtypes), name


def test_build_is_keyed_by_the_sources():
    h = _kernels.source_hash()
    assert h == _kernels.source_hash() and len(h) == 16
    assert {s.name for s in _kernels.sources()} >= {
        "nn_payload.cu", "moments.cu", "banded_nn.cu", "propagation.cu",
        "common.cuh"}
    assert "arch=compute_90a,code=sm_90a" in _kernels.NVCC_FLAGS


@pytest.mark.parametrize("n,k,mode", [
    (1000, 15, 0), (4096, 15, 0), (6282, 15, 0), (6283, 15, 1),
    (4096, 30, 1), (8192, 15, 1), (16384, 15, 1), (32768, 15, 1),
    (33205, 15, 1), (33206, 15, 2), (65536, 15, 2), (0, 15, 0)])
def test_propagation_plan(n, k, mode):
    """Label propagation's storage by n and k alone: all in shared memory
    up to 6,282 points of 15 neighbours (alignability's 4,096), the list
    in device memory up to 33,205 (the region-growing prefilter's 8,192-
    32,768), then all in device memory; never over a block's shared
    memory."""
    plan = segmentation.propagation_plan(n, k)
    assert plan.mode == mode
    assert plan.smem_bytes <= segmentation.PROPAGATION_SMEM
    list_bytes = (2 if mode < 2 else 4) * n * k
    assert (plan.smem_bytes if mode == 0 else plan.scratch_bytes) >= \
        list_bytes
    assert plan.scratch_bytes == 0 if mode == 0 else plan.scratch_bytes > 0
    assert plan.smem_bytes % 16 == 0 and plan.scratch_bytes % 16 == 0


def test_propagation_wrapper_on_the_cpu_runs_the_eager_loop():
    """On CPU tensors the kernel's wrapper is the eager loop: the same
    labels, one read span and one counted round a round, no launch; and
    it refuses what the kernel would not take."""
    from aicp_mapping_tpu_torch.utils import timing

    idx, pull_ok, mask = _cpu_graph(600, 550)
    segmentation.reset_propagation_rounds()
    want = segmentation.propagate_labels(idx, pull_ok, mask)
    rounds = segmentation.propagation_rounds()["rounds"]
    assert rounds >= 2
    before = _kernels.launch_counts()["label_propagation"]
    timing.reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        got = segmentation.propagate_labels_kernel(idx, pull_ok, mask)
    names = [s.name for s in timing.spans()]
    timing.reset()
    assert torch.equal(got, want)
    assert names == ["aicp.seg.propagation_read"] * rounds
    assert segmentation.propagation_rounds()["rounds"] == 2 * rounds
    assert _kernels.launch_counts()["label_propagation"] == before
    wide = torch.zeros((600, 30), dtype=torch.int64)
    wide[:, :15] = idx
    assert torch.equal(segmentation.propagate_labels_kernel(
        wide[:, :15], pull_ok, mask), want)
    with pytest.raises(ValueError):
        segmentation.propagate_labels_kernel(
            idx, pull_ok, torch.stack([mask, mask], 1)[:, 0])
    with pytest.raises(ValueError):
        segmentation.propagate_labels_kernel(idx[:599], pull_ok, mask)
    with pytest.raises(ValueError):
        segmentation.propagate_labels_kernel(
            torch.zeros((600, 128), dtype=torch.int64),
            torch.zeros((600, 128), dtype=torch.bool), mask)
    with pytest.raises(TypeError):
        segmentation.propagate_labels_kernel(idx, pull_ok.to(torch.uint8),
                                             mask)


def _cpu_graph(n, valid):
    p = torch.as_tensor(_lidar_room(n, 3))
    m = torch.arange(n) < valid
    _, idx = knn.knn(p, m, p, m, 15)
    nrm, curv, _ = normals.normals_from_neighbors(p, m, idx)
    return segmentation.smoothness_graph(p, m, nrm, curv, 15,
                                         neighbor_idx=idx) + (m,)


@pytest.mark.cuda
@pytest.mark.parametrize("M,N", [(8192, 8192), (1024, 8192), (1000, 1777),
                                 (16384, 16384), (2048, 16384)])
def test_nn_payload_kernel_matches_plain(cuda, M, N):
    """K1: >= 99.7% identical payload rows, |d2| within 3e-3 m^2."""
    q = torch.as_tensor(_lidar_room(M, 1), device=cuda)
    r = torch.as_tensor(_lidar_room(N, 2), device=cuda)
    qm = torch.arange(M, device=cuda) < M - M // 16
    rm = torch.arange(N, device=cuda) % 7 != 0
    pay = torch.cat([r, torch.ones((N, 5), device=cuda)], 1).contiguous()
    before = _kernels.launch_counts()["nn_payload"]
    d_k, p_k = knn.nn_payload_kernel(q, qm, r, rm, pay)
    d_p, p_p = knn.nn_payload(q, qm, r, rm, pay)
    torch.cuda.synchronize()
    assert _kernels.launch_counts()["nn_payload"] == before + 1
    assert (p_k == p_p).all(1)[qm].float().mean().item() >= 0.997
    assert (d_k - d_p)[qm].abs().max().item() <= 3e-3
    assert bool((d_k[~qm] == 3.4e38).all()) and bool((p_k[~qm] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("M,N", [(8192, 8192), (65536, 65536), (1000, 1777)])
def test_nn_argmin_kernel_matches_plain(cuda, M, N):
    """K1's index mode (Q2 #7): >= 99.7% identical indices, |d2| within
    3e-3 m^2, masked queries exactly (BIG, 0)."""
    q = torch.as_tensor(_lidar_room(M, 7), device=cuda)
    r = torch.as_tensor(_lidar_room(N, 8), device=cuda)
    qm = torch.arange(M, device=cuda) < M - M // 16
    rm = torch.arange(N, device=cuda) % 7 != 0
    before = _kernels.launch_counts()["nn_argmin"]
    d_k, i_k = knn.nn_argmin_kernel(q, qm, r, rm)
    d_p, i_p = knn.nn_argmin(q, qm, r, rm)
    torch.cuda.synchronize()
    assert _kernels.launch_counts()["nn_argmin"] == before + 1
    assert i_k.dtype == torch.int64
    assert (i_k == i_p)[qm].float().mean().item() >= 0.997
    assert (d_k - d_p)[qm].abs().max().item() <= 3e-3
    assert bool((d_k[~qm] == 3.4e38).all()) and bool((i_k[~qm] == 0).all())
    assert bool(rm[i_k[qm]].all())


def _assert_moments_agree(a, b):
    """K2 / K3 against their twins: the same neighbour count at every
    point (the radius test rounds as the twin's does), moments within rtol
    1e-4 / atol 1e-3 at every point (both sum in f64 and round once, so
    nearly every row is equal to the bit)."""
    assert torch.equal(a[:, 9], b[:, 9])
    torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-3)


def _launch_twice(fn, *args, **kw):
    """A kernel's result, after checking that a second launch gives the
    same bits (the merge adds the slices in a fixed order)."""
    got = fn(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, fn(*args, **kw))
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("N", [4096, 8192, 1000, 1777])
def test_radius_moments_kernel_matches_plain(cuda, N):
    """K3 on any N, ragged included: neighbour counts equal to the twin's
    at every point, moments within rtol 1e-4 / atol 1e-3 everywhere, and
    equal across two launches."""
    p = torch.as_tensor(_lidar_room(N, 3), device=cuda)
    m = torch.arange(N, device=cuda) < N - N // 16
    before = _kernels.launch_counts()["radius_moments"]
    got = _launch_twice(normals.radius_moments_kernel, p, m, 0.4)
    assert _kernels.launch_counts()["radius_moments"] == before + 2
    _assert_moments_agree(got, normals.radius_moments(p, m, 0.4))


@pytest.mark.cuda
@pytest.mark.parametrize("N", [16384, 32768])
def test_banded_moments_kernel_matches_plain(cuda, N):
    """K2 at the main path's 16,384 sorted points and the KITTI widths'
    32,768, via the prefilter's shape-based dispatch."""
    p = torch.as_tensor(_lidar_room(N, 4), device=cuda)
    m = torch.arange(N, device=cuda) < N - 384
    codes = banded_nn.morton_codes(p, m, p[m].amin(0), 2.0)
    cs, perm = torch.sort(codes, stable=True)
    args = (p[perm].contiguous(), cs != banded_nn.SENTINEL, cs, 0.4)
    before = _kernels.launch_counts()["banded_moments"]
    got = moments_for(*args)
    assert _kernels.launch_counts()["banded_moments"] == before + 1
    _assert_moments_agree(got, normals.sorted_radius_moments(*args))
    assert torch.equal(got, moments_for(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("N,invalid", [(16384, 1536), (32768, 700)])
def test_banded_moments_kernel_finds_the_window_starts(cuda, N, invalid):
    """K2 finds each tile's window start itself: the same neighbours as
    the twin, which takes them from `banded_window_starts`, with whole
    tiles of invalid points at the back (their codes all SENTINEL) and
    windows clipped at both ends of a 32-block cloud."""
    p = torch.as_tensor(_lidar_room(N, 9), device=cuda)
    m = torch.arange(N, device=cuda) < N - invalid
    codes = banded_nn.morton_codes(p, m, p[m].amin(0), 2.0)
    cs, perm = torch.sort(codes, stable=True)
    starts = banded_nn.banded_window_starts(cs, cs, N // 1024, 8, 512, 1024)
    last = N // 1024 - 8
    assert bool((starts == 0).any()) and bool((starts == last).any())
    args = (p[perm].contiguous(), cs != banded_nn.SENTINEL, cs, 0.4)
    _assert_moments_agree(
        _launch_twice(normals.sorted_radius_moments_kernel, *args),
        normals.sorted_radius_moments(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,N,tm,radius", [
    ("K3", 4096, None, 2.0), ("K3", 1777, None, 1.0),
    ("K2", 16384, 512, 2.0), ("K2", 16384, 256, 1.0)])
def test_moments_kernels_on_an_integer_grid(cuda, kernel, N, tm, radius):
    """K2 and K3 on points of a small integer grid, where many pairs lie
    exactly at the radius (d^2 == r^2, counted by `<=`) and many points
    coincide: counts equal to the twin's at every point, moments within
    the tolerance, two launches equal. Every piece that the first block of
    a query block scans is masked (a block with only masked references;
    K2: in the tiles whose window starts at 0), and a run of points (K2: a
    whole 1024-block); K2 also at tm = 256, where a block holds 2 queries
    per thread so that it stays inside one tile."""
    rng = np.random.default_rng(N + int(radius))
    p = torch.as_tensor(_grid_points(rng, N), device=cuda)
    m = torch.ones(N, dtype=torch.bool, device=cuda)
    first_block = (torch.arange(N, device=cuda) // normals.MOMENTS_PIECE
                   % normals.moments_split_plan(
                       N, N if kernel == "K3" else 8 * 1024, tm).splits == 0)
    if kernel == "K3":
        m[first_block] = False
        m[512:768] = False
        got = _launch_twice(normals.radius_moments_kernel, p, m, radius)
        want = normals.radius_moments(p, m, radius)
    else:
        plan = normals.moments_split_plan(N, 8 * 1024, tm)
        assert plan.queries_per_thread == (4 if tm == 512 else 2)
        assert plan.splits >= 2
        codes = banded_nn.morton_codes(p, m, p.amin(0), 2.0)
        cs, perm = torch.sort(codes, stable=True)
        ps, ms = p[perm].contiguous(), (cs != banded_nn.SENTINEL).clone()
        starts = banded_nn.banded_window_starts(cs, cs, N // 1024, 8, tm,
                                                1024)
        assert bool((starts == 0).any())
        ms[first_block] = False
        ms[5 * 1024:6 * 1024] = False
        args = (ps, ms, cs, radius)
        got = _launch_twice(normals.sorted_radius_moments_kernel, *args,
                            tm=tm)
        want = normals.sorted_radius_moments(*args, tm=tm)
    assert bool((want[:, 9] > 1).float().mean() > 0.5)   # real neighbours
    _assert_moments_agree(got, want)


def _banded_scene(dev, M, N, seed=5):
    """A Morton-sorted map of N points (the 20 m room ~59 m out, 2%
    masked) with normals as payload, and M queries from a second scan of
    it under a small motion, sorted as the ICP sorts its reading."""
    ref = torch.as_tensor(_lidar_room(N, seed), device=dev)
    rmask = torch.arange(N, device=dev) % 50 != 0
    nrm = torch.nn.functional.normalize(
        torch.randn((N, 3), device=dev, generator=torch.Generator(
            device=dev).manual_seed(seed)), dim=1)
    origin = ref[rmask].amin(0)
    rs, rpen, rcodes, pay = banded_nn.banded_prepare_payload(
        ref, rmask, nrm, origin, 2.0)
    q = torch.as_tensor(_lidar_room(M, seed + 1), device=dev) + torch.tensor(
        [0.05, -0.03, 0.01], device=dev)
    qm = torch.ones(M, dtype=torch.bool, device=dev)
    codes = banded_nn.morton_codes(q, qm, origin, 2.0)
    codes, perm = torch.sort(codes, stable=True)
    return q[perm].contiguous(), codes, rs, rpen, rcodes, pay


@pytest.mark.cuda
@pytest.mark.parametrize("M,N,band", [(8192, 65536, 16), (1024, 65536, 64),
                                      (8192, 131072, 32),
                                      (1024, 131072, 128)])
def test_banded_nn_kernels_match_plain(cuda, M, N, band):
    """K5 against the plain twin at the fine and coarse ICP phases' bands
    against 64- and 128-block crops (the TPU's resident and streaming
    shapes): the contract's >= 99.7% identical payload rows and |d2|
    within 3e-3 m^2 (in fact bit-identical: every operation is rounded
    alike), and the full-coverage band of the coarse phase."""
    q, codes, rs, rpen, rcodes, pay = _banded_scene(cuda, M, N)
    starts = banded_nn.banded_window_starts(codes, rcodes, N // 1024, band,
                                            512, 1024)
    args = (q, rs, rpen, pay, starts, band)
    before = _kernels.launch_counts()["banded_nn_payload_stream"]
    d5, p5 = banded_nn.nn_payload_banded_stream_kernel(*args)
    dp, pp = banded_nn.nn_payload_banded(*args)
    torch.cuda.synchronize()
    assert _kernels.launch_counts()["banded_nn_payload_stream"] == before + 1
    assert (p5 == pp).all(1).float().mean().item() >= 0.997
    assert (d5 - dp).abs().max().item() <= 3e-3
    assert bool((d5 < 1.0).float().mean() > 0.99)       # real matches


@pytest.mark.cuda
def test_banded_nn_kernels_find_nothing_in_a_dead_window(cuda):
    """A window holding only masked references: +BIG and a zero row."""
    q, codes, rs, rpen, rcodes, pay = _banded_scene(cuda, 1024, 8192)
    dead = torch.full_like(rpen, 3.4e38)
    starts = torch.zeros(2, dtype=torch.int32, device=cuda)
    d, p = banded_nn.nn_payload_banded_stream_kernel(q, rs, dead, pay,
                                                     starts, 8)
    torch.cuda.synchronize()
    assert bool((d == 3.4e38).all()) and bool((p == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("M,N,band", [(8192, 65536, 16), (8192, 65536, 64),
                                      (1024, 8192, 8)])
def test_banded_nn_argmin_kernel_matches_plain(cuda, M, N, band):
    """K5's index mode (Q2 #10) against its plain twin: >= 99.7 %
    identical indices (in fact all: every operation is rounded alike),
    |d2| within 3e-3 m^2; -1 and +BIG in a window of masked rows."""
    q, codes, rs, rpen, rcodes, pay = _banded_scene(cuda, M, N)
    starts = banded_nn.banded_window_starts(codes, rcodes, N // 1024, band,
                                            512, 1024)
    args = (q, rs, rpen, starts, band)
    before = _kernels.launch_counts()["banded_nn_argmin"]
    d5, i5 = banded_nn.banded_nn_argmin_kernel(*args)
    dp, ip = banded_nn.banded_nn_argmin(*args)
    torch.cuda.synchronize()
    assert _kernels.launch_counts()["banded_nn_argmin"] == before + 1
    assert i5.dtype == torch.int64
    assert (i5 == ip).float().mean().item() >= 0.997
    assert (d5 - dp).abs().max().item() <= 3e-3
    # the index mode finds the payload mode's winners
    _, p5 = banded_nn.nn_payload_banded_stream_kernel(q, rs, rpen, pay,
                                                      starts, band)
    assert bool((pay[i5] == p5).all())
    dead = torch.full_like(rpen, 3.4e38)
    d, i = banded_nn.banded_nn_argmin_kernel(q, rs, dead, starts, band)
    torch.cuda.synchronize()
    assert bool((d == 3.4e38).all()) and bool((i == -1).all())


def _grid_points(rng, n):
    """Points on a small integer grid: every squared distance is exact in
    any rounding order, so K1 (which contracts into FMAs) and its twin
    agree bit for bit, and many distances tie exactly."""
    return rng.integers(0, 12, (n, 3)).astype(np.float32)


def _assert_same(got, want):
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a.cpu(), b.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("M,N", [(1024, 8192), (8192, 8192), (1000, 1777),
                                 (1, 1), (513, 129), (77, 5001)])
def test_nn_kernels_break_ties_across_splits(cuda, M, N):
    """K1, both modes, row for row with its twins: the reference holds each
    point twice, half a reference apart, so a query's nearest points tie
    across splits (the lowest index must win); the first split is all
    masked (its queries' winners lie in a later split); masked queries;
    ragged M and N."""
    rng = np.random.default_rng(M + N)
    half = _grid_points(rng, N // 2)
    r = np.concatenate([half, half, _grid_points(rng, N % 2)])
    q = torch.as_tensor(_grid_points(rng, M), device=cuda)
    r = torch.as_tensor(r, device=cuda)
    plan = knn.nn_split_plan(M, N)
    assert plan.splits >= 2 or N < 2 * knn.MIN_SPLIT
    qm = torch.arange(M, device=cuda) % 5 != 4
    rm = torch.arange(N, device=cuda) >= min(plan.split_len, N - 1)
    pay = torch.cat([r, torch.as_tensor(rng.normal(size=(N, 5)).astype(
        np.float32), device=cuda)], 1).contiguous()
    _assert_same(knn.nn_argmin_kernel(q, qm, r, rm),
                 knn.nn_argmin(q, qm, r, rm))
    _assert_same(knn.nn_payload_kernel(q, qm, r, rm, pay),
                 knn.nn_payload(q, qm, r, rm, pay))


@pytest.mark.cuda
@pytest.mark.parametrize("M,N", [(1024, 8192), (1000, 1777)])
def test_nn_kernels_on_an_all_masked_reference(cuda, M, N):
    """K1 on a reference with no valid point: kBig and index 0 (payload row
    0) for every valid query, as argmin gives; (kBig, 0) or a zero row for
    a masked one."""
    rng = np.random.default_rng(3)
    q = torch.as_tensor(_grid_points(rng, M), device=cuda)
    r = torch.as_tensor(_grid_points(rng, N), device=cuda)
    qm = torch.arange(M, device=cuda) % 3 != 0
    rm = torch.zeros(N, dtype=torch.bool, device=cuda)
    pay = torch.cat([r, torch.ones((N, 5), device=cuda)], 1).contiguous()
    d, i = knn.nn_argmin_kernel(q, qm, r, rm)
    assert bool((d == 3.4e38).all()) and bool((i == 0).all())
    _assert_same((d, i), knn.nn_argmin(q, qm, r, rm))
    _assert_same(knn.nn_payload_kernel(q, qm, r, rm, pay),
                 knn.nn_payload(q, qm, r, rm, pay))


@pytest.mark.cuda
@pytest.mark.parametrize("M,N,band,starts", [
    (1024, 8192, 8, (0, 0)), (1024, 8192, 4, (1, 99)),
    (8192, 65536, 16, (0, 3, 9, 20, 30, 40, 47, 60, 1, 2, 5, 8, 13, 21,
                       34, 55))])
def test_banded_nn_kernels_break_ties_across_splits(cuda, M, N, band,
                                                    starts):
    """K5, both modes, bit for bit with its twins: each point twice, half a
    reference apart (ties across splits when the window holds both
    copies), the reference's first slice and a whole block masked (slices
    of only masked references), windows clipped at the end (starts past
    N / 1024 - band)."""
    rng = np.random.default_rng(M + band)
    half = _grid_points(rng, N // 2)
    rs = torch.as_tensor(np.concatenate([half, half]), device=cuda)
    rpen = torch.zeros(N, device=cuda)
    plan = banded_nn.banded_split_plan(M, band)
    assert plan.splits >= 2
    rpen[:plan.split_len] = 3.4e38
    rpen[5 * 1024:6 * 1024] = 3.4e38
    q = torch.as_tensor(_grid_points(rng, M), device=cuda)
    pay = torch.cat([rs, torch.as_tensor(rng.normal(size=(N, 5)).astype(
        np.float32), device=cuda)], 1).contiguous()
    st = torch.tensor(starts, dtype=torch.int32, device=cuda)
    _assert_same(banded_nn.banded_nn_argmin_kernel(q, rs, rpen, st, band),
                 banded_nn.banded_nn_argmin(q, rs, rpen, st, band))
    _assert_same(
        banded_nn.nn_payload_banded_stream_kernel(q, rs, rpen, pay, st, band),
        banded_nn.nn_payload_banded(q, rs, rpen, pay, st, band))


@pytest.mark.cuda
def test_public_nn_api_launches_the_kernels(cuda):
    """The ported public NN functions on CUDA tensors launch K1 (#8) and
    K5 (#9-#11), and give what the same functions give on the CPU."""
    M, N = 1024, 8192
    q, codes, rs, rpen, rcodes, pay = _banded_scene(cuda, M, N)
    qm = torch.arange(M, device=cuda) % 9 != 0
    rm = rpen == 0
    before = _kernels.launch_counts()
    got = {
        "tiled": knn.nn_payload_tiled_kernel(q, qm, rs, rm, pay),
        "argmin": banded_nn.nn_argmin_banded(q, qm, rs, rm, band=4),
    }
    rt, rsq = rs.T.contiguous(), torch.where(rm, (rs * rs).sum(1), 3.4e38)[
        None]
    starts = banded_nn.banded_window_starts(codes, rcodes, N // 1024, 4,
                                            512, 1024)
    pay_t = pay.T.contiguous()
    got["sorted"] = banded_nn.nn_payload_banded_sorted(q, rt, rsq, pay_t,
                                                       starts, band=4)
    got["resident"] = banded_nn.nn_payload_banded_resident(
        q, *banded_nn.banded_blocks(rt, rsq, pay_t), starts, band=4)
    torch.cuda.synchronize()
    after = _kernels.launch_counts()
    assert after["nn_payload"] == before["nn_payload"] + 1
    assert after["banded_nn_argmin"] == before["banded_nn_argmin"] + 1
    assert after["banded_nn_payload_stream"] == \
        before["banded_nn_payload_stream"] + 2
    cpu = {
        "tiled": knn.nn_payload_tiled_kernel(q.cpu(), qm.cpu(), rs.cpu(),
                                             rm.cpu(), pay.cpu()),
        "argmin": banded_nn.nn_argmin_banded(q.cpu(), qm.cpu(), rs.cpu(),
                                             rm.cpu(), band=4),
        "sorted": banded_nn.nn_payload_banded_sorted(
            q.cpu(), rt.cpu(), rsq.cpu(), pay_t.cpu(), starts.cpu(), band=4),
    }
    cpu["resident"] = cpu["sorted"]
    for key, (d, v) in got.items():
        dc, vc = cpu[key]
        assert (d.cpu() - dc).abs().max().item() <= 3e-3, key
        same = (v.cpu() == vc) if v.ndim == 1 else (v.cpu() == vc).all(1)
        assert same.float().mean().item() >= 0.997, key


@pytest.mark.cuda
def test_banded_moments_kernel_beyond_64_blocks(cuda):
    """K2 serves the TPU's f32 banded moments too: the map normals'
    262,144 points (256 blocks) through `radius_normals`."""
    N = 262144
    p = torch.as_tensor(_lidar_room(N, 6), device=cuda)
    m = torch.arange(N, device=cuda) < N - 1000
    before = _kernels.launch_counts()["banded_moments"]
    got = normals._radius_moments_banded(p, m, 0.4)
    assert _kernels.launch_counts()["banded_moments"] == before + 1
    codes = banded_nn.morton_codes(p, m, p[m].amin(0), 2.0)
    cs, perm = torch.sort(codes, stable=True)
    want = torch.empty_like(got)
    want[perm] = normals.sorted_radius_moments(
        p[perm], cs != banded_nn.SENTINEL, cs, 0.4)
    _assert_moments_agree(got, want)
    assert torch.equal(got, normals._radius_moments_banded(p, m, 0.4))
    n, _, _ = normals.radius_normals(p, m, 0.4)
    assert bool(torch.isfinite(n).all())


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 3])
def test_ground_mask_on_the_card_is_the_cpus(cuda, seed):
    """The ground filter at the KITTI runner's raster: the card labels
    every point as the CPU does (float64 raster centre, float32 cell
    arithmetic on device tensors)."""
    from aicp_mapping_tpu_torch.ops.ground import (GroundFilterConfig,
                                                   ground_mask)
    from aicp_mapping_tpu_torch.tools.urban import (drive_trajectory,
                                                    make_urban_world,
                                                    velodyne_scan)

    world = make_urban_world(seed=seed)
    pose = drive_trajectory(5, world, speed=10.0, seed=seed)[4]
    pts = torch.as_tensor(velodyne_scan(world, pose, n_azimuth=2048))
    n = pts.shape[0]
    p = torch.zeros((131072, 3))
    p[:n] = pts
    m = torch.arange(131072) < n
    cfg = GroundFilterConfig(cell_size=0.5, grid_dim=256)
    want = ground_mask(p, m, cfg)
    got = ground_mask(p.to(cuda), m.to(cuda), cfg)
    assert torch.equal(got.cpu(), want)
    assert 0.2 < float(want.sum()) / n < 0.9


@pytest.mark.cuda
def test_classifier_training_on_the_card_is_the_cpus(cuda):
    """`RiskClassifier.train` on the card gives the CPU's model: its
    reductions are float64 rounded once."""
    import os

    from aicp_mapping_tpu_torch.classification import (RiskClassifier,
                                                       load_label_file)

    root = os.path.join(os.path.dirname(__file__), "..", "data", "labels")
    feats, labels = load_label_file(os.path.join(root,
                                                 "training_synthetic.txt"))
    card, cpu = RiskClassifier(device="cuda"), RiskClassifier(device="cpu")
    card.train(feats, labels)
    cpu.train(feats, labels)
    torch.testing.assert_close(card.model.w.cpu(), cpu.model.w, rtol=1e-4,
                               atol=1e-6)
    torch.testing.assert_close(card.test(feats), cpu.test(feats), rtol=0,
                               atol=1e-4)


def _alignability_graph(cuda, raw, seed):
    """Region growing's graph on one alignability cloud, as
    `overlap/alignability.py:_segment_cloud` builds it: a 0.08 m voxel grid
    into 4,096 slots, one 30-NN build for the normals (toward the sensor at
    the origin) and its first 15 columns for the graph. `raw` points fill
    the slots (20,000) or part of them (3,000)."""
    p = torch.as_tensor(_lidar_room(raw, seed), device=cuda)
    dpts, dmask = voxel_downsample(p, torch.ones(raw, dtype=torch.bool,
                                                 device=cuda), 0.08, 4096)
    _, idx = knn.knn(dpts, dmask, dpts, dmask, 30)
    nrm, curv, _ = normals.normals_from_neighbors(
        dpts, dmask, idx, torch.zeros(3, device=cuda))
    return segmentation.smoothness_graph(dpts, dmask, nrm, curv, 15,
                                         neighbor_idx=idx) + (dmask,)


def _lidar_graph(cuda, n, valid, seed):
    """A 15-NN smoothness graph on n lidar points, the first `valid` of
    them valid."""
    p = torch.as_tensor(_lidar_room(n, seed), device=cuda)
    m = torch.arange(n, device=cuda) < valid
    _, idx = knn.knn(p, m, p, m, 15)
    nrm, curv, _ = normals.normals_from_neighbors(p, m, idx)
    return segmentation.smoothness_graph(p, m, nrm, curv, 15,
                                         neighbor_idx=idx) + (m,)


def _propagation_agrees(idx, pull_ok, mask, max_iters, jumps) -> int:
    """The kernel against the eager loop on the same card tensors: the same
    labels bit for bit, the same rounds (the kernel's from the card's
    counter), one launch; returns the rounds."""
    segmentation.reset_propagation_rounds()
    want = segmentation.propagate_labels(idx, pull_ok, mask, max_iters,
                                         jumps)
    rounds = segmentation.propagation_rounds()["rounds"]
    segmentation.reset_propagation_rounds()
    before = _kernels.launch_counts()["label_propagation"]
    got = segmentation.propagate_labels_kernel(idx, pull_ok, mask,
                                               max_iters, jumps)
    torch.cuda.synchronize()
    assert _kernels.launch_counts()["label_propagation"] == before + 1
    assert got.dtype == torch.int64
    assert torch.equal(got, want)
    assert segmentation.propagation_rounds()["rounds"] == rounds
    assert rounds == max_iters or rounds < max_iters and torch.equal(
        got, segmentation.propagate_labels(idx, pull_ok, mask, rounds + 1,
                                           jumps))
    return rounds


@pytest.mark.cuda
@pytest.mark.parametrize("raw", [20000, 3000])
@pytest.mark.parametrize("max_iters,jumps", [(64, 6), (2, 6), (64, 0)])
def test_label_propagation_kernel_on_alignability_clouds(cuda, raw,
                                                          max_iters, jumps):
    """4,096 slots, all labels and lists in shared memory (mode 0): full
    and partly filled clouds, converged and cut at 2 rounds, with and
    without pointer jumps."""
    idx, pull_ok, mask = _alignability_graph(cuda, raw, 5)
    assert segmentation.propagation_plan(4096, 15).mode == 0
    assert idx.stride() == (30, 1)
    full = int(mask.sum()) == 4096
    assert full == (raw == 20000)
    rounds = _propagation_agrees(idx, pull_ok, mask, max_iters, jumps)
    assert rounds >= 2


@pytest.mark.cuda
@pytest.mark.parametrize("n,valid,mode", [
    (1000, 937, 0), (16384, 15000, 1), (32768, 32768, 1),
    (40000, 39000, 2)])
@pytest.mark.parametrize("max_iters,jumps", [(64, 6), (2, 6), (64, 0)])
def test_label_propagation_kernel_at_every_size(cuda, n, valid, mode,
                                                max_iters, jumps):
    """A ragged cloud, the region-growing prefilter's 16,384 and 32,768
    points (labels in shared memory, lists in device memory) and past
    them (all in device memory)."""
    idx, pull_ok, mask = _lidar_graph(cuda, n, valid, n)
    assert segmentation.propagation_plan(n, 15).mode == mode
    _propagation_agrees(idx, pull_ok, mask, max_iters, jumps)


@pytest.mark.cuda
def test_alignability_with_the_kernel_is_the_eager_loops(cuda, monkeypatch):
    """One alignability call on the card, label propagation by the kernel
    and then by the eager loop: the same labels on both clouds, the same
    matches, matched points, eigenvalues and value, bit for bit. The box
    statistics sum floats with atomics on the card, in no fixed order, so
    a point on a box's face may fall in or out from one call to the next
    (seen: 2 of 1,024 box overlaps, by one point's share), and the
    normals' centroids move by roundings: the box overlaps compare by the
    share that differs, the centroid angles by their cosines (an angle
    near 0 moves by ~0.02 degrees with one rounding of its cosine)."""
    from aicp_mapping_tpu_torch.overlap.alignability import \
        alignability_filter

    a = torch.as_tensor(_lidar_room(20000, 11), device=cuda)
    b = torch.as_tensor(_lidar_room(20000, 12), device=cuda) + torch.tensor(
        [0.3, 0.1, 0.0], device=cuda)
    ma = torch.ones(20000, dtype=torch.bool, device=cuda)
    eye = torch.eye(4, device=cuda)
    seen = []

    def recorded(fn):
        def run(*args):
            seen.append(fn(*args))
            return seen[-1]
        return run

    runs = []
    for twin in (segmentation.propagate_labels_kernel,
                 segmentation.propagate_labels):
        monkeypatch.setattr(segmentation, "propagate_labels_kernel",
                            recorded(twin))
        before = _kernels.launch_counts()["label_propagation"]
        runs.append(alignability_filter(a, ma, eye, b, ma, eye,
                                        ds_capacity=4096, max_clusters=32))
        torch.cuda.synchronize()
        launched = _kernels.launch_counts()["label_propagation"] - before
        assert launched == (2 if len(runs) == 1 else 0)
    assert len(seen) == 4
    assert torch.equal(seen[0], seen[2]) and torch.equal(seen[1], seen[3])
    (got, dg), (want, dw) = runs
    for key in ("matched_a", "n_matched_points", "eigvals"):
        assert torch.equal(dg[key], dw[key]), key
    assert torch.equal(got, want)
    assert float(dw["n_matched_points"]) > 0
    assert (dg["box_overlap"] != dw["box_overlap"]).float().mean() <= 0.01
    cos_g, cos_w = (torch.cos(torch.deg2rad(d["centroid_angle"]))
                    for d in (dg, dw))
    torch.testing.assert_close(cos_g, cos_w, rtol=0, atol=1e-5)
