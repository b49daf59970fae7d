"""The port's CUDA kernels against their plain PyTorch twins.

The tests marked `cuda` need an NVIDIA GPU and skip without one. This file
imports neither JAX nor the JAX package, so on a machine with a card and
no JAX they run with

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py -q

(`--noconftest` because tests/conftest.py configures JAX). The unmarked
tests check the kernel library's bindings and run everywhere.
"""
import re

import numpy as np
import pytest
import torch

from aicp_mapping_tpu_torch import _kernels
from aicp_mapping_tpu_torch.ops import banded_nn, knn, normals
from aicp_mapping_tpu_torch.ops.segmentation import moments_for
from aicp_mapping_tpu_torch.tools.synthetic import room_cloud

torch.set_num_threads(1)


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
        "nn_payload.cu", "moments.cu", "banded_nn.cu", "common.cuh"}
    assert "arch=compute_90a,code=sm_90a" in _kernels.NVCC_FLAGS


@pytest.mark.cuda
@pytest.mark.parametrize("M,N", [(8192, 8192), (1024, 8192), (1000, 1777)])
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


def _assert_moments_agree(a, b):
    diff = (a[:, 9] - b[:, 9]).abs()
    assert (diff <= 2).float().mean().item() >= 0.99
    same = diff == 0
    torch.testing.assert_close(a[same], b[same], rtol=1e-4, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("N", [4096, 8192, 1000])
def test_radius_moments_kernel_matches_plain(cuda, N):
    """K3 on any N: neighbour counts within 2 for >= 99% of points,
    moments within rtol 1e-4 / atol 1e-3 where the counts agree."""
    p = torch.as_tensor(_lidar_room(N, 3), device=cuda)
    m = torch.arange(N, device=cuda) < N - N // 16
    _assert_moments_agree(normals.radius_moments_kernel(p, m, 0.4),
                          normals.radius_moments(p, m, 0.4))


@pytest.mark.cuda
def test_banded_moments_kernel_matches_plain(cuda):
    """K2 at the main path's 16,384 sorted points, via the prefilter's
    shape-based dispatch."""
    N = 16384
    p = torch.as_tensor(_lidar_room(N, 4), device=cuda)
    m = torch.arange(N, device=cuda) < N - 384
    codes = banded_nn.morton_codes(p, m, p[m].amin(0), 2.0)
    cs, perm = torch.sort(codes, stable=True)
    args = (p[perm].contiguous(), cs != banded_nn.SENTINEL, cs, 0.4)
    before = _kernels.launch_counts()["banded_moments"]
    got = moments_for(*args)
    assert _kernels.launch_counts()["banded_moments"] == before + 1
    _assert_moments_agree(got, normals.sorted_radius_moments(*args))


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
    n, _, _ = normals.radius_normals(p, m, 0.4)
    assert bool(torch.isfinite(n).all())
