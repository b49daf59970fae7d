"""Nearest-neighbour correspondence search, PyTorch port of
`aicp_mapping_tpu.ops.knn`.

`nn_argmin` and `nn_payload` are the plain PyTorch versions (blockwise
distances + argmin, the twins of `nn_argmin_xla` and `nn_payload_xla`).
Squared distances are taken in difference form, |q - r|^2, exact to f32
rounding: the JAX package's expansion |q|^2 - 2 q.r + |r|^2 is a
matrix-unit formulation that carries ~1e-3 m^2 of rounding noise at 60 m
lidar coordinates. Kernel K1 (`_kernels/csrc/nn_payload.cu`) has two
modes, with a wrapper each: `nn_payload_kernel`, the ICP matcher, and
`nn_argmin_kernel`, the exact 1-NN distance and index. On a CUDA tensor a
wrapper launches the kernel, on a CPU tensor it runs the plain version.
K1 cuts the reference into slices scanned by blocks of their own
(`nn_split_plan`, `split_window`) and merges the slices' first minima.

The JAX module's names map so: a name without TPU technology is kept; a
`*_pallas` wrapper becomes the `*_kernel` that launches a CUDA kernel, and
an `*_xla` fallback the plain version of the bare name.

| JAX (`aicp_mapping_tpu.ops.knn`) | here |
|---|---|
| `nn_argmin_pallas` | `nn_argmin_kernel` (K1, index mode) |
| `nn_argmin_xla` | `nn_argmin` |
| `nn_payload_pallas_split` | `nn_payload_kernel` (K1, payload mode) |
| `nn_payload_pallas` (`tm`, `tn`, `packed`) | `nn_payload_tiled_kernel` (K1, payload mode) |
| `nn_payload_xla` | `nn_payload` |
| `nn_argmin` (Pallas where it can) | `aicp_mapping_tpu_torch.ops.nn_argmin` = `nn_argmin_kernel` |
| `knn` | `knn` |

`knn` is the exact top-k (normal estimation and region growing); the JAX
package computes it in XLA, so it is plain PyTorch here on every device.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from .. import _kernels
from ..utils import graphs

_BIG = 3.4e38

# The split plans of the scans (K1 here, K5 in ops/banded_nn.py, K2 and K3
# in ops/normals.py): the H100's streaming multiprocessors, the scan blocks
# wanted on each, the threads of a block (kThreads in
# _kernels/csrc/common.cuh) and the shortest slice worth a block of its
# own.
SMS = 132
BLOCKS_PER_SM = 4
THREADS = 128
MIN_SPLIT = 128


def split_window(query_blocks: int, width: int):
    """(splits, split_len): cut a window of `width` references, scanned by
    `query_blocks` blocks of queries, into `splits` contiguous slices of
    `split_len` references, one block each. Enough slices that the grid
    (query blocks x splits) gives every SM `BLOCKS_PER_SM` blocks (16 warps,
    all resident at once), but none shorter than `MIN_SPLIT` references;
    `split_len` is a multiple of 4, so each slice starts 16-byte aligned,
    and no slice is empty: slice s is [s * split_len, min(width, (s + 1) *
    split_len))."""
    want = -(-SMS * BLOCKS_PER_SM // max(1, query_blocks))
    splits = max(1, min(want, width // MIN_SPLIT))
    split_len = -(-width // splits)
    split_len += -split_len % 4
    return -(-width // split_len), split_len


class SplitPlan(NamedTuple):
    """A 1-NN scan's grid, in the order its C entry point takes it: each
    block holds THREADS * queries_per_thread queries and scans one of
    `splits` slices of `split_len` references."""
    queries_per_thread: int
    splits: int
    split_len: int


@functools.lru_cache(maxsize=None)
def nn_split_plan(M: int, N: int) -> SplitPlan:
    """K1's grid for M queries against N references: blocks of `THREADS`
    threads with 4 queries each, the whole reference cut by
    `split_window`."""
    qpt = 4
    return SplitPlan(qpt, *split_window(-(-M // (THREADS * qpt)), N))


def sq_dists(q: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """(B, N) squared distances |q - r|^2 in difference form."""
    dx = q[:, 0, None] - r[None, :, 0]
    dy = q[:, 1, None] - r[None, :, 1]
    dz = q[:, 2, None] - r[None, :, 2]
    return dx * dx + dy * dy + dz * dz


def _rows(queries: torch.Tensor, block) -> int:
    """Query rows per distance block: 64 on the CPU, where the (rows, N)
    temporaries then stay in cache, 512 on the card. Rows are
    independent: the block changes no result."""
    if block is not None:
        return block
    return 64 if queries.device.type == "cpu" else 512


def nn_argmin(queries: torch.Tensor, qmask: torch.Tensor,
              refs: torch.Tensor, rmask: torch.Tensor, block=None):
    """1-NN: (dist2 (M,), index (M,) int64). Masked refs at +BIG, ties to
    the lowest index; masked queries get dist BIG and index 0."""
    block = _rows(queries, block)
    dists, idxs = [], []
    for s in range(0, queries.shape[0], block):
        d = torch.where(rmask[None, :], sq_dists(queries[s:s + block], refs),
                        _BIG)
        i = torch.argmin(d, dim=1)
        idxs.append(i)
        dists.append(torch.gather(d, 1, i[:, None])[:, 0])
    dist = torch.where(qmask, torch.cat(dists), _BIG)
    return dist, torch.where(qmask, torch.cat(idxs), 0)


def nn_payload(queries, qmask, refs, rmask, payload, block=None):
    """1-NN with the winner's payload row: (dist2 (M,), payload (M, P));
    masked queries get a zero payload."""
    dist, idx = nn_argmin(queries, qmask, refs, rmask, block=block)
    return dist, torch.where(qmask[:, None], payload[idx], 0.0)


def _check_nn(name: str, queries, qmask, refs, rmask, *payload) -> str:
    """K1's argument checks: contiguous f32 (M, 3) / (N, 3) points (and an
    (N, P) f32 payload), bool masks, N >= 1, one device; returns its type."""
    M, N = queries.shape[0], refs.shape[0]
    device_type = _kernels.check_tensors(name, queries, qmask, refs, rmask,
                                         *payload)
    if (queries.dtype != torch.float32 or refs.dtype != torch.float32
            or any(t.dtype != torch.float32 for t in payload)
            or qmask.dtype != torch.bool or rmask.dtype != torch.bool):
        raise TypeError(f"{name}: f32 points/payload and bool masks")
    if (queries.shape != (M, 3) or refs.shape != (N, 3)
            or qmask.shape != (M,) or rmask.shape != (N,)
            or any(t.ndim != 2 or t.shape[0] != N for t in payload)
            or N < 1):
        raise ValueError(f"{name}: bad shapes {queries.shape} {refs.shape} "
                         f"{[tuple(t.shape) for t in payload]}")
    return device_type


def nn_argmin_kernel(queries: torch.Tensor, qmask: torch.Tensor,
                     refs: torch.Tensor, rmask: torch.Tensor):
    """Kernel K1 in index mode (replaces ops/knn.py:_nn_kernel): exact-f32
    1-NN distance and int64 index for any M, N >= 1. Same contract as
    `nn_argmin`. CPU tensors run `nn_argmin`; CUDA tensors launch the
    kernel or raise — there is no fallback."""
    if _check_nn("nn_argmin", queries, qmask, refs, rmask) == "cpu":
        return nn_argmin(queries, qmask, refs, rmask)
    M, N = queries.shape[0], refs.shape[0]
    plan = nn_split_plan(M, N)
    dev = queries.device
    dist = torch.empty((M,), dtype=torch.float32, device=dev)
    idx = torch.empty((M,), dtype=torch.int64, device=dev)
    keys = torch.empty((plan.splits, M), dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        status = _kernels.library().aicp_nn_argmin(
            queries.data_ptr(), qmask.data_ptr(), M, refs.data_ptr(),
            rmask.data_ptr(), N, *plan, keys.data_ptr(),
            dist.data_ptr(), idx.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _kernels.check_status(status, "nn_argmin")
    _kernels.count_launch("nn_argmin")
    return dist, idx


def nn_payload_kernel(queries: torch.Tensor, qmask: torch.Tensor,
                      refs: torch.Tensor, rmask: torch.Tensor,
                      payload: torch.Tensor):
    """Kernel K1 (replaces ops/knn.py:_nn_payload_split_kernel): exact-f32
    1-NN + payload for any M, N >= 1. Same contract as `nn_payload`.

    Takes contiguous f32 points/payload and bool masks on one device. CPU
    tensors run `nn_payload`; CUDA tensors launch the kernel or raise —
    there is no fallback."""
    if _check_nn("nn_payload", queries, qmask, refs, rmask, payload) == "cpu":
        return nn_payload(queries, qmask, refs, rmask, payload)
    M, N, P = queries.shape[0], refs.shape[0], payload.shape[1]
    plan = nn_split_plan(M, N)
    dev = queries.device
    dist = torch.empty((M,), dtype=torch.float32, device=dev)
    pout = torch.empty((M, P), dtype=torch.float32, device=dev)
    keys = torch.empty((plan.splits, M), dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        status = _kernels.library().aicp_nn_payload(
            queries.data_ptr(), qmask.data_ptr(), M, refs.data_ptr(),
            rmask.data_ptr(), N, payload.data_ptr(), P, *plan,
            keys.data_ptr(), dist.data_ptr(), pout.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _kernels.check_status(status, "nn_payload")
    # under a CUDA graph's capture (registration/icp.py) each replay counts
    # the launch
    graphs.counted(dev, _kernels.count_launch, "nn_payload")
    return dist, pout


def nn_payload_tiled_kernel(queries: torch.Tensor, qmask: torch.Tensor,
                            refs: torch.Tensor, rmask: torch.Tensor,
                            payload: torch.Tensor, tm: int = 512,
                            tn: int = 1024, packed: bool = True):
    """JAX's `nn_payload_pallas` (replaces ops/knn.py:_nn_payload_kernel
    and :_nn_payload_packed_kernel): 1-NN + payload by kernel K1 with the
    TPU kernels' shape rules, M % tm == 0, N % tn == 0 and P % 8 == 0, or
    it raises. Returns (dist2 (M,), payload (M, P)); a query with no valid
    reference gets +BIG and a zero row, as the unpacked TPU kernel gives.

    `packed` chose the TPU's packed-key kernel, whose distances are
    floored to 13 mantissa bits; K1 has no packed key, so both values give
    the exact f32 distance. CPU tensors run `nn_payload`; CUDA tensors
    launch K1 or raise."""
    del packed
    M, N, P = queries.shape[0], refs.shape[0], payload.shape[-1]
    if M % tm or N % tn or P % 8:
        raise ValueError(f"nn_payload_tiled_kernel: M={M} N={N} P={P} must "
                         f"be multiples of tm={tm}, tn={tn} and 8")
    dist, pout = nn_payload_kernel(queries, qmask, refs, rmask, payload)
    return dist, torch.where((dist < _BIG)[:, None], pout, 0.0)


def _topk_keys(d: torch.Tensor) -> torch.Tensor:
    """Unique int64 sort keys of non-negative f32 distance rows: the
    distance's bits (monotone for non-negative floats) above the column
    index. Ordering by key is ordering by distance with ties to the lower
    index — what a stable sort gives, and what `jax.lax.top_k` gives —
    and no two keys are equal, so `torch.topk`'s unspecified tie order
    never comes into play."""
    col = torch.arange(d.shape[1], device=d.device)
    return (d.view(torch.int32).to(torch.int64) << 32) | col


def knn(queries: torch.Tensor, qmask: torch.Tensor, refs: torch.Tensor,
        rmask: torch.Tensor, k: int, block: int = 512, approx: bool = False):
    """Exact k nearest neighbours: (dist2 (M, k), idx (M, k) int64), sorted
    by distance, ties to the lower index. Invalid refs sit at +BIG;
    invalid queries get dist BIG and index 0. `approx=True` (the TPU's
    `approx_min_k`, ~0.95 recall) takes the exact path (ROADMAP Q3)."""
    del approx
    dists, idxs = [], []
    for s in range(0, queries.shape[0], block):
        d = torch.where(rmask[None, :], sq_dists(queries[s:s + block], refs),
                        _BIG)
        key = torch.topk(_topk_keys(d), k, dim=1, largest=False).values
        i = key & 0xFFFFFFFF
        idxs.append(i)
        dists.append(torch.gather(d, 1, i))
    dist = torch.where(qmask[:, None], torch.cat(dists), _BIG)
    return dist, torch.where(qmask[:, None], torch.cat(idxs), 0)
