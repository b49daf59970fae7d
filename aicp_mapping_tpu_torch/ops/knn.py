"""Nearest-neighbour correspondence search, PyTorch port of
`aicp_mapping_tpu.ops.knn`.

`nn_argmin` and `nn_payload` are the plain PyTorch versions (blockwise
distances + argmin, the twins of `nn_argmin_xla` and `nn_payload_xla`).
Squared distances are taken in difference form, |q - r|^2, exact to f32
rounding: the JAX package's expansion |q|^2 - 2 q.r + |r|^2 is a
matrix-unit formulation that carries ~1e-3 m^2 of rounding noise at 60 m
lidar coordinates. `nn_payload_kernel` is the wrapper of kernel K1
(`_kernels/csrc/nn_payload.cu`), the ICP matcher: on a CUDA tensor it
launches the kernel, on a CPU tensor it runs the plain version. The top-k
`knn` is not ported yet (ROADMAP Q1 #11).
"""
from __future__ import annotations

import torch

from .. import _kernels

_BIG = 3.4e38


def sq_dists(q: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """(B, N) squared distances |q - r|^2 in difference form."""
    dx = q[:, 0, None] - r[None, :, 0]
    dy = q[:, 1, None] - r[None, :, 1]
    dz = q[:, 2, None] - r[None, :, 2]
    return dx * dx + dy * dy + dz * dz


def nn_argmin(queries: torch.Tensor, qmask: torch.Tensor,
              refs: torch.Tensor, rmask: torch.Tensor, block: int = 512):
    """1-NN: (dist2 (M,), index (M,) int64). Masked refs at +BIG, ties to
    the lowest index; masked queries get dist BIG and index 0."""
    dists, idxs = [], []
    for s in range(0, queries.shape[0], block):
        d = torch.where(rmask[None, :], sq_dists(queries[s:s + block], refs),
                        _BIG)
        i = torch.argmin(d, dim=1)
        idxs.append(i)
        dists.append(torch.gather(d, 1, i[:, None])[:, 0])
    dist = torch.where(qmask, torch.cat(dists), _BIG)
    return dist, torch.where(qmask, torch.cat(idxs), 0)


def nn_payload(queries, qmask, refs, rmask, payload, block: int = 512):
    """1-NN with the winner's payload row: (dist2 (M,), payload (M, P));
    masked queries get a zero payload."""
    dist, idx = nn_argmin(queries, qmask, refs, rmask, block=block)
    return dist, torch.where(qmask[:, None], payload[idx], 0.0)


def nn_payload_kernel(queries: torch.Tensor, qmask: torch.Tensor,
                      refs: torch.Tensor, rmask: torch.Tensor,
                      payload: torch.Tensor):
    """Kernel K1 (replaces ops/knn.py:_nn_payload_split_kernel): exact-f32
    1-NN + payload for any M, N >= 1. Same contract as `nn_payload`.

    Takes contiguous f32 points/payload and bool masks on one device. CPU
    tensors run `nn_payload`; CUDA tensors launch the kernel or raise —
    there is no fallback."""
    M, N, P = queries.shape[0], refs.shape[0], payload.shape[1]
    device_type = _kernels.check_tensors("nn_payload", queries, qmask, refs,
                                         rmask, payload)
    if (queries.dtype != torch.float32 or refs.dtype != torch.float32
            or payload.dtype != torch.float32 or qmask.dtype != torch.bool
            or rmask.dtype != torch.bool):
        raise TypeError("nn_payload: f32 points/payload and bool masks")
    if (queries.shape != (M, 3) or refs.shape != (N, 3)
            or qmask.shape != (M,) or rmask.shape != (N,)
            or payload.shape != (N, P) or N < 1):
        raise ValueError("nn_payload: bad shapes "
                         f"{queries.shape} {refs.shape} {payload.shape}")
    if device_type == "cpu":
        return nn_payload(queries, qmask, refs, rmask, payload)
    lib = _kernels.library()
    dist = torch.empty((M,), dtype=torch.float32, device=queries.device)
    pout = torch.empty((M, P), dtype=torch.float32, device=queries.device)
    with torch.cuda.device(queries.device):
        status = lib.aicp_nn_payload(
            queries.data_ptr(), qmask.data_ptr(), M, refs.data_ptr(),
            rmask.data_ptr(), N, payload.data_ptr(), P, dist.data_ptr(),
            pout.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _kernels.check_status(status, "nn_payload")
    _kernels.count_launch("nn_payload")
    return dist, pout
