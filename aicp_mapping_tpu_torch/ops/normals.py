"""Radius-neighbourhood moments and normals, PyTorch port of the parts of
`aicp_mapping_tpu.ops.normals` on the hough prefilter's path.

Moments are the (N, 10) sums [Sx Sy Sz Sxx Syy Szz Sxy Sxz Syz cnt] over
each point's valid neighbours with |q - r|^2 <= r^2 (difference form, see
`ops.knn`).

- `radius_moments`: plain exhaustive version (twin of
  `_radius_moments_xla`); `radius_moments_kernel` wraps kernel K3.
- `sorted_radius_moments`: plain banded version on a Morton-sorted cloud
  (twin of `sorted_radius_moments`, same band/tm/tn semantics);
  `sorted_radius_moments_kernel` wraps kernel K2, which computes f32
  moments at any block count and so serves both TPU banded kernels (the
  bf16 split one up to 64 blocks and the f32 one above).
- `radius_normals`: normals + curvature from radius moments, banded
  (`_radius_moments_banded`) or exhaustive by shape.

A wrapper runs its plain version on a CPU tensor and launches its kernel
on a CUDA tensor, or raises. kNN normals (`estimate_normals`) are not
ported yet (ROADMAP Q1 #11).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .. import _kernels
from .banded_nn import SENTINEL, banded_window_starts, morton_codes
from .knn import sq_dists

_BIG = 3.4e38
# Moments dispatch by shape (never by device): clouds of at least this many
# points, in whole 1024-point blocks, use the banded moments (kernel K2) —
# what the TPU computes at these sizes — and all others the exhaustive
# moments (kernel K3). The device then only picks kernel or plain twin.
BANDED_MIN_POINTS = 16384


def banded_by_shape(n: int) -> bool:
    return n >= BANDED_MIN_POINTS and n % 1024 == 0


def _features(points: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(N, 10) per-point moment features, zero on masked points."""
    x, y, z = points[:, 0], points[:, 1], points[:, 2]
    F = torch.stack([x, y, z, x * x, y * y, z * z, x * y, x * z, y * z,
                     torch.ones_like(x)], dim=1)
    return F * mask.to(points.dtype)[:, None]


def _rad2(radius) -> float:
    return float(np.float32(float(radius) * float(radius)))


def _window_moments(q, refs, rmask, F, rad2):
    w = (sq_dists(q, refs) <= rad2) & rmask[None, :]
    return w.to(F.dtype) @ F


def radius_moments(points: torch.Tensor, mask: torch.Tensor, radius,
                   block: int = 512) -> torch.Tensor:
    """Exhaustive (N, 10) neighbourhood moments, blockwise over queries."""
    F = _features(points, mask)
    rad2 = _rad2(radius)
    return torch.cat([
        _window_moments(points[s:s + block], points, mask, F, rad2)
        for s in range(0, points.shape[0], block)])


def sorted_radius_moments(ps: torch.Tensor, ms: torch.Tensor,
                          codes_s: torch.Tensor, radius, band: int = 8,
                          tm: int = 512, tn: int = 1024) -> torch.Tensor:
    """Banded (N, 10) moments of an already Morton-sorted cloud (codes
    ascending, invalid at the back): the queries of each `tm` tile see only
    the `band` reference blocks of `tn` points from the tile's window
    start. Neighbours outside the window are missed, exactly as in the
    TPU's banded kernel."""
    N = ps.shape[0]
    n_rblocks = N // tn
    band = min(band, n_rblocks)
    starts = banded_window_starts(codes_s, codes_s, n_rblocks, band, tm, tn)
    F = _features(ps, ms)
    rad2 = _rad2(radius)
    out = []
    for g, s in enumerate(starts.tolist()):
        w = slice(s * tn, (s + band) * tn)
        out.append(_window_moments(ps[g * tm:(g + 1) * tm], ps[w], ms[w],
                                   F[w], rad2))
    return torch.cat(out)


def radius_moments_kernel(points: torch.Tensor, mask: torch.Tensor,
                          radius) -> torch.Tensor:
    """Kernel K3 (replaces ops/normals.py:_radius_moments_kernel):
    exhaustive moments for any N; plain `radius_moments` on CPU."""
    if _check("radius_moments", points, mask) == "cpu":
        return radius_moments(points, mask, radius)
    N = points.shape[0]
    out = torch.empty((N, 10), dtype=torch.float32, device=points.device)
    with torch.cuda.device(points.device):
        status = _kernels.library().aicp_radius_moments(
            points.data_ptr(), mask.data_ptr(), N, _rad2(radius),
            out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _kernels.check_status(status, "radius_moments")
    _kernels.count_launch("radius_moments")
    return out


def sorted_radius_moments_kernel(ps: torch.Tensor, ms: torch.Tensor,
                                 codes_s: torch.Tensor, radius,
                                 band: int = 8, tm: int = 512,
                                 tn: int = 1024) -> torch.Tensor:
    """Kernel K2 (replaces ops/normals.py:_banded_moments_split_kernel):
    banded moments of a Morton-sorted cloud with N % tm == N % tn == 0 and
    tm % 128 == 0; plain `sorted_radius_moments` on CPU."""
    device_type = _check("banded_moments", ps, ms)
    N = ps.shape[0]
    if N % tm or N % tn or tm % 128 or codes_s.shape != (N,):
        raise ValueError(f"banded_moments: N={N} tm={tm} tn={tn}")
    if device_type == "cpu":
        return sorted_radius_moments(ps, ms, codes_s, radius, band, tm, tn)
    n_rblocks = N // tn
    band = min(band, n_rblocks)
    starts = banded_window_starts(codes_s, codes_s, n_rblocks, band, tm,
                                  tn).contiguous()
    out = torch.empty((N, 10), dtype=torch.float32, device=ps.device)
    with torch.cuda.device(ps.device):
        status = _kernels.library().aicp_banded_moments(
            ps.data_ptr(), ms.data_ptr(), N, starts.data_ptr(), tm, tn, band,
            _rad2(radius), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _kernels.check_status(status, "banded_moments")
    _kernels.count_launch("banded_moments")
    return out


def _radius_moments_banded(points: torch.Tensor, mask: torch.Tensor,
                           radius, cell_size: float = 2.0, band: int = 8,
                           tm: int = 512, tn: int = 1024) -> torch.Tensor:
    """Morton-banded (N, 10) moments in the ORIGINAL point order: one
    stable sort at `cell_size` over the cloud's own origin, the banded
    moments (K2 or its twin) in sorted order, then the inverse
    permutation."""
    origin = torch.where(mask[:, None], points, _BIG).amin(0)
    codes = morton_codes(points, mask, origin, cell_size)
    codes_s, perm = torch.sort(codes, stable=True)
    out_sorted = sorted_radius_moments_kernel(
        points[perm], codes_s != SENTINEL, codes_s, radius, band, tm, tn)
    out = torch.empty_like(out_sorted)
    out[perm] = out_sorted
    return out


def radius_normals(points: torch.Tensor, mask: torch.Tensor, radius,
                   viewpoint=None):
    """Normals + curvature from fixed-radius neighbourhoods: (normals
    (N, 3), curvature (N,), n_neighbors (N,)). Banded moments for
    n >= 16,384 in whole 1024-blocks, exhaustive (K3) otherwise — by shape
    on every device (ROADMAP Q3)."""
    if banded_by_shape(points.shape[0]):
        M = _radius_moments_banded(points, mask, radius)
    else:
        M = radius_moments_kernel(points, mask, radius)
    return moments_to_normals(M, points, mask, viewpoint)


def _check(name: str, points: torch.Tensor, mask: torch.Tensor) -> str:
    """Contiguous (N, 3) f32 points and an (N,) bool mask on one device;
    returns the device type."""
    device_type = _kernels.check_tensors(name, points, mask)
    if points.dtype != torch.float32 or mask.dtype != torch.bool:
        raise TypeError(f"{name}: f32 points and a bool mask")
    if points.ndim != 2 or points.shape[1] != 3 or \
            mask.shape != points.shape[:1]:
        raise ValueError(f"{name}: bad shapes {points.shape} {mask.shape}")
    return device_type


def _det3(B: torch.Tensor) -> torch.Tensor:
    return (B[..., 0, 0] * (B[..., 1, 1] * B[..., 2, 2]
                            - B[..., 1, 2] * B[..., 2, 1])
            - B[..., 0, 1] * (B[..., 1, 0] * B[..., 2, 2]
                              - B[..., 1, 2] * B[..., 2, 0])
            + B[..., 0, 2] * (B[..., 1, 0] * B[..., 2, 1]
                              - B[..., 1, 1] * B[..., 2, 0]))


def _eigh3x3_smallest(A: torch.Tensor):
    """Batched symmetric 3x3: eigenvalues (..., 3) ascending and the
    eigenvector of the smallest, by Smith's closed form and the largest
    cross product of two rows of A - l_min I (as in the JAX twin)."""
    tr = A[..., 0, 0] + A[..., 1, 1] + A[..., 2, 2]
    q = tr / 3.0
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    B = A - q[..., None, None] * eye
    p2 = (B * B).sum(dim=(-2, -1)) / 6.0
    p = torch.sqrt(torch.clamp(p2, min=1e-30))
    # A zero covariance (a point with no neighbour but itself) gives r = 0,
    # curvature 0 and the +z normal, as the JAX twin does under jit.
    r = _det3(B) / (2.0 * torch.clamp(p, min=1e-30) ** 3)
    phi = torch.arccos(torch.clamp(r, -1.0, 1.0)) / 3.0
    l0 = q + 2.0 * p * torch.cos(phi)
    l2 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    l1 = tr - l0 - l2
    eigvals = torch.stack([l2, l1, l0], dim=-1)

    M = A - l2[..., None, None] * eye
    r0, r1, r2 = M[..., 0, :], M[..., 1, :], M[..., 2, :]
    cands = torch.stack([torch.linalg.cross(r0, r1, dim=-1),
                         torch.linalg.cross(r0, r2, dim=-1),
                         torch.linalg.cross(r1, r2, dim=-1)], dim=-2)
    best = torch.argmax((cands * cands).sum(-1), dim=-1)
    v = torch.gather(cands, -2, best[..., None, None].expand(
        best.shape + (1, 3)))[..., 0, :]
    norm = torch.linalg.norm(v, dim=-1, keepdim=True)
    up = torch.zeros(3, dtype=A.dtype, device=A.device)
    up[2] = 1.0                      # degenerate (isotropic) case: +z
    v = torch.where(norm > 1e-12, v / torch.clamp(norm, min=1e-12), up)
    return eigvals, v


def moments_to_normals(M: torch.Tensor, points: torch.Tensor,
                       mask: torch.Tensor, viewpoint=None):
    """(N, 10) moments -> (normals (N,3), curvature (N,), n_neighbors (N,)):
    cov = E[xx^T] - mu mu^T, smallest eigenvector, normals flipped toward
    `viewpoint` when given."""
    cnt = torch.clamp(M[:, 9], min=1.0)
    mean = M[:, 0:3] / cnt[:, None]
    exx = M[:, 3:6] / cnt[:, None]
    exy = M[:, 6:9] / cnt[:, None]
    cxy = exy[:, 0] - mean[:, 0] * mean[:, 1]
    cxz = exy[:, 1] - mean[:, 0] * mean[:, 2]
    cyz = exy[:, 2] - mean[:, 1] * mean[:, 2]
    cov = torch.stack([
        torch.stack([exx[:, 0] - mean[:, 0] * mean[:, 0], cxy, cxz], dim=-1),
        torch.stack([cxy, exx[:, 1] - mean[:, 1] * mean[:, 1], cyz], dim=-1),
        torch.stack([cxz, cyz, exx[:, 2] - mean[:, 2] * mean[:, 2]], dim=-1),
    ], dim=-2)
    eigvals, normal = _eigh3x3_smallest(cov)
    denom = torch.clamp(eigvals.sum(-1), min=1e-12)
    curvature = torch.clamp(eigvals[..., 0], min=0.0) / denom
    if viewpoint is not None:
        flip = (normal * (viewpoint - points)).sum(-1) < 0
        normal = torch.where(flip[:, None], -normal, normal)
    normal = torch.where(mask[:, None], normal, 0.0)
    curvature = torch.where(mask, curvature, 0.0)
    return normal, curvature, M[:, 9]
