"""Radius-neighbourhood moments and normals, PyTorch port of the parts of
`aicp_mapping_tpu.ops.normals` on the hough prefilter's path.

Moments are the (N, 10) sums [Sx Sy Sz Sxx Syy Szz Sxy Sxz Syz cnt] over
each point's valid neighbours with |q - r|^2 <= r^2 (difference form, see
`ops.knn`), summed in float64 (where the products of f32 coordinates are
exact) and rounded to f32 once: closer to the exact sums than the JAX
package's f32 product, and what kernels K2 and K3 compute, up to the f64
summation order.

- `radius_moments`: plain exhaustive version (twin of
  `_radius_moments_xla`); `radius_moments_kernel` wraps kernel K3.
- `sorted_radius_moments`: plain banded version on a Morton-sorted cloud
  (twin of `sorted_radius_moments`, same band/tm/tn semantics);
  `sorted_radius_moments_kernel` wraps kernel K2, which computes the
  moments at any block count and so serves both TPU banded kernels (the
  bf16 split one up to 64 blocks and the f32 one above).
- `radius_normals`: normals + curvature from radius moments, banded
  (`_radius_moments_banded`) or exhaustive by shape.
- `estimate_normals` / `normals_from_neighbors`: normals + curvature from
  the k nearest neighbours (`ops.knn.knn`), as the alignability filter and
  the pair-registration CLI take them.

A wrapper runs its plain version on a CPU tensor and launches its kernel
on a CUDA tensor, or raises. K2 and K3 are split scans: the window of each
block of queries is dealt to blocks of their own in pieces of 16
references (`moments_split_plan`), and a merge pass adds the blocks' f64
partial sums in block order.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .. import _kernels
from .banded_nn import SENTINEL, banded_window_starts, morton_codes
from .knn import (BLOCKS_PER_SM, MIN_SPLIT, SMS, THREADS, SplitPlan, knn,
                  sq_dists)

# K2 and K3 deal a window to the blocks of a query block in pieces of this
# many references, round-robin (kPiece in _kernels/csrc/moments.cu).
MOMENTS_PIECE = 16

_BIG = 3.4e38
# Moments dispatch by shape (never by device): clouds of at least this many
# points, in whole 1024-point blocks, use the banded moments (kernel K2) —
# what the TPU computes at these sizes — and all others the exhaustive
# moments (kernel K3). The device then only picks kernel or plain twin.
BANDED_MIN_POINTS = 16384


def banded_by_shape(n: int) -> bool:
    return n >= BANDED_MIN_POINTS and n % 1024 == 0


def _features(points: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(N, 10) per-point moment features in float64, zero on masked points
    (a product of two f32 coordinates is exact there)."""
    x, y, z = points.double().unbind(1)
    F = torch.stack([x, y, z, x * x, y * y, z * z, x * y, x * z, y * z,
                     torch.ones_like(x)], dim=1)
    return F * mask.to(F.dtype)[:, None]


@functools.lru_cache(maxsize=None)
def moments_split_plan(M: int, width: int, tm: int | None = None) -> SplitPlan:
    """K2's and K3's grid for M queries, each against a window of `width`
    references: blocks of `THREADS` threads with 4 queries each (2 or 1
    where K2's query tile `tm` is not a multiple of 512 or 256, so that a
    block lies inside one tile and shares its window; K3, `tm` None, has
    one window), and `splits` blocks per block of queries, as many as fit
    the grid (query blocks x splits) into one wave of `BLOCKS_PER_SM`
    blocks per SM (the 1-NN plans round the other way; a few blocks of a
    second wave would double a moments scan's time), none with less than
    `MIN_SPLIT` references. The window is dealt to them in pieces of
    `MOMENTS_PIECE` references, round-robin: block s scans pieces s,
    s + splits, ..., at most `split_len` references. The f64 partial sums
    take splits x M x 80 bytes of scratch: at most 21 MB at the main
    paths' shapes, inside the H100's 50 MB L2."""
    qpt = 4 if tm is None else next(
        k for k in (4, 2, 1) if tm % (THREADS * k) == 0)
    blocks = -(-M // (THREADS * qpt))
    splits = max(1, min(SMS * BLOCKS_PER_SM // blocks, width // MIN_SPLIT))
    pieces = -(-width // MOMENTS_PIECE)
    per_block = -(-pieces // splits)
    return SplitPlan(qpt, -(-pieces // per_block), per_block * MOMENTS_PIECE)


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
        for s in range(0, points.shape[0], block)]).float()


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
    return torch.cat(out).float()


def radius_moments_kernel(points: torch.Tensor, mask: torch.Tensor,
                          radius) -> torch.Tensor:
    """Kernel K3 (replaces ops/normals.py:_radius_moments_kernel):
    exhaustive moments for any N; plain `radius_moments` on CPU."""
    if _check("radius_moments", points, mask) == "cpu":
        return radius_moments(points, mask, radius)
    N = points.shape[0]
    dev = points.device
    out = torch.empty((N, 10), dtype=torch.float32, device=dev)
    if N == 0:
        return out
    plan = moments_split_plan(N, N)
    part = torch.empty((plan.splits, N, 10), dtype=torch.float64, device=dev)
    with torch.cuda.device(dev):
        status = _kernels.library().aicp_radius_moments(
            points.data_ptr(), mask.data_ptr(), N, _rad2(radius),
            plan.queries_per_thread, plan.splits, part.data_ptr(),
            out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _kernels.check_status(status, "radius_moments")
    _kernels.count_launch("radius_moments")
    return out


def sorted_radius_moments_kernel(ps: torch.Tensor, ms: torch.Tensor,
                                 codes_s: torch.Tensor, radius,
                                 band: int = 8, tm: int = 512,
                                 tn: int = 1024) -> torch.Tensor:
    """Kernel K2 (replaces ops/normals.py:_banded_moments_split_kernel and
    :_banded_moments_kernel): banded moments of a Morton-sorted cloud with
    N % tm == N % tn == 0 and tm % 128 == 0, its int64 codes ascending;
    plain `sorted_radius_moments` on CPU. The kernel finds each tile's
    window start itself, by the rule of `banded_window_starts`."""
    device_type = _check("banded_moments", ps, ms)
    _kernels.check_tensors("banded_moments", ps, codes_s)
    N = ps.shape[0]
    if codes_s.dtype != torch.int64:
        raise TypeError("banded_moments: int64 Morton codes")
    if N % tm or N % tn or tm % 128 or codes_s.shape != (N,):
        raise ValueError(f"banded_moments: N={N} tm={tm} tn={tn}")
    if device_type == "cpu":
        return sorted_radius_moments(ps, ms, codes_s, radius, band, tm, tn)
    dev = ps.device
    out = torch.empty((N, 10), dtype=torch.float32, device=dev)
    if N == 0:
        return out
    band = min(band, N // tn)
    plan = moments_split_plan(N, band * tn, tm)
    part = torch.empty((plan.splits, N, 10), dtype=torch.float64, device=dev)
    with torch.cuda.device(dev):
        status = _kernels.library().aicp_banded_moments(
            ps.data_ptr(), ms.data_ptr(), N, codes_s.data_ptr(), tm, tn,
            band, _rad2(radius), plan.queries_per_thread, plan.splits,
            part.data_ptr(), out.data_ptr(),
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


# The f32 reciprocals of 3 and 6: PyTorch on CUDA divides by a host
# scalar as a product with its reciprocal (and XLA does too), so the solve
# takes that product on every device.
_THIRD = float(np.float32(1.0 / 3.0))
_SIXTH = float(np.float32(1.0 / 6.0))


def _sum3(v: torch.Tensor) -> torch.Tensor:
    """v[..., 0] + v[..., 1] + v[..., 2], in that order."""
    return v[..., 0] + v[..., 1] + v[..., 2]


def _f64(fn, x: torch.Tensor) -> torch.Tensor:
    """fn in float64, rounded to f32: the card's and the CPU's float64
    arccos and cos differ at most in their last bits, which the rounding
    hides but for the rare value at an f32 rounding boundary; their f32
    ones differ often."""
    return fn(x.double()).float()


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a x b, each component rounded once: the products of f32 values are
    exact in float64, so no device's multiply-add changes a bit."""
    return torch.linalg.cross(a.double(), b.double(), dim=-1).float()


def _eigh3x3_smallest(A: torch.Tensor):
    """Batched symmetric 3x3: eigenvalues (..., 3) ascending and the
    eigenvector of the smallest, by Smith's closed form and the largest
    cross product of two rows of A - l_min I (as in the JAX twin).

    Every step is an elementwise operation in a fixed order, so that the
    card and the CPU give the same bits, as they give the same moments:
    no reduction (whose order is the device's), no division by a host
    scalar, the cross products and the trigonometry rounded from float64."""
    tr = A[..., 0, 0] + A[..., 1, 1] + A[..., 2, 2]
    q = tr * _THIRD
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    B = A - q[..., None, None] * eye
    sq = (B * B).flatten(-2)
    p2 = sq[..., 0]
    for k in range(1, 9):
        p2 = p2 + sq[..., k]
    p = torch.sqrt(torch.clamp(p2 * _SIXTH, min=1e-30))
    # A zero covariance (a point with no neighbour but itself) gives r = 0,
    # curvature 0 and the +z normal, as the JAX twin does under jit.
    pm = torch.clamp(p, min=1e-30)
    r = _det3(B) / (2.0 * (pm * pm * pm))
    phi = _f64(torch.arccos, torch.clamp(r, -1.0, 1.0)) * _THIRD
    # l0 and l2: q + 2p cos(phi) and q + 2p cos(phi + 2 pi / 3)
    l0, l2 = q + 2.0 * p * _f64(torch.cos, torch.stack(
        [phi, phi + 2.0 * math.pi / 3.0]))
    l1 = tr - l0 - l2
    eigvals = torch.stack([l2, l1, l0], dim=-1)

    M = A - l2[..., None, None] * eye
    r0, r1, r2 = M[..., 0, :], M[..., 1, :], M[..., 2, :]
    cands = _cross(torch.stack([r0, r0, r1], dim=-2),
                   torch.stack([r1, r2, r2], dim=-2))
    best = torch.argmax(_sum3(cands * cands), dim=-1)
    v = torch.gather(cands, -2, best[..., None, None].expand(
        best.shape + (1, 3)))[..., 0, :]
    norm = torch.sqrt(_sum3(v * v))[..., None]
    up = eye[2]                      # degenerate (isotropic) case: +z
    v = torch.where(norm > 1e-12, v / torch.clamp(norm, min=1e-12), up)
    return eigvals, v


def _normals_from_cov(cov, points, mask, viewpoint):
    """(N, 3, 3) covariances -> (normals, curvature = l_min / sum(l),
    eigvals ascending): the smallest eigenvector, flipped toward
    `viewpoint` when given; masked rows get zeros."""
    eigvals, normal = _eigh3x3_smallest(cov)
    denom = torch.clamp(_sum3(eigvals), min=1e-12)
    curvature = torch.clamp(eigvals[..., 0], min=0.0) / denom
    if viewpoint is not None:
        flip = _sum3(normal * (viewpoint - points)) < 0
        normal = torch.where(flip[:, None], -normal, normal)
    normal = torch.where(mask[:, None], normal, 0.0)
    curvature = torch.where(mask, curvature, 0.0)
    return normal, curvature, eigvals


def moments_to_normals(M: torch.Tensor, points: torch.Tensor,
                       mask: torch.Tensor, viewpoint=None):
    """(N, 10) moments -> (normals (N,3), curvature (N,), n_neighbors (N,)):
    cov = E[xx^T] - mu mu^T, smallest eigenvector, normals flipped toward
    `viewpoint` when given.

    Each covariance entry E[ab] - mu_a mu_b is rounded once, as the JAX
    package's jitted code computes it (XLA contracts it into one fused
    multiply-add): mu_a mu_b is exact in float64 and so is the difference,
    so rounding that to f32 is the fused result. For a point whose
    neighbourhood is itself alone, the entries are then the rounding
    errors of its squared coordinates, not 0, and its normal and curvature
    follow that noise as JAX's do (ROADMAP Q3)."""
    cnt = torch.clamp(M[:, 9], min=1.0)
    mean = (M[:, 0:3] / cnt[:, None]).double()
    exx = M[:, 3:6] / cnt[:, None]
    exy = M[:, 6:9] / cnt[:, None]

    def entry(e, a, b):
        return (e.double() - mean[:, a] * mean[:, b]).float()

    cxy, cxz, cyz = entry(exy[:, 0], 0, 1), entry(exy[:, 1], 0, 2), \
        entry(exy[:, 2], 1, 2)
    cov = torch.stack([
        torch.stack([entry(exx[:, 0], 0, 0), cxy, cxz], dim=-1),
        torch.stack([cxy, entry(exx[:, 1], 1, 1), cyz], dim=-1),
        torch.stack([cxz, cyz, entry(exx[:, 2], 2, 2)], dim=-1),
    ], dim=-2)
    normal, curvature, _ = _normals_from_cov(cov, points, mask, viewpoint)
    return normal, curvature, M[:, 9]


def estimate_normals(points: torch.Tensor, mask: torch.Tensor, k: int,
                     viewpoint=None, approx: bool = False):
    """Per-point normals + curvature from the k-NN neighbourhood (self
    included): (normals (N, 3), curvature (N,), eigvals (N, 3) ascending),
    oriented toward `viewpoint` when given."""
    _, idx = knn(points, mask, points, mask, k, approx=approx)
    return normals_from_neighbors(points, mask, idx, viewpoint)


def normals_from_neighbors(points: torch.Tensor, mask: torch.Tensor,
                           idx: torch.Tensor, viewpoint=None):
    """Normals + curvature from a neighbour index (N, k): the covariance of
    each point's valid neighbours through `_normals_from_cov`. The sums
    run in float64 and round to f32 once, so the card's reduction order
    gives the CPU's covariance (and region growing the CPU's clusters)."""
    nbrs = points[idx].double()                          # (N, k, 3)
    w = (mask[idx] & mask[:, None]).double()[..., None]
    cnt = torch.clamp(w.sum(1), min=1.0)                 # (N, 1)
    mean = (nbrs * w).sum(1) / cnt
    centered = (nbrs - mean[:, None, :]) * w
    cov = torch.einsum("nki,nkj->nij", centered, centered) / cnt[..., None]
    return _normals_from_cov(cov.float(), points, mask, viewpoint)
