"""Planes-only prefilter, PyTorch port of the hough path of
`aicp_mapping_tpu.ops.segmentation`.

Only `method="hough"` with an `out_capacity` is ported: the fused
sorted-space prefilter (`_hough_prefilter_sorted`). Region growing and the
uncompacted hough path wait for ROADMAP Q1 #11.

The output order is the cluster-balanced round-robin order cut to
`out_capacity`, so which points survive depends on every sort's tie-break:
all sorts are stable, and the two-key sorts use one composite int64 key.
"""
from __future__ import annotations

import torch

from .banded_nn import SENTINEL, morton_codes
from .normals import (banded_by_shape, moments_to_normals,
                      radius_moments_kernel, sorted_radius_moments_kernel)

_BIG = 3.4e38


def _hough_key(points: torch.Tensor, normals: torch.Tensor,
               normal_bins: int, offset_res: float) -> torch.Tensor:
    """Quantized (normal direction, plane offset) cell key, < 2^31."""
    q = torch.round(normals * normal_bins).to(torch.int64) + normal_bins
    B = 2 * normal_bins + 2
    d = (normals * points).sum(-1)
    dq = torch.clamp(torch.round(d / offset_res), -2047, 2047)
    return ((q[:, 0] * B + q[:, 1]) * B + q[:, 2]) * 4096 \
        + (dq.to(torch.int64) + 2048)


def _bitrev17(x: torch.Tensor) -> torch.Tensor:
    """Reverse the low 17 bits (capacities up to 131072)."""
    r = torch.zeros_like(x)
    for i in range(17):
        r = r | (((x >> i) & 1) << (16 - i))
    return r


def _stable_perm(key: torch.Tensor) -> torch.Tensor:
    return torch.sort(key, stable=True).indices


def _run_starts(k: torch.Tensor) -> torch.Tensor:
    s = torch.ones_like(k, dtype=torch.bool)
    s[1:] = k[1:] != k[:-1]
    return s


def moments_for(ps: torch.Tensor, ms: torch.Tensor, codes_s: torch.Tensor,
                radius) -> torch.Tensor:
    """Neighbourhood moments of a Morton-sorted cloud: banded for
    n >= 16,384 in whole 1024-blocks, exhaustive otherwise."""
    if banded_by_shape(ps.shape[0]):
        return sorted_radius_moments_kernel(ps, ms, codes_s, radius)
    return radius_moments_kernel(ps, ms, radius)


def _hough_prefilter_sorted(points, mask, viewpoint, normal_radius,
                            curvature_thresh, min_cluster_size,
                            out_capacity: int, normal_bins: int = 6,
                            offset_res: float = 0.15):
    """Morton sort -> radius moments -> normals -> hough plane binning ->
    small-cluster filter -> cluster-balanced compaction. Returns
    (points (C,3), mask (C,), normals (C,3), curvature (C,), labels (C,))
    with kept points compacted to the front in round-robin order."""
    n = points.shape[0]
    dev = points.device
    iota = torch.arange(n, device=dev)

    # 1. Morton sort
    origin = torch.where(mask[:, None], points, _BIG).amin(0)
    codes = morton_codes(points, mask, origin, 2.0)
    codes_s, perm = torch.sort(codes, stable=True)
    ps = points[perm]
    ms = codes_s != SENTINEL

    # 2. radius moments in sorted space -> normals / curvature
    M = moments_for(ps, ms, codes_s, normal_radius)
    normals, curvature, _ = moments_to_normals(M, ps, ms, viewpoint)

    # 3. hough plane key
    valid = ms & (curvature <= curvature_thresh)
    hkey = torch.where(valid, _hough_key(ps, normals, normal_bins,
                                         offset_res), SENTINEL)

    # 4. cluster-grouping sort (stable: spatial order within runs)
    p2 = _stable_perm(hkey)
    k2 = hkey[p2]
    cols2 = torch.cat([ps, normals, curvature[:, None]], dim=1)[p2]  # (n, 7)
    valid2 = k2 != SENTINEL
    is_start = _run_starts(k2)
    is_end = torch.ones_like(is_start)
    is_end[:-1] = is_start[1:]
    label = torch.cumsum(is_start.to(torch.int64), 0) - 1
    start_pos = torch.cummax(torch.where(is_start, iota, 0), 0).values
    end_pos = torch.flip(torch.cummin(torch.flip(
        torch.where(is_end, iota, n - 1), [0]), 0).values, [0])
    keep = valid2 & (end_pos - start_pos + 1 >= min_cluster_size)
    pos = iota - start_pos

    # 5. bit-reversed order within each cluster, key (label, bitrev(pos))
    lbl_k = torch.where(keep, label, SENTINEL)
    p3 = _stable_perm(lbl_k * (1 << 17) + _bitrev17(pos))
    k3 = lbl_k[p3]
    cols3 = cols2[p3]
    l3 = label[p3]
    rank = iota - torch.cummax(torch.where(_run_starts(k3), iota, 0),
                               0).values
    kept3 = k3 != SENTINEL
    rank_k = torch.where(kept3, rank, SENTINEL)

    # 6. round-robin across clusters: key (rank, label)
    p4 = _stable_perm(rank_k * (1 << 32) + k3)
    cols4 = cols3[p4][:out_capacity]
    l4 = torch.where(kept3, l3, -1)[p4][:out_capacity]
    out_mask = iota[:out_capacity] < kept3.sum()
    cols4 = torch.where(out_mask[:, None], cols4, 0.0)
    return (cols4[:, 0:3].contiguous(), out_mask,
            cols4[:, 3:6].contiguous(), cols4[:, 6].contiguous(),
            torch.where(out_mask, l4, -1))


def plane_segmentation_filter(points, mask, viewpoint=None, normal_k=30,
                              graph_k=15, smoothness_deg=3.0,
                              curvature_thresh=1.0, min_cluster_size=50,
                              out_capacity=None, method="hough",
                              normal_radius=0.4):
    """Planes-only retention on an already-downsampled cloud; returns
    (points, mask, normals, curvature, labels) compacted to `out_capacity`
    in cluster-balanced round-robin order. `normal_k`, `graph_k` and
    `smoothness_deg` belong to region growing, which is not ported."""
    if method != "hough" or out_capacity is None:
        raise NotImplementedError(
            f"plane_segmentation_filter(method={method!r}, out_capacity="
            f"{out_capacity!r}): only the compacted hough prefilter is "
            "ported; region growing and the uncompacted path are ROADMAP "
            "Q1 #11")
    return _hough_prefilter_sorted(points, mask, viewpoint, normal_radius,
                                   curvature_thresh, min_cluster_size,
                                   out_capacity)
