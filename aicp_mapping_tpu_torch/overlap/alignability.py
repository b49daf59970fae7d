"""Alignability: geometric constraint analysis for failure prediction,
PyTorch port of `aicp_mapping_tpu.overlap.alignability`.

  1. voxel-downsample and plane-segment both overlap-region clouds (kNN
     normals, min-label propagation, small-cluster filter, the largest
     `max_clusters` clusters);
  2. match planes across the clouds by oriented-bounding-box co-membership
     and a normals-centroid angle under `max_centroid_angle_deg`, each
     reading cluster kept by the reference cluster that overlaps it most;
  3. PCA of the matched reference normals (with mirrored copies, so the
     covariance is their second moment): alignability = 100 * l_min / l_max,
     near 0 when the matched constraints span a degenerate set of
     directions.

The cross-cluster box counts are one (C, N) @ (N, C) product, as the JAX
package leaves them to XLA.

The body is cut at its two eigen-solves, whose error checks read the
host: `_cluster_moments` | `torch.linalg.eigh` | `_cluster_boxes` (the
three make `_cluster_stats`), and `_match_planes` | `torch.linalg.eigvalsh`
| `_alignability`. `alignability_filter` runs the parts in order; the risk
stage's captured pieces on the card (`pipeline/risk_graph.py`) replay the
parts between the solves.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import se3
from ..ops.knn import knn
from ..ops.normals import normals_from_neighbors
from ..ops.segmentation import (compact_labels, filter_small_clusters,
                                label_propagation_clusters)
from ..ops.voxel import voxel_downsample

_BIG = 3.4e38


class AlignOptions(NamedTuple):
    """`alignability_filter`'s options, with its defaults."""
    voxel_size: float = 0.08
    ds_capacity: int = 8192
    max_clusters: int = 32
    normal_k: int = 30
    graph_k: int = 15
    smoothness_deg: float = 3.0
    min_cluster_size: int = 50
    max_centroid_angle_deg: float = 20.0
    z_scale: float = 3.0


class Planes(NamedTuple):
    """A segmented cloud: downsampled points, their normals, cluster labels
    in [0, max_clusters) (-1: none) and which clusters exist."""
    points: torch.Tensor
    normals: torch.Tensor
    labels: torch.Tensor
    valid: torch.Tensor


class Moments(NamedTuple):
    """Per-cluster statistics up to the eigen-solve of `cov`, and the
    points' segment ids, clamped labels, centred coordinates and validity
    (1.0 in a cluster) that the box extents take after it."""
    size: torch.Tensor
    normals_centroid: torch.Tensor
    mean: torch.Tensor
    cov: torch.Tensor
    seg: torch.Tensor
    lab: torch.Tensor
    centered: torch.Tensor
    valid: torch.Tensor


def _segment(values, seg, n_seg: int, reduce: str):
    """Per-segment sum / amin / amax of (N, ...) rows into (n_seg, ...);
    a segment with no member is 0."""
    out = torch.zeros((n_seg,) + values.shape[1:], dtype=values.dtype,
                      device=values.device)
    idx = seg.reshape((-1,) + (1,) * (values.ndim - 1)).expand(values.shape)
    return out.scatter_reduce(0, idx, values, reduce, include_self=False)


def _cluster_moments(points, normals, labels, n_clusters: int) -> Moments:
    """Per-cluster size, normals centroid (not normalized), mean and
    covariance."""
    seg = torch.where(labels >= 0, labels, n_clusters)
    valid = (labels >= 0).to(points.dtype)
    C1 = n_clusters + 1
    size = _segment(valid, seg, C1, "sum")[:n_clusters]
    size_safe = torch.clamp(size, min=1.0)
    normals_centroid = _segment(normals * valid[:, None], seg, C1,
                                "sum")[:n_clusters] / size_safe[:, None]
    mean = _segment(points * valid[:, None], seg, C1,
                    "sum")[:n_clusters] / size_safe[:, None]

    lab = torch.clamp(labels, 0, n_clusters - 1)
    centered = (points - mean[lab]) * valid[:, None]
    outer = centered[:, :, None] * centered[:, None, :]
    cov = _segment(outer, seg, C1, "sum")[:n_clusters] / size_safe[:, None,
                                                                   None]
    return Moments(size, normals_centroid, mean, cov, seg, lab, centered,
                   valid)


def _cluster_boxes(m: Moments, evecs, n_clusters: int):
    """`_cluster_stats` from the covariances' eigenvectors `evecs`
    (ascending): the OBBs' axes and extents."""
    # columns major, middle, minor (local z is the plane normal); an axis's
    # sign does not change box membership
    axes = torch.flip(evecs, dims=[-1])
    local = torch.einsum("nj,nji->ni", m.centered, axes[m.lab])
    ok = m.valid[:, None] > 0
    C1 = n_clusters + 1
    lo = _segment(torch.where(ok, local, _BIG), m.seg, C1,
                  "amin")[:n_clusters]
    hi = _segment(torch.where(ok, local, -_BIG), m.seg, C1,
                  "amax")[:n_clusters]
    lo = torch.where(m.size[:, None] > 0, lo, 0.0)
    hi = torch.where(m.size[:, None] > 0, hi, 0.0)
    return m.size, m.normals_centroid, m.mean, axes, lo, hi


def _cluster_stats(points, normals, labels, n_clusters: int):
    """Per-cluster size, normals centroid (not normalized) and OBB (mean,
    axes major-middle-minor as columns, lo / hi extents in the box frame)."""
    m = _cluster_moments(points, normals, labels, n_clusters)
    _, evecs = torch.linalg.eigh(m.cov)
    return _cluster_boxes(m, evecs, n_clusters)


def _points_in_boxes(points, labels, n_clusters_pts: int, box_mean,
                     box_axes, box_lo, box_hi, z_scale: float):
    """counts[i, j] = points of cluster j inside box i, its plane-normal
    extent enlarged `z_scale` times."""
    lo = torch.cat([box_lo[:, :2], box_lo[:, 2:] * z_scale], dim=1)
    hi = torch.cat([box_hi[:, :2], box_hi[:, 2:] * z_scale], dim=1)
    rel = points[None, :, :] - box_mean[:, None, :]              # (C, N, 3)
    local = torch.einsum("cnj,cji->cni", rel, box_axes)
    inside = ((local >= lo[:, None, :]) & (local <= hi[:, None, :])).all(-1)
    onehot = (labels[:, None] == torch.arange(
        n_clusters_pts, device=points.device)[None, :]).to(points.dtype)
    return inside.to(points.dtype) @ onehot                      # (C, Cj)


def _segment_cloud(points, mask, pose, o: AlignOptions) -> Planes:
    """Downsample, kNN normals toward the sensor, region growing over the
    same kNN build (its first `graph_k` columns are the `graph_k`-NN), the
    cluster filter and the top-`max_clusters` compaction."""
    dpts, dmask = voxel_downsample(points, mask, o.voxel_size, o.ds_capacity)
    _, idx = knn(dpts, dmask, dpts, dmask, max(o.normal_k, o.graph_k))
    normals, curvature, _ = normals_from_neighbors(
        dpts, dmask, idx[:, :o.normal_k], se3.translation(pose))
    labels = label_propagation_clusters(
        dpts, dmask, normals, curvature, k=o.graph_k,
        smoothness_deg=o.smoothness_deg, neighbor_idx=idx)
    keep = filter_small_clusters(labels, dmask, o.min_cluster_size)
    labels = torch.where(keep, labels, -1)
    comp, cvalid, _ = compact_labels(labels, keep, o.max_clusters)
    return Planes(dpts, normals, comp, cvalid)


def _match_planes(a: Planes, stats_a, b: Planes, stats_b, o: AlignOptions):
    """Plane matching of A (the reference) and B by box overlap and
    normals-centroid angle, each B cluster kept by the A cluster that
    overlaps it most, and the second moment `m2` (3, 3) of the matched
    reference normals. Returns (m2, diagnostics without the eigenvalues)."""
    C = o.max_clusters
    size_a, nc_a, mean_a, axes_a, lo_a, hi_a = stats_a
    size_b, nc_b, mean_b, axes_b, lo_b, hi_b = stats_b
    # plane matching: normals-centroid angle (degrees) and box overlap
    na = torch.linalg.norm(nc_a, dim=-1)
    nb = torch.linalg.norm(nc_b, dim=-1)
    dots = nc_a @ nc_b.T / torch.clamp(na[:, None] * nb[None, :], min=1e-12)
    ang = torch.rad2deg(torch.arccos(torch.clamp(dots, -1.0, 1.0)))
    cnt_b_in_a = _points_in_boxes(b.points, b.labels, C, mean_a, axes_a,
                                  lo_a, hi_a, o.z_scale)         # (Ca, Cb)
    cnt_a_in_b = _points_in_boxes(a.points, a.labels, C, mean_b, axes_b,
                                  lo_b, hi_b, o.z_scale)         # (Cb, Ca)
    frac_b = cnt_b_in_a / torch.clamp(size_b[None, :], min=1.0)
    frac_a = cnt_a_in_b.T / torch.clamp(size_a[:, None], min=1.0)
    box_overlap = frac_a * frac_b * 100.0

    pair_ok = ((ang < o.max_centroid_angle_deg) & a.valid[:, None]
               & b.valid[None, :])
    scored = torch.where(pair_ok, box_overlap, -1.0)
    best_ov, best_j = scored.max(dim=1)          # first maximum, as argmax
    has_match = best_ov > 0.0

    # conflict resolution: each B cluster keeps the A cluster that
    # overlaps it most
    dtype, dev = a.points.dtype, a.points.device
    cols = torch.arange(C, device=dev)
    claim = torch.where(has_match[:, None] & (best_j[:, None] == cols[None]),
                        best_ov[:, None], -1.0)                  # (Ca, Cb)
    best_claim, winner_a = claim.max(dim=0)
    claimed = best_claim > 0.0
    matched_a = torch.zeros(C, dtype=dtype, device=dev)
    matched_a = matched_a.scatter_reduce(
        0, torch.where(claimed, winner_a, C - 1), claimed.to(dtype),
        "amax") > 0

    # PCA of the matched reference normals (mirrored: zero mean)
    point_matched = (a.labels >= 0) & matched_a[torch.clamp(a.labels, 0,
                                                            C - 1)]
    w = point_matched.to(dtype)
    m2 = torch.einsum("n,ni,nj->ij", w, a.normals, a.normals)
    return m2, {"matched_a": matched_a, "box_overlap": box_overlap,
                "centroid_angle": ang, "n_matched_points": w.sum()}


def _alignability(evals, n_matched_points):
    """100 * l_min / l_max of `m2`'s eigenvalues (ascending); 0 without a
    matched point."""
    lam_min = torch.clamp(evals[0], min=0.0)
    lam_max = torch.clamp(evals[2], min=1e-12)
    return torch.where(n_matched_points > 0, 100.0 * lam_min / lam_max, 0.0)


def alignability_filter(points_a, mask_a, pose_a, points_b, mask_b, pose_b,
                        voxel_size: float = 0.08, ds_capacity: int = 8192,
                        max_clusters: int = 32, normal_k: int = 30,
                        graph_k: int = 15, smoothness_deg: float = 3.0,
                        min_cluster_size: int = 50,
                        max_centroid_angle_deg: float = 20.0,
                        z_scale: float = 3.0):
    """Returns (alignability in [0, 100] as a 0-d tensor, diagnostics).

    A is the reference cloud and B the reading, both in the world frame
    (the FOV-overlap subsets of the two)."""
    o = AlignOptions(voxel_size, ds_capacity, max_clusters, normal_k,
                     graph_k, smoothness_deg, min_cluster_size,
                     max_centroid_angle_deg, z_scale)
    a = _segment_cloud(points_a, mask_a, pose_a, o)
    b = _segment_cloud(points_b, mask_b, pose_b, o)
    stats_a = _cluster_stats(a.points, a.normals, a.labels, o.max_clusters)
    stats_b = _cluster_stats(b.points, b.normals, b.labels, o.max_clusters)
    m2, diagnostics = _match_planes(a, stats_a, b, stats_b, o)
    evals = torch.linalg.eigvalsh(m2)                            # ascending
    diagnostics["eigvals"] = evals
    return _alignability(evals, diagnostics["n_matched_points"]), diagnostics
