"""Plane segmentation, PyTorch port of `aicp_mapping_tpu.ops.segmentation`.

- The planes-only prefilter `plane_segmentation_filter`: with
  `method="hough"` and an `out_capacity` the fused sorted-space prefilter
  (`_hough_prefilter_sorted`); with `method="region_growing"` an exact kNN
  build shared by kNN normals and min-label propagation; without an
  `out_capacity` the uncompacted result (hough: radius normals and
  `hough_plane_labels`).
- Region growing as the alignability filter runs it:
  `label_propagation_clusters` (min-label propagation over the kNN
  smoothness graph: on the card one launch of the label-propagation kernel,
  `propagate_labels_kernel`; its plain twin `propagate_labels`),
  `filter_small_clusters` and `compact_labels`.

The output order is the cluster-balanced round-robin order cut to
`out_capacity`, so which points survive depends on every sort's tie-break:
all sorts are stable, and the two-key sorts use one composite int64 key.
"""
from __future__ import annotations

import contextlib
import functools
import threading
from typing import NamedTuple

import torch

from .. import _kernels
from ..utils import graphs
from ..utils.timing import span
from .banded_nn import SENTINEL, morton_codes
from .knn import knn
from .normals import (banded_by_shape, moments_to_normals,
                      normals_from_neighbors, radius_moments_kernel,
                      radius_normals, sorted_radius_moments_kernel)

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


def _compact_unique_keys(keys: torch.Tensor,
                         valid: torch.Tensor) -> torch.Tensor:
    """Map non-negative keys to dense ids [0, n_unique) in key order by one
    sort; invalid entries -> -1."""
    big = 2**31 - 1
    k = torch.where(valid, keys, big)
    ks, order = torch.sort(k, stable=True)
    seg = torch.cumsum(_run_starts(ks).to(torch.int64), 0) - 1
    inv = torch.empty_like(seg)
    inv[order] = torch.where(ks < big, seg, -1)
    return inv


def hough_plane_labels(points, mask, normals, curvature, normal_bins: int = 6,
                       offset_res: float = 0.15,
                       curvature_thresh: float = 1.0) -> torch.Tensor:
    """Plane clustering by quantized (normal direction, plane offset) cells:
    two points share a label iff they vote for the same cell. Normals must
    be consistently oriented. Returns dense labels (N,) int64, -1 for
    invalid or high-curvature points."""
    key = _hough_key(points, normals, normal_bins, offset_res)
    return _compact_unique_keys(key, mask & (curvature <= curvature_thresh))


def plane_segmentation_filter(points, mask, viewpoint=None, normal_k=30,
                              graph_k=15, smoothness_deg=3.0,
                              curvature_thresh=1.0, min_cluster_size=50,
                              out_capacity=None, method="hough",
                              normal_radius=0.4):
    """Planes-only retention on an already-downsampled cloud: (points,
    mask, normals, curvature, labels). With `out_capacity` the kept points
    are compacted to that capacity in cluster-balanced round-robin order
    (`_balanced_compaction_perm`); without it every point stays where it
    was and the mask says which are kept.

    method="hough": radius normals + quantized (normal, offset) plane
    cells. method="region_growing": one exact kNN build (`normal_k`
    neighbours, self included) shared by kNN normals and min-label
    propagation over its first `graph_k` columns (`smoothness_deg`)."""
    if method == "hough" and out_capacity is not None:
        return _hough_prefilter_sorted(points, mask, viewpoint, normal_radius,
                                       curvature_thresh, min_cluster_size,
                                       out_capacity)
    if method == "hough":
        normals, curvature, _ = radius_normals(points, mask, normal_radius,
                                               viewpoint)
        labels = hough_plane_labels(points, mask, normals, curvature,
                                    curvature_thresh=curvature_thresh)
    elif method == "region_growing":
        _, nbr_idx = knn(points, mask, points, mask, normal_k)
        normals, curvature, _ = normals_from_neighbors(points, mask, nbr_idx,
                                                       viewpoint)
        labels = label_propagation_clusters(
            points, mask, normals, curvature, k=graph_k,
            smoothness_deg=smoothness_deg, curvature_thresh=curvature_thresh,
            neighbor_idx=nbr_idx)
    else:
        raise ValueError(f"unknown segmentation method {method!r}")
    keep = filter_small_clusters(labels, mask, min_cluster_size)
    if out_capacity is None:
        return points, keep, normals, curvature, labels
    perm = _balanced_compaction_perm(labels, keep)[:out_capacity]
    return points[perm], keep[perm], normals[perm], curvature[perm], \
        labels[perm]


def _balanced_compaction_perm(labels: torch.Tensor,
                              keep: torch.Tensor) -> torch.Tensor:
    """Cluster-balanced, spatially spread selection order for capacity
    truncation: kept points round-robin across clusters (rank within
    cluster), each cluster in bit-reversed positional order, so a cluster
    that keeps only a prefix keeps a uniformly spread subset; unkept rows
    last. JAX's three sorts, stable, the two-key one by a composite key."""
    n = labels.shape[0]
    big = 2**30
    iota = torch.arange(n, device=labels.device)
    lbl = torch.where(keep, labels, big)
    # group by cluster (stable: spatial order within each cluster)
    lbl1, idx1 = torch.sort(lbl, stable=True)
    pos = iota - torch.cummax(torch.where(_run_starts(lbl1), iota, 0),
                              0).values
    # bit-reversed position within each cluster; the grouping, and so each
    # row's rank within its cluster, stays as it was
    idx2 = idx1[_stable_perm(lbl1 * (1 << 17) + _bitrev17(pos))]
    # round-robin across clusters
    sel_key = torch.where(keep[idx2], pos, big)
    return idx2[_stable_perm(sel_key)]


# Rounds run by label propagation since the last reset. The eager loop
# (the CPU's) counts its rounds here, one host read each; the kernel adds
# its rounds to a device counter per card, which `propagation_rounds` reads
# only when asked. The lock: an App's finalizer thread may run a prefilter
# while its dispatch thread runs another.
_propagation = {"calls": 0, "rounds": 0}
_device_rounds: dict = {}
_propagation_lock = threading.Lock()


def propagation_rounds() -> dict:
    """Calls of `label_propagation_clusters` and rounds run, the kernel's
    included (reading them waits for the card)."""
    with _propagation_lock:
        out = dict(_propagation)
        counters = list(_device_rounds.values())
    for c in counters:
        torch.cuda.synchronize(c.device)
        out["rounds"] += int(c.item())
    return out


def reset_propagation_rounds() -> None:
    with _propagation_lock:
        _propagation.update(calls=0, rounds=0)
        counters = list(_device_rounds.values())
    for c in counters:
        torch.cuda.synchronize(c.device)
        c.zero_()
        torch.cuda.synchronize(c.device)


def _count_propagation(key: str) -> None:
    with _propagation_lock:
        _propagation[key] += 1


def _rounds_counter(device: torch.device) -> torch.Tensor:
    with _propagation_lock:
        if device not in _device_rounds:
            _device_rounds[device] = torch.zeros(1, dtype=torch.int64,
                                                 device=device)
        return _device_rounds[device]


def propagate_labels(idx, pull_ok, mask, max_iters: int = 64,
                     jumps_per_iter: int = 6) -> torch.Tensor:
    """Plain twin of the label-propagation kernel, on any device: the
    rounds of `label_propagation_clusters` given its neighbour lists `idx`
    (N, k) and their pullable entries `pull_ok` (N, k). Each round is one
    neighbour pull and `jumps_per_iter` pointer jumps L <- L[L], as in the
    JAX while_loop; the loop reads `changed` once per round (a span
    "aicp.seg.propagation_read" of the port's tracer, one a read) and stops
    when nothing changed or after `max_iters` rounds, so it returns the
    while_loop's labels: (N,) int64, -1 where `mask` is false."""
    n = mask.shape[0]
    labels = torch.where(mask, torch.arange(n, device=mask.device), n)
    for _ in range(max_iters):
        pulled = torch.where(pull_ok, labels[idx], n).amin(1)
        new = torch.minimum(labels, pulled)
        for _ in range(jumps_per_iter):
            jumped = new[torch.clamp(new, 0, n - 1)]
            new = torch.where(new < n, torch.minimum(new, jumped), n)
        new = torch.where(mask, new, n)
        with span("aicp.seg.propagation_read"):
            changed = bool((new != labels).any())
        labels = new
        _count_propagation("rounds")
        if not changed:
            break
    return torch.where(mask, labels, -1)


# The label-propagation kernel (_kernels/csrc/propagation.cu): one block,
# its labels as 16-bit indices in shared memory where they fit. Its modes
# and their bytes, as `layout` there computes them.
PROPAGATION_SMEM = 232448        # shared memory a block may opt into, sm_90
PROPAGATION_MAX_K = 127


class PropagationPlan(NamedTuple):
    mode: int                    # 0 all shared, 1 list global, 2 all global
    smem_bytes: int
    scratch_bytes: int


def _align16(b: int) -> int:
    return (b + 15) // 16 * 16


@functools.lru_cache(maxsize=None)
def propagation_plan(n: int, k: int) -> PropagationPlan:
    """The kernel's storage for n points of k neighbours, from n and k
    alone: labels (three buffers), a byte a point and the compacted
    neighbour list all in shared memory where they fit (mode 0), the list
    in device memory where only the rest fits (mode 1), 32-bit and all in
    device memory beyond (mode 2)."""
    labels, meta = _align16(6 * n), _align16(n)
    lst = _align16(2 * n * k)
    if n <= 65535 and labels + meta + lst <= PROPAGATION_SMEM:
        return PropagationPlan(0, labels + meta + lst, 0)
    if n <= 65535 and labels + meta <= PROPAGATION_SMEM:
        return PropagationPlan(1, labels + meta, lst)
    return PropagationPlan(2, 0, _align16(12 * n) + meta
                           + _align16(4 * n * k))


def propagate_labels_kernel(idx, pull_ok, mask, max_iters: int = 64,
                            jumps_per_iter: int = 6) -> torch.Tensor:
    """The label-propagation kernel: `propagate_labels`' result in one
    launch on the caller's stream, with no host read; its rounds go to the
    card's counter (`propagation_rounds`). Plain `propagate_labels` on the
    CPU. `idx` may be a column slice of a wider contiguous build."""
    device_type = _kernels.check_tensors("label_propagation", pull_ok, mask)
    n, k = pull_ok.shape
    if idx.device != pull_ok.device:
        raise ValueError(f"label_propagation: idx on {idx.device}")
    if idx.shape != (n, k) or mask.shape != (n,) or (
            n > 1 and k > 0 and idx.stride(1) != 1):
        raise ValueError(f"label_propagation: idx {tuple(idx.shape)} "
                         f"strides {idx.stride()}, pull_ok {(n, k)}, mask "
                         f"{tuple(mask.shape)}")
    if pull_ok.dtype != torch.bool or mask.dtype != torch.bool:
        raise TypeError("label_propagation: bool pull_ok and mask")
    if k > PROPAGATION_MAX_K:
        raise ValueError(f"label_propagation: k={k} > {PROPAGATION_MAX_K}")
    if device_type == "cpu":
        return propagate_labels(idx, pull_ok, mask, max_iters,
                                jumps_per_iter)
    if idx.dtype != torch.int64:
        raise TypeError("label_propagation: int64 indices on the card")
    dev = mask.device
    plan = propagation_plan(n, k)
    out = torch.empty(n, dtype=torch.int64, device=dev)
    scratch = torch.empty(plan.scratch_bytes, dtype=torch.uint8, device=dev)
    counter = _rounds_counter(dev)
    # under a CUDA graph's capture the launch is only recorded: no span,
    # and each of the graph's replays counts it
    captured = graphs.capturing(dev)
    with (contextlib.nullcontext() if captured
          else span("aicp.seg.propagation_launch")), torch.cuda.device(dev):
        status = _kernels.library().aicp_label_propagation(
            idx.data_ptr(), idx.stride(0) if n > 1 else k, k,
            pull_ok.data_ptr(), mask.data_ptr(), n, max_iters,
            jumps_per_iter, plan.mode, scratch.data_ptr(), out.data_ptr(),
            counter.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _kernels.check_status(status, "label_propagation")
    graphs.counted(dev, _kernels.count_launch, "label_propagation")
    return out


@functools.lru_cache(maxsize=None)
def _cos_threshold(smoothness_deg: float) -> float:
    """cos(smoothness_deg) in f32, as JAX computes it, once per angle: a
    host value, so that no device work reads it back."""
    return torch.cos(torch.deg2rad(torch.tensor(
        smoothness_deg, dtype=torch.float32))).item()


def smoothness_graph(points, mask, normals, curvature, k: int = 15,
                     smoothness_deg: float = 3.0,
                     curvature_thresh: float = 1.0, neighbor_idx=None):
    """Region growing's graph: the k neighbours `idx` (N, k) of each point
    (the first k columns of `neighbor_idx`, a kNN build, where given) and
    `pull_ok` (N, k), which of them pass labels to it: both points valid,
    normals within `smoothness_deg`, the neighbour at most
    `curvature_thresh` curved."""
    if neighbor_idx is None:
        _, idx = knn(points, mask, points, mask, k)
    else:
        idx = neighbor_idx[:, :k]
    cos_thresh = _cos_threshold(smoothness_deg)
    dots = torch.einsum("nd,nkd->nk", normals, normals[idx]).abs()
    nbr_ok = (dots >= cos_thresh) & mask[:, None] & mask[idx]
    can_forward = (curvature <= curvature_thresh) & mask
    return idx, nbr_ok & can_forward[idx]


def label_propagation_clusters(points, mask, normals, curvature, k: int = 15,
                               smoothness_deg: float = 3.0,
                               curvature_thresh: float = 1.0,
                               max_iters: int = 64, neighbor_idx=None,
                               jumps_per_iter: int = 6) -> torch.Tensor:
    """Min-label propagation over the smoothness graph: labels (N,) int64,
    the minimum point index of each cluster, -1 for invalid points.

    Two points share a label iff a chain of kNN pairs with normals within
    `smoothness_deg` joins them; points over `curvature_thresh` may join
    but do not forward labels (`smoothness_graph`). The rounds are
    `propagate_labels_kernel`'s: on the card one launch (a span
    "aicp.seg.propagation_launch"), on the CPU the eager loop with a host
    read a round; both return the JAX while_loop's labels.
    `neighbor_idx` (N, >= k) reuses a kNN build (its first k columns)."""
    idx, pull_ok = smoothness_graph(points, mask, normals, curvature, k,
                                    smoothness_deg, curvature_thresh,
                                    neighbor_idx)
    graphs.counted(mask.device, _count_propagation, "calls")
    return propagate_labels_kernel(idx, pull_ok, mask, max_iters,
                                   jumps_per_iter)


def _segment_sizes(labels, mask, n: int) -> torch.Tensor:
    """(n + 1,) count of valid points per root id; id n collects the rest."""
    seg = torch.where(labels >= 0, labels, n)
    return torch.zeros(n + 1, dtype=torch.int64, device=labels.device
                       ).index_add_(0, seg, mask.to(torch.int64))


def filter_small_clusters(labels, mask, min_cluster_size: int = 50,
                          k: int = 0) -> torch.Tensor:
    """Mask out points whose cluster has fewer than `min_cluster_size`
    valid points."""
    n = labels.shape[0]
    sizes = _segment_sizes(labels, mask, n)
    keep = sizes[torch.clamp(labels, 0, n)] >= min_cluster_size
    return mask & keep & (labels >= 0)


def compact_labels(labels, mask, max_clusters: int):
    """Rank clusters by size and relabel them [0, max_clusters); the rest
    -> -1. Equal sizes rank by lower root id (`jax.lax.top_k`'s order; a
    stable descending sort here). Returns (labels (N,), cluster_valid (C,),
    cluster_sizes (C,))."""
    n = labels.shape[0]
    valid_pt = (labels >= 0) & mask
    sizes = _segment_sizes(torch.where(valid_pt, labels, -1), mask, n)[:n]
    top_sizes, top_roots = torch.sort(sizes, descending=True, stable=True)
    top_sizes, top_roots = top_sizes[:max_clusters], top_roots[:max_clusters]
    cluster_valid = top_sizes > 0
    rank_of_root = torch.full((n + 1,), -1, dtype=torch.int64,
                              device=labels.device)
    rank_of_root[torch.where(cluster_valid, top_roots, n)] = torch.where(
        cluster_valid, torch.arange(max_clusters, device=labels.device), -1)
    comp = rank_of_root[torch.clamp(labels, 0, n)]
    return torch.where(valid_pt, comp, -1), cluster_valid, top_sizes
