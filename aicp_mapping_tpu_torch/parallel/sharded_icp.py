"""Distributed ICP over a process mesh, PyTorch port of
`aicp_mapping_tpu.parallel.sharded_icp`.

Two layouts, both SPMD: every rank of the mesh calls the function with the
same (replicated) arguments and takes its own contiguous rows of the
sharded operand, as `PartitionSpec(axis)` lays them out.

- `sharded_point_to_plane_icp`: the reading sharded, the reference
  replicated (compute scaling). Each iteration `psum`s the trim histograms
  (two rounds of 128 bins), the 6x6 system, the 6-vector and the two
  inlier sums — 1,208 bytes, independent of the point count.
- `map_sharded_point_to_plane_icp`: the reference (map) sharded in blocks,
  the reading replicated (memory scaling). Each iteration reduces the
  global nearest neighbour across blocks: (M,) `pmin` twice and an (M, 6)
  `psum`, 32 bytes per reading point.

Both run the single-device solver `registration.icp.point_to_plane_icp`
with `ICPConfig.axis_name` set, so every matcher (K1, the banded K5) runs
on each rank's own shard, chosen by the shard's shapes.
"""
from __future__ import annotations

import dataclasses

import torch

from ..registration.icp import ICPConfig, ICPResult, point_to_plane_icp


def histogram_quantile(values, weights, q, lo, hi, axis_name=None,
                       bins: int = 512, mesh=None):
    """Weighted quantile from a fixed-bin histogram on [lo, hi]: the right
    edge of the first bin whose cumulative weight reaches q x the total.
    With `axis_name` the histogram is `psum`-reduced over that axis of
    `mesh`, so every rank returns the same global threshold."""
    span = max(float(hi) - float(lo), 1e-12)
    idx = torch.clamp(((values - lo) / span * bins).to(torch.int64), 0,
                      bins - 1)
    hist = torch.zeros((bins,), dtype=torch.float32, device=values.device)
    hist.index_add_(0, idx, weights.to(torch.float32))
    if axis_name is not None:
        hist = mesh.psum(hist, axis_name)
    cdf = torch.cumsum(hist, 0)
    total = torch.clamp(cdf[-1], min=1e-12)
    bin_i = torch.argmax((cdf >= q * total).to(torch.int32))
    return lo + (bin_i.to(torch.float32) + 1.0) / bins * span


def _on(mesh, *tensors):
    return [t.to(mesh.device).contiguous() for t in tensors]


def sharded_point_to_plane_icp(mesh, reading_points, reading_mask,
                               reference_points, reference_normals,
                               reference_mask, init_T, trim_ratio,
                               config: ICPConfig = ICPConfig(),
                               axis: str = "points") -> ICPResult:
    """ICP with the reading sharded over `mesh`'s `axis` and the reference
    and transform replicated; every rank of the mesh calls it with the
    whole arguments. Returns the full ICPResult on every rank: T,
    n_iterations, inlier_rms and hessian are equal on all of them, and the
    per-point match_dist2 / inlier_mask come back full length in the
    caller's order."""
    rp, rm, fp, fn, fm, T0 = _on(mesh, reading_points, reading_mask,
                                 reference_points, reference_normals,
                                 reference_mask, init_T)
    rows = mesh.shard(rp.shape[0], axis)
    cfg = dataclasses.replace(config, axis_name=axis,
                              shard_axis_mode="reading")
    res = point_to_plane_icp(
        rp[rows].contiguous(), rm[rows].contiguous(), fp, fn, fm, T0,
        torch.as_tensor(trim_ratio, dtype=torch.float32, device=mesh.device),
        cfg, mesh=mesh)
    return dataclasses.replace(
        res, match_dist2=mesh.all_gather(res.match_dist2, axis).reshape(-1),
        inlier_mask=mesh.all_gather(res.inlier_mask, axis).reshape(-1))


def map_sharded_point_to_plane_icp(mesh, reading_points, reading_mask,
                                   reference_points, reference_normals,
                                   reference_mask, init_T, trim_ratio,
                                   config: ICPConfig = ICPConfig(),
                                   axis: str = "points") -> ICPResult:
    """ICP with the reference (map) sharded in blocks over `mesh`'s `axis`
    and the reading replicated; every rank of the mesh calls it with the
    whole arguments and keeps its block. Each block is matched by the
    matcher its own shape selects (K1, or K5 on a block of 32,768 points or
    more), the global nearest neighbour is reduced across the blocks, and
    the ICPResult is replicated. With the exhaustive matcher the result is
    the single-device solve's, bit for bit."""
    rp, rm, fp, fn, fm, T0 = _on(mesh, reading_points, reading_mask,
                                 reference_points, reference_normals,
                                 reference_mask, init_T)
    rows = mesh.shard(fp.shape[0], axis)
    cfg = dataclasses.replace(config, axis_name=axis,
                              shard_axis_mode="reference")
    return point_to_plane_icp(
        rp, rm, fp[rows].contiguous(), fn[rows].contiguous(),
        fm[rows].contiguous(), T0,
        torch.as_tensor(trim_ratio, dtype=torch.float32, device=mesh.device),
        cfg, mesh=mesh)
