"""Occupancy-grid ("octree") overlap between two clouds, PyTorch port of
`aicp_mapping_tpu.overlap.voxel_overlap`: both clouds voxelized at
`resolution` on a shared grid, and

    overlap = min(|A ∩ B| / |A|, |A ∩ B| / |B|) * 100

over occupied voxel keys (`ops.voxel.voxel_set_overlap`).
"""
from __future__ import annotations

import dataclasses

import torch

from ..ops.voxel import voxel_set_overlap


@dataclasses.dataclass(frozen=True)
class OverlapStats:
    overlap_percent: torch.Tensor   # min-ratio * 100
    n_common: torch.Tensor
    n_ref: torch.Tensor
    n_read: torch.Tensor

    def loop_closure_tuple(self):
        """(min ratio, |max - min| ratio, ratio of ref, ratio of read), in
        percent."""
        ra = self.n_common / torch.clamp(self.n_ref, min=1)
        rb = self.n_common / torch.clamp(self.n_read, min=1)
        mn = torch.minimum(ra, rb) * 100.0
        mx = torch.maximum(ra, rb) * 100.0
        return mn, torch.abs(mx - mn), ra * 100.0, rb * 100.0


def compute_overlap(ref_points, ref_mask, read_points, read_mask,
                    resolution=0.2) -> OverlapStats:
    """Both clouds must be in the same (world) frame."""
    n_common, n_ref, n_read = voxel_set_overlap(
        ref_points, ref_mask, read_points, read_mask, resolution)
    ra = n_common / torch.clamp(n_ref, min=1)
    rb = n_common / torch.clamp(n_read, min=1)
    return OverlapStats(overlap_percent=torch.minimum(ra, rb) * 100.0,
                        n_common=n_common, n_ref=n_ref, n_read=n_read)
