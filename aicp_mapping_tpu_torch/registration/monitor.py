"""ICP quality monitoring — Hausdorff distance and residual statistics,
PyTorch port of `aicp_mapping_tpu.registration.monitor`.

Every 1-NN search here goes through `ops.knn.nn_argmin_kernel`: kernel K1's
index mode on the card (the TPU's `_nn_kernel`), its plain twin on the CPU.
"""
from __future__ import annotations

import torch

from ..ops.knn import nn_argmin_kernel
from ..ops.quantile import masked_mean, masked_median, masked_quantile

_BIG = 3.4e38


def hausdorff_distance(points_a, mask_a, points_b, mask_b, quantile=1.0):
    """Symmetric (quantile-robust) Hausdorff distance in meters: the larger
    of the two directed NN-distance quantiles; quantile 1.0 is the classic
    max of min."""
    d_ab, _ = nn_argmin_kernel(points_a, mask_a, points_b, mask_b)
    d_ba, _ = nn_argmin_kernel(points_b, mask_b, points_a, mask_a)
    da = torch.sqrt(torch.clamp(masked_quantile(d_ab, mask_a, quantile),
                                min=0.0))
    db = torch.sqrt(torch.clamp(masked_quantile(d_ba, mask_b, quantile),
                                min=0.0))
    return torch.maximum(da, db)


def distances_knn(points_a, mask_a, points_b, mask_b):
    """Per-point NN distances of cloud A against cloud B: (dists (N,),
    idx (N,)), BIG for invalid entries."""
    d2, idx = nn_argmin_kernel(points_a, mask_a, points_b, mask_b)
    return torch.where(mask_a, torch.sqrt(torch.clamp(d2, min=0.0)),
                       _BIG), idx


def paired_points_mean_distance(points_a, points_b, mask):
    """Mean distance between index-aligned point pairs."""
    return masked_mean(torch.linalg.norm(points_a - points_b, dim=-1), mask)


def residual_stats(dist2, mask, quantile=0.75) -> dict:
    """Mean / median / quantile of NN residual distances (meters)."""
    d = torch.sqrt(torch.clamp(torch.where(mask, dist2, 0.0), min=0.0))
    return {"mean": masked_mean(d, mask), "median": masked_median(d, mask),
            "quantile": masked_quantile(d, mask, quantile)}
