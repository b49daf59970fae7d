"""Progressive morphological ground filter (Zhang et al., TGRS 2003),
PyTorch port of `aicp_mapping_tpu.ops.ground`.

The reference's KITTI preprocessing runs PCL's
`ProgressiveMorphologicalFilter` (pcl_ground_removal.cpp:51-56). As in the
JAX package, the cloud is rasterized to a fixed min-z grid and the
morphological opening runs as min/max window passes over it: the raster is
a `scatter_reduce(..., "amin")`, erosion and dilation are `max_pool2d` with
padding `w // 2` (every window is odd), which equals JAX's
`lax.reduce_window(..., "SAME")` with its -1e30 init because every window
holds its own centre cell.

Card and CPU rasterize the same cells: the raster centre (the masked mean
of x, y) is summed in float64 and rounded to float32 once, and every
scalar of the cell arithmetic is a float32 tensor on the points' device
(CUDA divides by a host scalar as a multiply by its reciprocal).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

_BIG = float(np.float32(1e30))


@dataclasses.dataclass(frozen=True)
class GroundFilterConfig:
    cell_size: float = 0.33      # PCL default cell size (meters)
    grid_dim: int = 256          # static raster resolution (grid covers
                                 # grid_dim * cell_size meters per side)
    max_window_size: int = 33    # largest opening window (cells)
    slope: float = 0.1
    initial_distance: float = 0.1
    max_distance: float = 2.0
    base: float = 2.0            # window growth: w_k = 2*base^k + 1


def _window_sizes(cfg: GroundFilterConfig) -> list[int]:
    sizes = []
    k = 0
    while True:
        w = int(2 * cfg.base ** k + 1)
        if w > cfg.max_window_size:
            break
        sizes.append(w)
        k += 1
    return sizes or [3]


def _dilate(grid: torch.Tensor, w: int) -> torch.Tensor:
    return F.max_pool2d(grid[None, None], w, stride=1, padding=w // 2)[0, 0]


def _erode(grid: torch.Tensor, w: int) -> torch.Tensor:
    return -_dilate(-grid, w)


def raster_center(points: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The raster centre: the masked mean of x and y, summed in float64 and
    rounded to float32 once, (2,)."""
    m = mask.to(torch.float64)
    denom = torch.clamp(m.sum(), min=1.0)
    return ((points[:, :2].to(torch.float64) * m[:, None]).sum(0)
            / denom).to(torch.float32)


def ground_mask(points: torch.Tensor, mask: torch.Tensor,
                cfg: GroundFilterConfig = GroundFilterConfig()
                ) -> torch.Tensor:
    """A boolean (N,) mask, True for ground points. Padded (mask=False)
    points are always non-ground."""
    dev = points.device
    G = cfg.grid_dim

    def f32(v) -> torch.Tensor:
        return torch.tensor(float(np.float32(v)), dtype=torch.float32,
                            device=dev)

    center = raster_center(points, mask)
    half = f32(G * cfg.cell_size / 2.0)
    ij = torch.floor((points[:, :2] - center + half)
                     / f32(cfg.cell_size)).to(torch.int32)
    in_grid = (mask & (ij[:, 0] >= 0) & (ij[:, 0] < G)
               & (ij[:, 1] >= 0) & (ij[:, 1] < G))
    ij = torch.clamp(ij, 0, G - 1).to(torch.int64)
    flat = ij[:, 0] * G + ij[:, 1]

    # min-z raster; empty cells hold +BIG
    big = f32(_BIG)
    z = torch.where(in_grid, points[:, 2], big)
    surface = torch.full((G * G,), _BIG, dtype=torch.float32, device=dev)
    surface = surface.scatter_reduce(0, flat, z, "amin").reshape(G, G)
    # fill empty cells with a large opening of the occupied surface so the
    # morphology is not polluted by +BIG holes
    occupied = surface < f32(_BIG / 2)
    filled = _dilate(torch.where(occupied, surface, -big), 5)
    surface = torch.where(occupied, surface, filled)

    # progressive opening: growing windows, per-stage elevation thresholds
    # dh_k = slope * (w_k - w_{k-1}) * cell + initial, capped at max
    # (Zhang'03 eq. 7; PCL ProgressiveMorphologicalFilter::extract)
    ground_surf = surface
    prev_w = 1
    for w in _window_sizes(cfg):
        opened = _dilate(_erode(ground_surf, w), w)
        dh = f32(min(cfg.slope * (w - prev_w) * cfg.cell_size
                     + cfg.initial_distance, cfg.max_distance))
        ground_surf = torch.where(ground_surf - opened > dh, opened,
                                  ground_surf)
        prev_w = w

    # point classification against the estimated ground surface
    surf_at = ground_surf.reshape(-1)[flat]
    return in_grid & (points[:, 2] - surf_at
                      <= f32(cfg.initial_distance
                             + cfg.slope * cfg.cell_size))


def remove_ground(points: torch.Tensor, mask: torch.Tensor,
                  cfg: GroundFilterConfig = GroundFilterConfig()):
    """(non_ground_mask, ground_mask), both subsets of `mask`: the
    extract / extract-negative pair of the reference tool
    (pcl_ground_removal.cpp:58-80)."""
    g = ground_mask(points, mask, cfg)
    return mask & ~g, g
