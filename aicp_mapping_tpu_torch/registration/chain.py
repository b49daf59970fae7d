"""ICP-chain data-points filters (libpointmatcher chain analogs), PyTorch
port of `aicp_mapping_tpu.registration.chain`.

Each filter takes and returns a validity mask over a fixed-capacity point
tensor: points are invalidated, never compacted.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ChainFilterConfig:
    """min_dist / max_dist: drop points nearer / farther than this from the
    sensor origin (0 disables); random_sampling_prob: keep each point with
    this probability (1 disables); max_density_cell: keep at most one point
    per cell of this size (0 disables)."""

    min_dist: float = 0.0
    max_dist: float = 0.0
    random_sampling_prob: float = 1.0
    max_density_cell: float = 0.0


def _dist2(points, origin):
    return ((points - origin[None, :]) ** 2).sum(-1)


def _sq_f32(x: float) -> torch.Tensor:
    """x^2 rounded as f32 arithmetic rounds it (the JAX filters' bound)."""
    return torch.tensor(x, dtype=torch.float32) ** 2


def min_dist_filter(points, mask, origin, min_dist: float):
    """Invalidate points within `min_dist` of the sensor origin."""
    return mask & (_dist2(points, origin) >= _sq_f32(min_dist).item())


def max_dist_filter(points, mask, origin, max_dist: float):
    """Invalidate points beyond `max_dist` of the sensor origin."""
    return mask & (_dist2(points, origin) <= _sq_f32(max_dist).item())


def random_sampling_filter(mask, prob: float, seed: int = 0):
    """Keep each valid point with probability `prob`, deterministic given
    `seed` (a `torch.Generator` on the CPU; the draws are not those of the
    JAX package's `jax.random`, only their distribution is)."""
    gen = torch.Generator().manual_seed(int(seed))
    u = torch.rand(mask.shape[0], generator=gen).to(mask.device)
    return mask & (u < prob)


def max_density_filter(points, mask, cell_size: float):
    """Keep the first point (in index order) of each `cell_size` voxel: a
    lexicographic stable sort of the (x, y, z) cell coordinates, as
    `jnp.lexsort` orders them."""
    inv = 1.0 / torch.tensor(cell_size, dtype=torch.float32)
    q = torch.floor(points * inv.to(points.device)).to(torch.int32)
    q = torch.where(mask[:, None], q, 2**31 - 1)
    order = torch.arange(points.shape[0], device=points.device)
    for axis in (2, 1, 0):   # least significant key first
        order = order[torch.sort(q[order, axis], stable=True).indices]
    qs = q[order]
    first = torch.ones_like(mask)
    first[1:] = (qs[1:] != qs[:-1]).any(1)
    keep = torch.zeros_like(mask)
    keep[order] = first & (qs[:, 0] != 2**31 - 1)
    return mask & keep


def apply_chain_filters(points, mask, origin, cfg: ChainFilterConfig,
                        seed: int = 0):
    """The chain's filters in the reference's order: min / max distance,
    density cap, random sampling."""
    if cfg.min_dist > 0:
        mask = min_dist_filter(points, mask, origin, cfg.min_dist)
    if cfg.max_dist > 0:
        mask = max_dist_filter(points, mask, origin, cfg.max_dist)
    if cfg.max_density_cell > 0:
        mask = max_density_filter(points, mask, cfg.max_density_cell)
    if cfg.random_sampling_prob < 1.0:
        mask = random_sampling_filter(mask, cfg.random_sampling_prob, seed)
    return mask
