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


_M32 = 0xFFFFFFFF


def _rotl32(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k0: int, k1: int, x0: torch.Tensor,
                 x1: torch.Tensor):
    """The Threefry-2x32 block cipher with 20 rounds (Salmon et al. 2011),
    as `jax.random` runs it: 32-bit words held in int64 tensors, every sum
    masked to 32 bits."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    rotations = ((13, 15, 26, 6), (17, 29, 16, 24))
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in rotations[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl32(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def jax_uniform(seed: int, n: int) -> torch.Tensor:
    """`jax.random.uniform(jax.random.PRNGKey(seed), (n,))`, bit for bit
    (CPU f32, 32-bit JAX): the key words are (0, seed & 0xFFFFFFFF),
    counter i is the word pair (i >> 32, i & 0xFFFFFFFF), and the 23 high
    bits of the two output words' XOR fill the mantissa of a float in
    [1, 2), minus 1."""
    i = torch.arange(n, dtype=torch.int64)
    x0, x1 = threefry2x32(0, int(seed) & _M32, i >> 32, i & _M32)
    bits = ((x0 ^ x1) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0


def random_sampling_filter(mask, prob: float, seed: int = 0):
    """Keep each valid point with probability `prob`, deterministic given
    `seed`: the JAX package's draws, `jax_uniform(seed, n) < prob`."""
    u = jax_uniform(seed, mask.shape[0]).to(mask.device)
    return mask & (u < torch.tensor(prob, dtype=torch.float32).item())


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
