"""Shape-static voxel-grid operations, PyTorch port of
`aicp_mapping_tpu.ops.voxel`.

Integer keys match the JAX package bit for bit: the int32 hash of
`_mix_keys` is computed in int64 and masked to 30 bits (the low 30 bits of
a product do not depend on the word size), and the uint32 tagging of
`voxel_set_overlap` is done in int64. Every sort is stable.
"""
from __future__ import annotations

import torch

from ..geometry import se3

GRID_BITS = 10
GRID = 1 << GRID_BITS
INVALID_KEY = 2**31 - 1
_KEY_MASK = (1 << (3 * GRID_BITS)) - 1
_MIX_ODD = 0x2545F491
_BIG = 3.4e38


def _mix_keys(keys: torch.Tensor) -> torch.Tensor:
    """Bijective permutation of the 30-bit key space (decorrelates sort
    order from position); INVALID_KEY stays above the mixed range."""
    mixed = (keys * _MIX_ODD) & _KEY_MASK
    return torch.where(keys == INVALID_KEY, INVALID_KEY, mixed)


def _masked_min(points: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.where(mask[:, None], points, _BIG).amin(0)


def _grid_index(points, origin, voxel_size) -> torch.Tensor:
    """floor((p - origin) / voxel) clipped to the grid, as int64. Clipping
    in float first keeps far (masked) points from overflowing the cast."""
    q = torch.floor((points - origin) / voxel_size)
    return torch.clamp(q, 0, GRID - 1).to(torch.int64)


def _pack(ijk: torch.Tensor) -> torch.Tensor:
    return ((ijk[:, 0] << (2 * GRID_BITS)) | (ijk[:, 1] << GRID_BITS)
            | ijk[:, 2])


def voxel_keys(points: torch.Tensor, mask: torch.Tensor, voxel_size,
               origin: torch.Tensor | None = None) -> torch.Tensor:
    """Packed int64 voxel keys (values < 2^30); invalid -> INVALID_KEY.
    `origin` defaults to the masked minimum corner."""
    if origin is None:
        origin = _masked_min(points, mask)
    key = _pack(_grid_index(points, origin, voxel_size))
    return torch.where(mask, key, INVALID_KEY)


def voxel_downsample(points: torch.Tensor, mask: torch.Tensor, voxel_size,
                     capacity: int):
    """Centroid voxel-grid downsample (PCL VoxelGrid semantics).

    Returns (points (capacity, 3), mask (capacity,)): one centroid per
    occupied voxel, voxels in mixed-key order; voxels past `capacity` are
    dropped. Per-voxel sums are taken over voxel-corner OFFSETS (< one
    leaf), as in the JAX twin, so 60 m coordinates lose nothing to
    cancellation; they are segment sums in float64 here rather than
    differences of an f32 prefix sum.
    """
    dev = points.device
    origin = _masked_min(points, mask)
    ijk = _grid_index(points, origin, voxel_size)
    ukey = _pack(ijk)
    keys = _mix_keys(torch.where(mask, ukey, INVALID_KEY))
    off = torch.clamp(points - (origin + ijk.to(points.dtype) * voxel_size),
                      0.0, voxel_size)

    skeys, perm = torch.sort(keys, stable=True)
    valid = skeys != INVALID_KEY
    is_start = torch.ones_like(valid)
    is_start[1:] = skeys[1:] != skeys[:-1]
    seg = torch.cumsum((is_start & valid).to(torch.int64), 0) - 1
    # rows of dropped (over-capacity) voxels and invalid rows go to a
    # spill slot that is cut off at the end
    slot = torch.where(valid & (seg < capacity), seg, capacity)

    sums = torch.zeros((capacity + 1, 3), dtype=torch.float64, device=dev)
    sums.index_add_(0, slot, off[perm].to(torch.float64))
    cnts = torch.zeros((capacity + 1,), dtype=torch.float64, device=dev)
    cnts.index_add_(0, slot, valid.to(torch.float64))
    vkey = torch.zeros((capacity + 1,), dtype=torch.int64, device=dev)
    vkey[slot] = ukey[perm]            # one key per voxel; spill discarded

    out_mask = cnts[:capacity] > 0
    cnt = torch.clamp(cnts[:capacity], min=1.0)[:, None]
    off_mean = (sums[:capacity] / cnt).to(points.dtype)
    k = vkey[:capacity]
    cell = torch.stack([(k >> (2 * GRID_BITS)) & (GRID - 1),
                        (k >> GRID_BITS) & (GRID - 1),
                        k & (GRID - 1)], dim=1).to(points.dtype)
    corner = origin + cell * voxel_size
    out_points = torch.where(out_mask[:, None], corner + off_mean, 0.0)
    return out_points, out_mask


def unique_voxel_count(points: torch.Tensor, mask: torch.Tensor,
                       voxel_size) -> torch.Tensor:
    """Number of occupied voxels (octree leaf-count analog)."""
    skeys = torch.sort(voxel_keys(points, mask, voxel_size)).values
    valid = skeys != INVALID_KEY
    is_start = torch.ones_like(valid)
    is_start[1:] = skeys[1:] != skeys[:-1]
    return (is_start & valid).sum()


def voxel_set_overlap(points_a: torch.Tensor, mask_a: torch.Tensor,
                      points_b: torch.Tensor, mask_b: torch.Tensor,
                      voxel_size):
    """(n_common, n_a, n_b): co-occupied / per-cloud occupied voxel counts
    on a shared grid, from ONE combined sort of lsb-tagged keys (cloud a =
    0, cloud b = 1), as in the JAX twin; tags are int64 so the largest
    30-bit key cannot alias the invalid sentinel."""
    mins = torch.minimum(_masked_min(points_a, mask_a),
                         _masked_min(points_b, mask_b))
    keys_a = voxel_keys(points_a, mask_a, voxel_size, origin=mins)
    keys_b = voxel_keys(points_b, mask_b, voxel_size, origin=mins)
    invalid = 0xFFFFFFFF
    tagged_a = torch.where(keys_a == INVALID_KEY, invalid, keys_a * 2)
    tagged_b = torch.where(keys_b == INVALID_KEY, invalid, keys_b * 2 + 1)
    combined = torch.sort(torch.cat([tagged_a, tagged_b])).values

    valid = combined != invalid
    key = combined >> 1
    tag = combined & 1
    same_next = torch.zeros_like(valid)
    same_next[:-1] = key[1:] == key[:-1]
    is_start = torch.ones_like(valid)
    is_start[1:] = key[1:] != key[:-1]
    is_end = ~same_next
    next_tag = torch.zeros_like(tag)
    next_tag[:-1] = tag[1:]
    next_valid = torch.zeros_like(valid)
    next_valid[:-1] = valid[1:]

    n_a = (is_start & valid & (tag == 0)).sum()
    n_b = (is_end & valid & (tag == 1)).sum()
    n_common = (same_next & valid & next_valid & (tag == 0)
                & (next_tag == 1)).sum()
    return n_common, n_a, n_b


def crop_box(points: torch.Tensor, mask: torch.Tensor, T_box: torch.Tensor,
             lo, hi) -> torch.Tensor:
    """Mask of points inside an oriented box: T_box^{-1} p within [lo, hi]."""
    local = se3.transform_points(se3.inverse(T_box), points)
    inside = ((local >= lo) & (local <= hi)).all(dim=-1)
    return mask & inside
