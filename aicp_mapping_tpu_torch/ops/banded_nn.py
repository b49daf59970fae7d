"""Morton codes and banded window starts, PyTorch port of the helpers of
`aicp_mapping_tpu.ops.banded_nn` that the hough prefilter's banded moments
(kernel K2) need. The banded nearest-neighbour kernels are not ported yet
(ROADMAP Q2 #4-#5, #9-#11).
"""
from __future__ import annotations

import torch

SENTINEL = 2**31 - 1


def _spread3(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of each lane 3 apart (Morton helper)."""
    v = v & 0x3FF
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def morton_codes(points: torch.Tensor, mask: torch.Tensor,
                 origin: torch.Tensor, cell_size) -> torch.Tensor:
    """30-bit Morton codes (int64) on a shared grid; invalid points get
    INT32_MAX so they sort to the back."""
    q = torch.clamp(torch.floor((points - origin) / cell_size), 0, 1023)
    q = q.to(torch.int64)
    code = ((_spread3(q[:, 0]) << 2) | (_spread3(q[:, 1]) << 1)
            | _spread3(q[:, 2]))
    return torch.where(mask, code, SENTINEL)


def banded_window_starts(qcodes_sorted_layout: torch.Tensor,
                         rcodes_s: torch.Tensor, n_rblocks: int, band: int,
                         tm: int, tn: int) -> torch.Tensor:
    """Per-query-tile window start, in reference blocks of `tn`, from the
    tiles' min/max Morton codes bracketed in the sorted reference codes
    (int32, clipped so the `band`-block window stays inside the
    reference)."""
    band = min(band, n_rblocks)
    tiles = qcodes_sorted_layout.reshape(-1, tm)
    tile_lo = tiles.amin(1)
    tile_hi = torch.where(tiles == SENTINEL, -1, tiles).amax(1)
    tile_hi = torch.maximum(tile_hi, tile_lo)
    lo_pos = torch.searchsorted(rcodes_s, tile_lo, right=False)
    hi_pos = torch.searchsorted(rcodes_s, tile_hi, right=True)
    center = (lo_pos + hi_pos) // (2 * tn)
    return torch.clamp(center - band // 2, 0,
                       max(n_rblocks - band, 0)).to(torch.int32)
