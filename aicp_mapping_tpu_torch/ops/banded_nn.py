"""Morton-banded nearest-neighbour search, PyTorch port of
`aicp_mapping_tpu.ops.banded_nn`: the map-scale ICP matcher.

Both clouds are sorted by 30-bit Morton code on a shared grid, so nearby
points land in contiguous ranges; each tile of `tm` queries then scans only
the `band` reference blocks of `tn` points that start at its window start
(`banded_window_starts`), bracketed from the tile's codes.

- `banded_prepare_payload`: the reference sorted once, with its payload.
- `nn_payload_banded`: the plain version of the banded 1-NN + payload.
- `nn_payload_banded_stream_kernel` (kernel K5) wraps the CUDA kernel of
  `_kernels/csrc/banded_nn.cu`, which replaces both the TPU's resident and
  streaming split kernels: on a CUDA tensor it launches the kernel, on a
  CPU tensor it runs `nn_payload_banded`.

The contract is the TPU kernels' without their TPU layout: distances are
exact f32 in difference form (no packed key, no bf16 split), the first
minimum in sorted-reference order wins, and a query with no valid reference
in its window gets d^2 = 3.4e38 and a zero payload row.
"""
from __future__ import annotations

import torch

from .. import _kernels
from .knn import sq_dists

SENTINEL = 2**31 - 1
_BIG = 3.4e38


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


def payload_rows(refs: torch.Tensor, extra=None,
                 pad_to: int = 8) -> torch.Tensor:
    """(N, pad_to) matcher payload rows [x y z extra... 0-pad]."""
    cols = [refs] if extra is None else [refs, extra]
    width = sum(c.shape[1] for c in cols)
    if width > pad_to:
        raise ValueError(f"matcher payload: {width} columns > {pad_to}")
    cols.append(torch.zeros((refs.shape[0], pad_to - width),
                            dtype=torch.float32, device=refs.device))
    return torch.cat(cols, dim=1).contiguous()


def banded_prepare_payload(refs: torch.Tensor, rmask: torch.Tensor,
                           extra, origin: torch.Tensor, cell_size,
                           pad_to: int = 8):
    """Sort the reference once by Morton code (stable), for every banded
    query against it. Returns (rs (N, 3) sorted points, rpen (N,) 0 for a
    valid row and +BIG for a masked one, rcodes_s (N,) sorted codes,
    pay_s (N, pad_to) payload rows [x y z extra... 0-pad]), all contiguous
    and in sorted order."""
    codes = morton_codes(refs, rmask, origin, cell_size)
    rcodes_s, perm = torch.sort(codes, stable=True)
    pay_s = payload_rows(refs, extra, pad_to)[perm].contiguous()
    rpen = torch.where(rmask[perm], 0.0, _BIG).to(torch.float32)
    return pay_s[:, :3].contiguous(), rpen.contiguous(), rcodes_s, pay_s


def nn_payload_banded(q: torch.Tensor, rs: torch.Tensor,
                      rpen: torch.Tensor, pay_s: torch.Tensor,
                      starts: torch.Tensor, band: int, tm: int = 512,
                      tn: int = 1024):
    """Banded 1-NN + payload (plain version): the queries of tile g scan
    the sorted references [starts[g] * tn, (starts[g] + band) * tn).
    Returns (dist2 (M,), payload (M, P)) in the query order given."""
    out_d, out_p = [], []
    zero = torch.zeros((), dtype=pay_s.dtype, device=pay_s.device)
    for g, s in enumerate(starts.tolist()):
        w = slice(s * tn, (s + band) * tn)
        d = sq_dists(q[g * tm:(g + 1) * tm], rs[w]) + rpen[None, w]
        best, j = torch.min(d, dim=1)
        found = best < _BIG
        out_d.append(torch.where(found, best, _BIG))
        out_p.append(torch.where(found[:, None], pay_s[w][j], zero))
    return torch.cat(out_d), torch.cat(out_p)


def _banded_args(name, q, rs, rpen, pay_s, starts, band, tm, tn):
    """Check a banded kernel's arguments; returns the device type."""
    device_type = _kernels.check_tensors(name, q, rs, rpen, pay_s, starts)
    M, N, P = q.shape[0], rs.shape[0], pay_s.shape[1]
    if (q.dtype != torch.float32 or rs.dtype != torch.float32
            or rpen.dtype != torch.float32 or pay_s.dtype != torch.float32
            or starts.dtype != torch.int32):
        raise TypeError(f"{name}: f32 points/penalties/payload, int32 starts")
    if (q.shape != (M, 3) or rs.shape != (N, 3) or rpen.shape != (N,)
            or pay_s.shape != (N, P) or starts.shape != (M // tm,)):
        raise ValueError(f"{name}: bad shapes {q.shape} {rs.shape} "
                         f"{rpen.shape} {pay_s.shape} {starts.shape}")
    if (M % tm or tm % 128 or N % tn or tn % 4 or not 1 <= band <= N // tn):
        raise ValueError(f"{name}: M={M} N={N} tm={tm} tn={tn} band={band}")
    if device_type == "cuda" and (rs.data_ptr() % 16 or rpen.data_ptr() % 16):
        raise ValueError(f"{name}: references must be 16-byte aligned")
    return device_type


def nn_payload_banded_stream_kernel(q, rs, rpen, pay_s, starts, band: int,
                                    tm: int = 512, tn: int = 1024):
    """Kernel K5 (replaces ops/banded_nn.py:_banded_payload_split_kernel
    and :_banded_payload_split_stream_kernel): banded 1-NN + payload, the
    window's blocks double-buffered through shared memory by `cp.async`.
    Same contract as `nn_payload_banded`, at any band; needs M % tm == 0,
    tm % 128 == 0, N % tn == 0, tn % 4 == 0 and 1 <= band <= N / tn.
    CPU tensors run `nn_payload_banded`; CUDA tensors launch the kernel or
    raise."""
    name = "banded_nn_payload_stream"
    args = (q, rs, rpen, pay_s, starts, band, tm, tn)
    if _banded_args(name, *args) == "cpu":
        return nn_payload_banded(*args)
    M, P = q.shape[0], pay_s.shape[1]
    dist = torch.empty((M,), dtype=torch.float32, device=q.device)
    pout = torch.empty((M, P), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        status = _kernels.library().aicp_banded_nn_payload_stream(
            q.data_ptr(), M, rs.data_ptr(), rpen.data_ptr(), rs.shape[0],
            pay_s.data_ptr(), P, starts.data_ptr(), tm, tn, band,
            dist.data_ptr(), pout.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _kernels.check_status(status, name)
    _kernels.count_launch(name)
    return dist, pout
