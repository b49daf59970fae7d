"""Morton-banded nearest-neighbour search, PyTorch port of
`aicp_mapping_tpu.ops.banded_nn`: the map-scale ICP matcher and the public
banded NN API.

Both clouds are sorted by 30-bit Morton code on a shared grid, so nearby
points land in contiguous ranges; each tile of `tm` queries then scans only
the `band` reference blocks of `tn` points that start at its window start
(`banded_window_starts`), bracketed from the tile's codes.

Kernel K5 (`_kernels/csrc/banded_nn.cu`) cuts each window into slices
scanned by blocks of their own (`banded_split_plan`) and merges the
slices' first minima. It has two modes, each with a plain version and a
wrapper that launches the kernel on a CUDA tensor (or raises) and runs the
plain version on a CPU tensor. Both take the sorted reference as K5 reads
it: rows `rs` (N, 3), a penalty `rpen` (N,) of 0 for a valid row and +BIG
for a masked one, payload rows (N, P).

- payload mode: `nn_payload_banded` (plain), `nn_payload_banded_stream_kernel`
  (wrapper; replaces the TPU's four banded payload kernels);
- index mode: `banded_nn_argmin` (plain), `banded_nn_argmin_kernel`
  (wrapper; replaces the TPU's `_banded_kernel`).

The ICP matcher sorts the reference once with `banded_prepare_payload`.
The JAX module's public functions keep their names and their layouts
(coordinate-major `rt` (3, N), `rsq` (1, N) with +BIG at masked rows,
`pay_t` (P, N), blocks (B, ., tn)), so that they take the very arrays JAX
produced, and convert once per call to K5's: `banded_prepare`,
`nn_argmin_banded_prepared` and `nn_argmin_banded` (index mode),
`nn_payload_banded_sorted`, `banded_blocks` and `nn_payload_banded_resident`
(payload mode). JAX's `interpret` flag has no counterpart.

The contract is the TPU kernels' without their TPU layout: distances are
exact f32 in difference form (no packed key, no bf16 split), the first
minimum in sorted-reference order wins, and a query with no valid reference
in its window gets d^2 = 3.4e38 and a zero payload row (index mode: the
sorted index -1; `nn_argmin_banded_prepared` maps it to `rperm[0]`, as
JAX's kernel leaves index 0 there). JAX's packed-key kernels instead let a
masked reference win such a window, with a floored 3.39997e38 and that
row's payload (ROADMAP Q3).
"""
from __future__ import annotations

import functools

import torch

from .. import _kernels
from .knn import THREADS, SplitPlan, split_window, sq_dists

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


def banded_nn_argmin(q: torch.Tensor, rs: torch.Tensor, rpen: torch.Tensor,
                     starts: torch.Tensor, band: int, tm: int = 512,
                     tn: int = 1024):
    """Banded 1-NN index (plain version): the queries of tile g against
    the sorted references [s * tn, (s + band) * tn), s = starts[g] clipped
    into the reference as K5 clips it. Returns (dist2 (M,), idx (M,)
    int64), the sorted index of the first minimum, -1 (and dist2 +BIG)
    where the window holds no valid reference."""
    out_d, out_j = [], []
    n_blocks = rs.shape[0] // tn
    for g, s in enumerate(starts.tolist()):
        s = max(0, min(s, n_blocks - band))
        w = slice(s * tn, (s + band) * tn)
        d = sq_dists(q[g * tm:(g + 1) * tm], rs[w]) + rpen[None, w]
        best, j = torch.min(d, dim=1)
        found = best < _BIG
        out_d.append(torch.where(found, best, _BIG))
        out_j.append(torch.where(found, j + s * tn, -1))
    return torch.cat(out_d), torch.cat(out_j)


def nn_payload_banded(q: torch.Tensor, rs: torch.Tensor,
                      rpen: torch.Tensor, pay_s: torch.Tensor,
                      starts: torch.Tensor, band: int, tm: int = 512,
                      tn: int = 1024):
    """Banded 1-NN + payload (plain version): the queries of tile g scan
    the sorted references [starts[g] * tn, (starts[g] + band) * tn).
    Returns (dist2 (M,), payload (M, P)) in the query order given."""
    d, j = banded_nn_argmin(q, rs, rpen, starts, band, tm, tn)
    return d, torch.where((j >= 0)[:, None], pay_s[j.clamp(min=0)], 0.0)


@functools.lru_cache(maxsize=None)
def banded_split_plan(M: int, band: int, tm: int = 512,
                      tn: int = 1024) -> SplitPlan:
    """K5's grid for M sorted queries in tiles of `tm`, each against its
    window of `band` blocks of `tn` references: blocks of `THREADS`
    threads with 4 queries each (2 or 1 where `tm` is not a multiple of
    512 or 256, so that a block lies inside one tile and shares its
    window), the window cut by `ops.knn.split_window`."""
    qpt = next(k for k in (4, 2, 1) if tm % (THREADS * k) == 0)
    return SplitPlan(qpt, *split_window(M // (THREADS * qpt), band * tn))


def _banded_args(name, q, rs, rpen, starts, band, tm, tn, *payload):
    """Check a banded kernel's arguments; returns the device type."""
    device_type = _kernels.check_tensors(name, q, rs, rpen, starts, *payload)
    M, N = q.shape[0], rs.shape[0]
    if (q.dtype != torch.float32 or rs.dtype != torch.float32
            or rpen.dtype != torch.float32
            or any(t.dtype != torch.float32 for t in payload)
            or starts.dtype != torch.int32):
        raise TypeError(f"{name}: f32 points/penalties/payload, int32 starts")
    if (q.shape != (M, 3) or rs.shape != (N, 3) or rpen.shape != (N,)
            or any(t.ndim != 2 or t.shape[0] != N for t in payload)
            or starts.shape != (M // tm,)):
        raise ValueError(f"{name}: bad shapes {q.shape} {rs.shape} "
                         f"{rpen.shape} {[tuple(t.shape) for t in payload]} "
                         f"{starts.shape}")
    if (M % tm or tm % 128 or N % tn or tn % 4 or not 1 <= band <= N // tn):
        raise ValueError(f"{name}: M={M} N={N} tm={tm} tn={tn} band={band}")
    if device_type == "cuda" and (rs.data_ptr() % 16 or rpen.data_ptr() % 16):
        raise ValueError(f"{name}: references must be 16-byte aligned")
    return device_type


def nn_payload_banded_stream_kernel(q, rs, rpen, pay_s, starts, band: int,
                                    tm: int = 512, tn: int = 1024):
    """Kernel K5 in payload mode (replaces ops/banded_nn.py:
    _banded_payload_split_kernel, :_banded_payload_split_stream_kernel,
    :_banded_payload_kernel and :_banded_payload_kernel_v2): banded 1-NN +
    payload, each window cut into slices by `banded_split_plan`, each slice
    double-buffered through shared memory by `cp.async`, the slices' first
    minima merged.
    Same contract as `nn_payload_banded`, at any band; needs M % tm == 0,
    tm % 128 == 0, N % tn == 0, tn % 4 == 0 and 1 <= band <= N / tn.
    CPU tensors run `nn_payload_banded`; CUDA tensors launch the kernel or
    raise."""
    name = "banded_nn_payload_stream"
    if _banded_args(name, q, rs, rpen, starts, band, tm, tn, pay_s) == "cpu":
        return nn_payload_banded(q, rs, rpen, pay_s, starts, band, tm, tn)
    M, P = q.shape[0], pay_s.shape[1]
    plan = banded_split_plan(M, band, tm, tn)
    dist = torch.empty((M,), dtype=torch.float32, device=q.device)
    pout = torch.empty((M, P), dtype=torch.float32, device=q.device)
    keys = torch.empty((plan.splits, M), dtype=torch.int64, device=q.device)
    with torch.cuda.device(q.device):
        status = _kernels.library().aicp_banded_nn_payload_stream(
            q.data_ptr(), M, rs.data_ptr(), rpen.data_ptr(), rs.shape[0],
            pay_s.data_ptr(), P, starts.data_ptr(), tm, tn, band, *plan,
            keys.data_ptr(), dist.data_ptr(), pout.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _kernels.check_status(status, name)
    _kernels.count_launch(name)
    return dist, pout


def banded_nn_argmin_kernel(q, rs, rpen, starts, band: int, tm: int = 512,
                            tn: int = 1024):
    """Kernel K5 in index mode (replaces ops/banded_nn.py:_banded_kernel):
    banded 1-NN distance and int64 sorted index. Same contract and
    requirements as `banded_nn_argmin`. CPU tensors run `banded_nn_argmin`;
    CUDA tensors launch the kernel or raise."""
    name = "banded_nn_argmin"
    if _banded_args(name, q, rs, rpen, starts, band, tm, tn) == "cpu":
        return banded_nn_argmin(q, rs, rpen, starts, band, tm, tn)
    M = q.shape[0]
    plan = banded_split_plan(M, band, tm, tn)
    dist = torch.empty((M,), dtype=torch.float32, device=q.device)
    idx = torch.empty((M,), dtype=torch.int64, device=q.device)
    keys = torch.empty((plan.splits, M), dtype=torch.int64, device=q.device)
    with torch.cuda.device(q.device):
        status = _kernels.library().aicp_banded_nn_argmin(
            q.data_ptr(), M, rs.data_ptr(), rpen.data_ptr(), rs.shape[0],
            starts.data_ptr(), tm, tn, band, *plan, keys.data_ptr(),
            dist.data_ptr(), idx.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _kernels.check_status(status, name)
    _kernels.count_launch(name)
    return dist, idx


# --- The JAX module's public functions, in its layouts ---------------------

def banded_prepare(refs: torch.Tensor, rmask: torch.Tensor,
                   origin: torch.Tensor, cell_size):
    """Sort the reference once by Morton code (stable) for
    `nn_argmin_banded_prepared`. Returns (rt (3, N) sorted
    coordinate-major, rsq (1, N) squared norms with +BIG at masked rows,
    rcodes_s (N,) sorted codes, rperm (N,) the sort permutation)."""
    codes = morton_codes(refs, rmask, origin, cell_size)
    rcodes_s, rperm = torch.sort(codes, stable=True)
    rt = refs[rperm].to(torch.float32).T.contiguous()
    rsq = torch.where(rmask[rperm][None, :], (rt * rt).sum(0, keepdim=True),
                      _BIG)
    return rt, rsq, rcodes_s, rperm


def _rows(rt: torch.Tensor, rsq: torch.Tensor):
    """K5's reference layout from JAX's: rows (N, 3) and the penalty (N,),
    0 for a valid row and +BIG where `rsq` holds +BIG; new contiguous
    tensors, so 16-byte aligned."""
    rs = rt.T.to(torch.float32).contiguous()
    rpen = torch.where(rsq.reshape(-1) >= _BIG, _BIG, 0.0).to(torch.float32)
    return rs, rpen


def _check_tiles(name: str, M: int, N: int, tm: int, tn: int) -> None:
    if M % tm or N % tn:
        raise ValueError(f"{name}: M={M} N={N} must be multiples of "
                         f"tm={tm} tn={tn}")


def nn_argmin_banded_prepared(queries, qmask, rt, rsq, rcodes_s, rperm,
                              origin, cell_size, band: int = 8,
                              tm: int = 512, tn: int = 1024):
    """Banded 1-NN against a `banded_prepare`d reference (K5's index mode
    on a CUDA tensor): (dist2 (M,), index (M,) int64 into the unsorted
    reference), in the query order given; masked queries get (BIG, 0).
    Needs M % tm == 0 and N % tn == 0; `band` is clamped to N / tn.

    Each tile of the Morton-sorted queries takes its window from its first
    and last code (sentinels included), as JAX's function does, not from
    its min / max valid code as `banded_window_starts` does."""
    M, N = queries.shape[0], rt.shape[1]
    _check_tiles("nn_argmin_banded_prepared", M, N, tm, tn)
    n_rblocks = N // tn
    band = min(band, n_rblocks)
    qcodes_s, qperm = torch.sort(
        morton_codes(queries, qmask, origin, cell_size), stable=True)
    tiles = qcodes_s.reshape(M // tm, tm)
    rcodes_s = rcodes_s.to(torch.int64).contiguous()
    lo = torch.searchsorted(rcodes_s, tiles[:, 0].contiguous(), right=False)
    hi = torch.searchsorted(rcodes_s, tiles[:, -1].contiguous(), right=True)
    starts = torch.clamp((lo + hi) // (2 * tn) - band // 2, 0,
                         n_rblocks - band).to(torch.int32)
    rs, rpen = _rows(rt, rsq)
    qs = queries[qperm].to(torch.float32).contiguous()
    d_s, j_s = banded_nn_argmin_kernel(qs, rs, rpen, starts, band, tm, tn)
    dist, idx = torch.empty_like(d_s), torch.empty_like(j_s)
    dist[qperm] = d_s
    idx[qperm] = rperm.to(torch.int64)[j_s.clamp(min=0)]
    return torch.where(qmask, dist, _BIG), torch.where(qmask, idx, 0)


def nn_argmin_banded(queries, qmask, refs, rmask, band: int = 8,
                     tm: int = 512, tn: int = 1024, cell_size: float = 4.0):
    """One-shot banded 1-NN (`banded_prepare`, then
    `nn_argmin_banded_prepared`) on a grid whose origin is the least valid
    coordinate of both clouds. For repeated queries against one
    reference, prepare it once."""
    big = 1e30
    origin = torch.minimum(
        torch.where(qmask[:, None], queries, big).amin(0),
        torch.where(rmask[:, None], refs, big).amin(0))
    prep = banded_prepare(refs, rmask, origin, cell_size)
    return nn_argmin_banded_prepared(queries, qmask, *prep, origin, cell_size,
                                     band=band, tm=tm, tn=tn)


def nn_payload_banded_sorted(qs, rt, rsq, pay_t, starts, band: int = 8,
                             tm: int = 512, tn: int = 1024):
    """Banded 1-NN + payload over Morton-sorted queries `qs` (M, 3), with
    `starts` (M / tm,) window starts (from `banded_window_starts`), `rt` /
    `rsq` from `banded_prepare` and `pay_t` (P, N) the payload in sorted
    reference order (K5's payload mode on a CUDA tensor). Returns (dist2
    (M,), payload (M, P)) in the sorted query order. Needs M % tm == 0,
    N % tn == 0 and 1 <= band <= N / tn."""
    _check_tiles("nn_payload_banded_sorted", qs.shape[0], rt.shape[1], tm, tn)
    rs, rpen = _rows(rt, rsq)
    return nn_payload_banded_stream_kernel(
        qs.to(torch.float32).contiguous(), rs, rpen,
        pay_t.T.to(torch.float32).contiguous(),
        starts.to(torch.int32).contiguous(), band, tm, tn)


def banded_blocks(rt, rsq, pay_t, tn: int = 1024):
    """`banded_prepare`'s outputs and the sorted payload in the (N / tn, .,
    tn) block layout of `nn_payload_banded_resident`: (rt3 (B, 3, tn),
    rsq3 (B, 1, tn), pay3 (B, P, tn))."""
    return tuple(a.reshape(a.shape[0], -1, tn).transpose(0, 1).contiguous()
                 for a in (rt, rsq, pay_t))


def nn_payload_banded_resident(qs, rt3, rsq3, pay3, starts, band: int = 8,
                               tm: int = 512, tn: int = 1024):
    """`nn_payload_banded_sorted` with the reference in `banded_blocks`
    layout (the TPU kept it resident in VMEM; K5 reads any reference the
    same way)."""
    if rt3.shape[2] != tn:
        raise ValueError(f"nn_payload_banded_resident: blocks of "
                         f"{rt3.shape[2]}, tn={tn}")
    rt, rsq, pay_t = (a.transpose(0, 1).reshape(a.shape[1], -1)
                      for a in (rt3, rsq3, pay3))
    return nn_payload_banded_sorted(qs, rt, rsq, pay_t, starts, band=band,
                                    tm=tm, tn=tn)
