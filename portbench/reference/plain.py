"""The plain frame path of the AICP front-end in PyTorch, frozen for the
benchmark's reference.

A copy, at commit d49b34b8df308b6b17527cfdc9cc292ea998a7ca, of the plain
(CPU-twin) code paths of `aicp_mapping_tpu_torch`: `geometry/se3.py`
(transforms, exponentials), `ops/voxel.py` (`voxel_downsample`,
`voxel_set_overlap`), `ops/banded_nn.py` (`morton_codes`,
`banded_window_starts`, `payload_rows`), `ops/knn.py` (`sq_dists`,
`nn_argmin`, `nn_payload`), `ops/normals.py` (the plain moments
`radius_moments` / `sorted_radius_moments` and `moments_to_normals`),
`ops/segmentation.py` (`_hough_prefilter_sorted`), `ops/quantile.py`
(`masked_quantile_hist`), `registration/icp.py` (`point_to_plane_icp`
with the full 1-NN matcher, without the SPMD, banded and
degeneracy-aware branches, which no cell drives), `native.py` and
`cloud.py` (the host voxel grid, the int16 wire and its fused-multiply-add
dequantize, `repin_roll_pitch_np`).
Nothing here imports the port or launches a kernel: every function is
plain PyTorch (or numpy) on the device of its inputs.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

BIG = 3.4e38
SENTINEL = 2**31 - 1
_EPS = 1e-9
_VALID_DIST = 1e30


# ---------------------------------------------------------------- se3 ----

def skew(v: torch.Tensor) -> torch.Tensor:
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack([
        torch.stack([zero, -z, y], dim=-1),
        torch.stack([z, zero, -x], dim=-1),
        torch.stack([-y, x, zero], dim=-1),
    ], dim=-2)


def _eye3_like(K: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=K.dtype, device=K.device).expand(K.shape)


def make_transform(rot: torch.Tensor, trans: torch.Tensor) -> torch.Tensor:
    T = torch.zeros(rot.shape[:-2] + (4, 4), dtype=rot.dtype,
                    device=rot.device)
    T[..., :3, :3] = rot
    T[..., :3, 3] = trans
    T[..., 3, 3] = 1.0
    return T


def transform_points(T: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    return points @ T[..., :3, :3].T + T[..., :3, 3]


def rotate_vectors(T: torch.Tensor, vecs: torch.Tensor) -> torch.Tensor:
    return vecs @ T[..., :3, :3].T


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    theta2 = torch.sum(w * w, dim=-1)[..., None, None]
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS * _EPS))
    K = skew(w)
    small = theta2 < 1e-8
    A = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    B = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / theta2)
    return _eye3_like(K) + A * K + B * (K @ K)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    v, w = xi[..., :3], xi[..., 3:]
    R = so3_exp(w)
    theta2 = torch.sum(w * w, dim=-1)[..., None, None]
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS * _EPS))
    K = skew(w)
    small = theta2 < 1e-8
    B = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / theta2)
    C = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta)) / (theta2 * theta))
    V = _eye3_like(K) + B * K + C * (K @ K)
    return make_transform(R, torch.einsum("...ij,...j->...i", V, v))


def repin_roll_pitch_np(corrected: np.ndarray,
                        odom: np.ndarray) -> np.ndarray:
    """Roll and pitch of `odom`, yaw and translation of `corrected`."""
    R_o = np.asarray(odom, np.float64)[:3, :3]
    R_c = np.asarray(corrected, np.float64)[:3, :3]
    roll = np.arctan2(R_o[2, 1], R_o[2, 2])
    pitch = -np.arcsin(np.clip(R_o[2, 0], -1.0, 1.0))
    yaw = np.arctan2(R_c[1, 0], R_c[0, 0])
    cr, sr = np.cos(roll), np.sin(roll)
    cp, sp = np.cos(pitch), np.sin(pitch)
    cy, sy = np.cos(yaw), np.sin(yaw)
    R = np.array([
        [cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr],
        [sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr],
        [-sp, cp * sr, cp * cr],
    ])
    out = np.eye(4, dtype=np.float32)
    out[:3, :3] = R.astype(np.float32)
    out[:3, 3] = np.asarray(corrected, np.float32)[:3, 3]
    return out


# ------------------------------------------------------- host wire ----

_AXIS_BITS = 21
_AXIS_OFFSET = 1 << (_AXIS_BITS - 1)


def _voxel_slots(pts: np.ndarray, voxel: float, capacity: int):
    inv = 1.0 / float(np.float32(voxel))
    q = np.floor(pts.astype(np.float64) * inv)
    with np.errstate(invalid="ignore"):
        q = q.astype(np.int64) + _AXIS_OFFSET
    qu = q.view(np.uint64)
    ok = ((qu[:, 0] < (1 << _AXIS_BITS)) & (qu[:, 1] < (1 << _AXIS_BITS))
          & (qu[:, 2] < (1 << _AXIS_BITS)))
    kept = pts[ok]
    key = ((q[ok, 0] << (2 * _AXIS_BITS)) | (q[ok, 1] << _AXIS_BITS)
           | q[ok, 2])
    if len(key) == 0:
        return np.zeros(0, np.int64), kept, 0
    perm = np.argsort(key)
    sk = key[perm]
    new_group = np.empty(len(sk), bool)
    new_group[0] = True
    np.not_equal(sk[1:], sk[:-1], out=new_group[1:])
    starts = np.flatnonzero(new_group)
    first = np.minimum.reduceat(perm, starts)
    is_first = np.zeros(len(key), bool)
    is_first[first] = True
    order = np.cumsum(is_first) - 1          # first-touch rank at points
    group = np.empty(len(key), np.int64)
    group[perm] = np.cumsum(new_group) - 1
    slot = order[first][group]
    n_slots = min(len(first), int(capacity))
    live = slot < n_slots
    return slot[live], kept[live], n_slots


def _centroids(pts: np.ndarray, voxel: float, capacity: int) -> np.ndarray:
    slot, kept, n = _voxel_slots(pts, voxel, capacity)
    counts = np.bincount(slot, minlength=n).astype(np.float64)
    out = np.empty((n, 3), np.float32)
    for a in range(3):
        sums = np.bincount(slot, weights=kept[:, a].astype(np.float64),
                           minlength=n)
        out[:, a] = (sums / counts).astype(np.float32)
    return out


def quantize_q16(pts: np.ndarray):
    lo, hi = pts.min(axis=0), pts.max(axis=0)
    center = (hi + lo) * np.float32(0.5)
    scale = np.maximum((hi - lo) / np.float32(65534.0), np.float32(1e-6))
    return np.rint((pts - center) / scale).astype(np.int16), scale, center


def fma_f32(q: torch.Tensor, scale: torch.Tensor,
            center: torch.Tensor) -> torch.Tensor:
    """`q * scale + center` in f32, rounded once."""
    p = q.to(torch.float64) * scale.to(torch.float64)
    c = center.to(torch.float64).expand_as(p)
    s = p + c
    bp = s - c
    err = (p - bp) + (c - (s - bp))
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.full_like(s, float("inf")),
                         torch.full_like(s, float("-inf")))
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.to(torch.float32)


def wire_cloud(pts: np.ndarray, voxel: float, capacity: int, device):
    """The int16 wire: host voxel grid, quantization, and the device's
    dequantize. Returns (points (capacity, 3), mask (capacity,))."""
    pts = np.ascontiguousarray(pts, np.float32).reshape(-1, 3)
    q = np.zeros((capacity, 3), np.int16)
    ds = _centroids(pts, voxel, capacity)
    n = ds.shape[0]
    if n == 0:
        scale, center = np.full(3, 1e-6, np.float32), np.zeros(3, np.float32)
    else:
        q[:n], scale, center = quantize_q16(ds)
    qd = torch.as_tensor(q, device=device)
    points = fma_f32(qd, torch.as_tensor(scale, device=device),
                     torch.as_tensor(center, device=device))
    return points, torch.arange(capacity, device=device) < n


# ------------------------------------------------------------ voxel ----

GRID_BITS = 10
GRID = 1 << GRID_BITS
INVALID_KEY = 2**31 - 1
_KEY_MASK = (1 << (3 * GRID_BITS)) - 1
_MIX_ODD = 0x2545F491


def _mix_keys(keys):
    mixed = (keys * _MIX_ODD) & _KEY_MASK
    return torch.where(keys == INVALID_KEY, INVALID_KEY, mixed)


def _masked_min(points, mask):
    return torch.where(mask[:, None], points, BIG).amin(0)


def _grid_index(points, origin, voxel_size):
    q = torch.floor((points - origin) / voxel_size)
    return torch.clamp(q, 0, GRID - 1).to(torch.int64)


def _pack(ijk):
    return ((ijk[:, 0] << (2 * GRID_BITS)) | (ijk[:, 1] << GRID_BITS)
            | ijk[:, 2])


def voxel_keys(points, mask, voxel_size, origin=None):
    if origin is None:
        origin = _masked_min(points, mask)
    key = _pack(_grid_index(points, origin, voxel_size))
    return torch.where(mask, key, INVALID_KEY)


def voxel_downsample(points, mask, voxel_size, capacity: int):
    """Centroid voxel grid on the device: (points (capacity, 3), mask)."""
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
    slot = torch.where(valid & (seg < capacity), seg, capacity)
    sums = torch.zeros((capacity + 1, 3), dtype=torch.float64, device=dev)
    sums.index_add_(0, slot, off[perm].to(torch.float64))
    cnts = torch.zeros((capacity + 1,), dtype=torch.float64, device=dev)
    cnts.index_add_(0, slot, valid.to(torch.float64))
    vkey = torch.zeros((capacity + 1,), dtype=torch.int64, device=dev)
    vkey[slot] = ukey[perm]
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


def voxel_set_overlap(points_a, mask_a, points_b, mask_b, voxel_size):
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


def overlap_percent(ref_points, ref_mask, fpts, fmask, resolution):
    n_common, n_ref, n_read = voxel_set_overlap(ref_points, ref_mask, fpts,
                                                fmask, resolution)
    ra = n_common / torch.clamp(n_ref, min=1)
    rb = n_common / torch.clamp(n_read, min=1)
    return torch.minimum(ra, rb) * 100.0


# ----------------------------------------------------------- morton ----

def _spread3(v):
    v = v & 0x3FF
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def morton_codes(points, mask, origin, cell_size):
    q = torch.clamp(torch.floor((points - origin) / cell_size), 0, 1023)
    q = q.to(torch.int64)
    code = ((_spread3(q[:, 0]) << 2) | (_spread3(q[:, 1]) << 1)
            | _spread3(q[:, 2]))
    return torch.where(mask, code, SENTINEL)


def banded_window_starts(qcodes, rcodes_s, n_rblocks: int, band: int,
                         tm: int, tn: int):
    band = min(band, n_rblocks)
    tiles = qcodes.reshape(-1, tm)
    tile_lo = tiles.amin(1)
    tile_hi = torch.where(tiles == SENTINEL, -1, tiles).amax(1)
    tile_hi = torch.maximum(tile_hi, tile_lo)
    lo_pos = torch.searchsorted(rcodes_s, tile_lo, right=False)
    hi_pos = torch.searchsorted(rcodes_s, tile_hi, right=True)
    center = (lo_pos + hi_pos) // (2 * tn)
    return torch.clamp(center - band // 2, 0,
                       max(n_rblocks - band, 0)).to(torch.int32)


# ---------------------------------------------------------- 1-NN ----

def sq_dists(q, r):
    dx = q[:, 0, None] - r[None, :, 0]
    dy = q[:, 1, None] - r[None, :, 1]
    dz = q[:, 2, None] - r[None, :, 2]
    return dx * dx + dy * dy + dz * dz


def nn_payload(queries, qmask, refs, rmask, payload, block: int = 512):
    """1-NN with the winner's payload row; ties to the lowest index."""
    dists, idxs = [], []
    for s in range(0, queries.shape[0], block):
        d = torch.where(rmask[None, :], sq_dists(queries[s:s + block], refs),
                        BIG)
        i = torch.argmin(d, dim=1)
        idxs.append(i)
        dists.append(torch.gather(d, 1, i[:, None])[:, 0])
    dist = torch.where(qmask, torch.cat(dists), BIG)
    idx = torch.where(qmask, torch.cat(idxs), 0)
    return dist, torch.where(qmask[:, None], payload[idx], 0.0)


# --------------------------------------------------------- moments ----

BANDED_MIN_POINTS = 16384
_THIRD = float(np.float32(1.0 / 3.0))
_SIXTH = float(np.float32(1.0 / 6.0))


def banded_by_shape(n: int) -> bool:
    return n >= BANDED_MIN_POINTS and n % 1024 == 0


def _features(points, mask):
    x, y, z = points.double().unbind(1)
    Fm = torch.stack([x, y, z, x * x, y * y, z * z, x * y, x * z, y * z,
                      torch.ones_like(x)], dim=1)
    return Fm * mask.to(Fm.dtype)[:, None]


def _rad2(radius) -> float:
    return float(np.float32(float(radius) * float(radius)))


def _window_moments(q, refs, rmask, Fm, rad2):
    w = (sq_dists(q, refs) <= rad2) & rmask[None, :]
    return w.to(Fm.dtype) @ Fm


def radius_moments(points, mask, radius, block: int = 512):
    Fm = _features(points, mask)
    rad2 = _rad2(radius)
    return torch.cat([
        _window_moments(points[s:s + block], points, mask, Fm, rad2)
        for s in range(0, points.shape[0], block)]).float()


def sorted_radius_moments(ps, ms, codes_s, radius, band: int = 8,
                          tm: int = 512, tn: int = 1024):
    N = ps.shape[0]
    n_rblocks = N // tn
    band = min(band, n_rblocks)
    starts = banded_window_starts(codes_s, codes_s, n_rblocks, band, tm, tn)
    Fm = _features(ps, ms)
    rad2 = _rad2(radius)
    out = []
    for g, s in enumerate(starts.tolist()):
        w = slice(s * tn, (s + band) * tn)
        out.append(_window_moments(ps[g * tm:(g + 1) * tm], ps[w], ms[w],
                                   Fm[w], rad2))
    return torch.cat(out).float()


def _det3(B):
    return (B[..., 0, 0] * (B[..., 1, 1] * B[..., 2, 2]
                            - B[..., 1, 2] * B[..., 2, 1])
            - B[..., 0, 1] * (B[..., 1, 0] * B[..., 2, 2]
                              - B[..., 1, 2] * B[..., 2, 0])
            + B[..., 0, 2] * (B[..., 1, 0] * B[..., 2, 1]
                              - B[..., 1, 1] * B[..., 2, 0]))


def _sum3(v):
    return v[..., 0] + v[..., 1] + v[..., 2]


def _f64(fn, x):
    return fn(x.double()).float()


def _cross(a, b):
    return torch.linalg.cross(a.double(), b.double(), dim=-1).float()


def _eigh3x3_smallest(A):
    tr = A[..., 0, 0] + A[..., 1, 1] + A[..., 2, 2]
    q = tr * _THIRD
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    B = A - q[..., None, None] * eye
    sq = (B * B).flatten(-2)
    p2 = sq[..., 0]
    for k in range(1, 9):
        p2 = p2 + sq[..., k]
    p = torch.sqrt(torch.clamp(p2 * _SIXTH, min=1e-30))
    pm = torch.clamp(p, min=1e-30)
    r = _det3(B) / (2.0 * (pm * pm * pm))
    phi = _f64(torch.arccos, torch.clamp(r, -1.0, 1.0)) * _THIRD
    l0, l2 = q + 2.0 * p * _f64(torch.cos, torch.stack(
        [phi, phi + 2.0 * math.pi / 3.0]))
    l1 = tr - l0 - l2
    eigvals = torch.stack([l2, l1, l0], dim=-1)
    M = A - l2[..., None, None] * eye
    r0, r1, r2 = M[..., 0, :], M[..., 1, :], M[..., 2, :]
    cands = _cross(torch.stack([r0, r0, r1], dim=-2),
                   torch.stack([r1, r2, r2], dim=-2))
    best = torch.argmax(_sum3(cands * cands), dim=-1)
    v = torch.gather(cands, -2, best[..., None, None].expand(
        best.shape + (1, 3)))[..., 0, :]
    norm = torch.sqrt(_sum3(v * v))[..., None]
    up = torch.zeros(3, dtype=A.dtype, device=A.device)
    up[2] = 1.0
    v = torch.where(norm > 1e-12, v / torch.clamp(norm, min=1e-12), up)
    return eigvals, v


def moments_to_normals(M, points, mask, viewpoint=None):
    """(N, 10) moments -> (normals (N, 3), curvature (N,))."""
    cnt = torch.clamp(M[:, 9], min=1.0)
    mean = (M[:, 0:3] / cnt[:, None]).double()
    exx = M[:, 3:6] / cnt[:, None]
    exy = M[:, 6:9] / cnt[:, None]

    def entry(e, a, b):
        return (e.double() - mean[:, a] * mean[:, b]).float()

    cxy, cxz, cyz = entry(exy[:, 0], 0, 1), entry(exy[:, 1], 0, 2), \
        entry(exy[:, 2], 1, 2)
    cov = torch.stack([
        torch.stack([entry(exx[:, 0], 0, 0), cxy, cxz], dim=-1),
        torch.stack([cxy, entry(exx[:, 1], 1, 1), cyz], dim=-1),
        torch.stack([cxz, cyz, entry(exx[:, 2], 2, 2)], dim=-1),
    ], dim=-2)
    eigvals, normal = _eigh3x3_smallest(cov)
    denom = torch.clamp(_sum3(eigvals), min=1e-12)
    curvature = torch.clamp(eigvals[..., 0], min=0.0) / denom
    if viewpoint is not None:
        flip = _sum3(normal * (viewpoint - points)) < 0
        normal = torch.where(flip[:, None], -normal, normal)
    normal = torch.where(mask[:, None], normal, 0.0)
    curvature = torch.where(mask, curvature, 0.0)
    return normal, curvature


# ------------------------------------------------- hough prefilter ----

def _hough_key(points, normals, normal_bins: int, offset_res: float):
    q = torch.round(normals * normal_bins).to(torch.int64) + normal_bins
    B = 2 * normal_bins + 2
    d = (normals * points).sum(-1)
    dq = torch.clamp(torch.round(d / offset_res), -2047, 2047)
    return ((q[:, 0] * B + q[:, 1]) * B + q[:, 2]) * 4096 \
        + (dq.to(torch.int64) + 2048)


def _bitrev17(x):
    r = torch.zeros_like(x)
    for i in range(17):
        r = r | (((x >> i) & 1) << (16 - i))
    return r


def _stable_perm(key):
    return torch.sort(key, stable=True).indices


def _run_starts(k):
    s = torch.ones_like(k, dtype=torch.bool)
    s[1:] = k[1:] != k[:-1]
    return s


def hough_prefilter(points, mask, viewpoint, normal_radius,
                    min_cluster_size: int, out_capacity: int,
                    curvature_thresh: float = 1.0, normal_bins: int = 6,
                    offset_res: float = 0.15, moments_out=None):
    """Morton sort -> radius moments -> normals -> hough plane cells ->
    small-cluster filter -> cluster-balanced compaction: (points, mask,
    normals) at `out_capacity`. `moments_out`, a list, gets the moments
    and the valid rows, in Morton order."""
    n = points.shape[0]
    dev = points.device
    iota = torch.arange(n, device=dev)
    origin = torch.where(mask[:, None], points, BIG).amin(0)
    codes = morton_codes(points, mask, origin, 2.0)
    codes_s, perm = torch.sort(codes, stable=True)
    ps = points[perm]
    ms = codes_s != SENTINEL
    if banded_by_shape(n):
        M = sorted_radius_moments(ps, ms, codes_s, normal_radius)
    else:
        M = radius_moments(ps, ms, normal_radius)
    if moments_out is not None:
        moments_out.append((M, ms))
    normals, curvature = moments_to_normals(M, ps, ms, viewpoint)
    valid = ms & (curvature <= curvature_thresh)
    hkey = torch.where(valid, _hough_key(ps, normals, normal_bins,
                                         offset_res), SENTINEL)
    p2 = _stable_perm(hkey)
    k2 = hkey[p2]
    cols2 = torch.cat([ps, normals, curvature[:, None]], dim=1)[p2]
    valid2 = k2 != SENTINEL
    is_start = _run_starts(k2)
    is_end = torch.ones_like(is_start)
    is_end[:-1] = is_start[1:]
    label = torch.cumsum(is_start.to(torch.int64), 0) - 1
    start_pos = torch.cummax(torch.where(is_start, iota, 0), 0).values
    end_pos = torch.flip(torch.cummin(torch.flip(
        torch.where(is_end, iota, n - 1), [0]), 0).values, [0])
    keep = valid2 & (end_pos - start_pos + 1 >= min_cluster_size)
    pos = iota - start_pos
    lbl_k = torch.where(keep, label, SENTINEL)
    p3 = _stable_perm(lbl_k * (1 << 17) + _bitrev17(pos))
    k3 = lbl_k[p3]
    cols3 = cols2[p3]
    rank = iota - torch.cummax(torch.where(_run_starts(k3), iota, 0),
                               0).values
    kept3 = k3 != SENTINEL
    rank_k = torch.where(kept3, rank, SENTINEL)
    p4 = _stable_perm(rank_k * (1 << 32) + k3)
    cols4 = cols3[p4][:out_capacity]
    out_mask = iota[:out_capacity] < kept3.sum()
    cols4 = torch.where(out_mask[:, None], cols4, 0.0)
    return (cols4[:, 0:3].contiguous(), out_mask,
            cols4[:, 3:6].contiguous())


# --------------------------------------------------------- quantile ----

def _linspace_f32(start: float, stop: float, num: int, device):
    div = num - 1
    step = torch.arange(div, dtype=torch.float32, device=device) / div
    head = start * (1.0 - step) + stop * step
    return torch.cat([head, torch.full((1,), stop, dtype=torch.float32,
                                       device=device)])


def masked_quantile_hist(values, mask, q, bins: int = 128, rounds: int = 2):
    dev = values.device
    n = mask.to(torch.float32).sum()
    target = torch.ceil(q * n)
    lo = torch.zeros((), dtype=torch.float32, device=dev)
    hi = torch.clamp(torch.where(mask, values, -BIG).max(), min=1e-12)
    vm = torch.where(mask, values, BIG)
    base = _linspace_f32(1.0 / bins, 1.0, bins, dev)
    for _ in range(rounds):
        edges = lo + (hi - lo) * base
        counts = (vm[:, None] <= edges[None, :]).sum(0).to(torch.float32)
        meets = counts >= target
        b = torch.argmax(meets.to(torch.int32))
        b = torch.where(meets.any(), b, bins - 1)
        width = (hi - lo) / bins
        new_lo = lo + width * b.to(torch.float32)
        hi = new_lo + width
        lo = torch.where(b > 0, new_lo, lo)
    return hi


# -------------------------------------------------------------- ICP ----

@dataclasses.dataclass(frozen=True)
class ICPConfig:
    max_iterations: int = 20
    min_diff_trans: float = 0.01
    min_diff_rot: float = 0.001
    smooth_length: int = 4
    damping: float = 1e-6
    max_match_dist: float = 0.0
    trim_normal_space: bool = False
    coarse_iterations: int = 0
    coarse_decimation: int = 4


@dataclasses.dataclass(frozen=True)
class ICPResult:
    T: torch.Tensor
    n_iterations: int


def icp(reading_points, reading_mask, ref_points, ref_normals, ref_mask,
        init_T, trim_ratio, cfg: ICPConfig) -> ICPResult:
    """Trimmed point-to-plane ICP, coarse to fine when the reading divides
    into whole tiles of 512 at the decimation."""
    M = reading_points.shape[0]
    d = cfg.coarse_decimation
    if cfg.coarse_iterations > 0 and d > 1 and M % (512 * d) == 0:
        ccfg = dataclasses.replace(
            cfg, coarse_iterations=0, max_iterations=cfg.coarse_iterations,
            min_diff_trans=cfg.min_diff_trans * 2.0,
            min_diff_rot=cfg.min_diff_rot * 2.0)
        coarse = icp(reading_points[::d].contiguous(),
                     reading_mask[::d].contiguous(), ref_points, ref_normals,
                     ref_mask, init_T, trim_ratio, ccfg)
        fcfg = dataclasses.replace(
            cfg, coarse_iterations=0,
            max_iterations=max(cfg.max_iterations - cfg.coarse_iterations,
                               1),
            smooth_length=min(cfg.smooth_length, 2))
        fine = icp(reading_points, reading_mask, ref_points, ref_normals,
                   ref_mask, coarse.T, trim_ratio, fcfg)
        return ICPResult(fine.T, fine.n_iterations + coarse.n_iterations)

    dev = reading_points.device
    payload = torch.cat([ref_points, ref_normals, torch.zeros(
        (ref_points.shape[0], 2), dtype=torch.float32, device=dev)], 1)
    m_f = reading_mask.to(torch.float32)
    mmd2 = (float(np.float32(cfg.max_match_dist ** 2))
            if cfg.max_match_dist > 0.0 else None)
    eye6 = torch.eye(6, dtype=torch.float32, device=dev)

    def iteration(T):
        p = transform_points(T, reading_points)
        dist2, pout = nn_payload(p, reading_mask, ref_points, ref_mask,
                                 payload)
        q, n = pout[:, :3], pout[:, 3:6]
        matched = reading_mask & (dist2 < _VALID_DIST)
        if cfg.trim_normal_space:
            bucket = torch.argmax(torch.abs(n), dim=-1)
            tb = torch.stack([
                masked_quantile_hist(dist2, matched & (bucket == k),
                                     trim_ratio) for k in range(3)])
            if mmd2 is not None:
                tb = torch.clamp(tb, max=mmd2)
            thresh = tb[bucket]
        else:
            thresh = masked_quantile_hist(dist2, matched, trim_ratio)
            if mmd2 is not None:
                thresh = torch.clamp(thresh, max=mmd2)
        valid = (dist2 < _VALID_DIST).to(torch.float32)
        w = m_f * (dist2 <= thresh).to(torch.float32) * valid
        r = (n * (p - q)).sum(-1)
        J = torch.cat([n, torch.linalg.cross(p, n, dim=-1)], dim=-1)
        Jw = J * w[:, None]
        A = Jw.T @ J
        b = -(Jw.T @ r)
        lam = cfg.damping * torch.trace(A) / 6.0 + 1e-12
        return torch.linalg.solve(A + lam * eye6, b)

    S = cfg.smooth_length
    T = init_T.to(torch.float32)
    hist_t = torch.full((S,), BIG, dtype=torch.float32, device=dev)
    hist_r = torch.full((S,), BIG, dtype=torch.float32, device=dev)
    it = 0
    while it < cfg.max_iterations:
        delta = iteration(T)
        T = se3_exp(delta) @ T
        hist_t = torch.cat([torch.linalg.norm(delta[:3])[None], hist_t[:-1]])
        hist_r = torch.cat([torch.linalg.norm(delta[3:])[None], hist_r[:-1]])
        it += 1
        if it >= S and bool((hist_t.mean() < cfg.min_diff_trans)
                            & (hist_r.mean() < cfg.min_diff_rot)):
            break
    return ICPResult(T, it)


def clamp_trim_ratio(overlap, lo: float, hi: float):
    return torch.clamp(overlap / 100.0, lo, hi)
