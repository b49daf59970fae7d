"""The host side of the wire format and the recorded-sequence loader,
PyTorch port of `aicp_mapping_tpu.native` (numpy and threads; the JAX
package's C++ runtime, `native/src/runtime.cpp`, is not loaded).

- `voxel_downsample` and `voxel_downsample_q16`: the centroid voxel grid
  the streaming path runs on the host before upload, and its fused int16
  quantization. They give the C++ runtime's results bit for bit: voxels
  keyed by `floor(x * (1.0 / voxel))` in double with 21 bits per axis
  (points out of that range skipped), numbered by first touch, new voxels
  dropped once `capacity` are used (points still summed into the kept
  ones), sums in double in point order, centroids `sum / count` rounded to
  f32 once, and the q16 centre, scale and round-half-even of
  `runtime.cpp:160-200`.
- `ScanAccumulator`: the scan accumulator (range crop in the sensor frame,
  transform into odom, concatenation up to `capacity` until `batch_size`
  scans). The committed runtime library is compiled with `-march=native`
  and contracts the crop's `x*x + y*y + z*z` and each transformed row into
  fused multiply-adds (`fma(z, z, fma(x, x, y*y))`,
  `fma(z, T2, fma(x, T0, y*T1)) + T3`); `_fma32` rounds them the same way.
- `SequencePrefetcher`: ordered, multi-threaded reads of a recorded
  sequence through `io.pcd.read_cloud`, padded to a fixed capacity (a
  cloud over it is cut by the runtime's even stride); unreadable files are
  skipped.
- `read_cloud` and `write_pcd` (`binary` False, True or "compressed"):
  the cloud file IO under the JAX package's names here, served by
  `io.pcd`. JAX's `load` and `available` return the C++ library's
  handle; with no C++ runtime here they have no counterpart.
"""
from __future__ import annotations

import concurrent.futures
from typing import Optional, Sequence

import numpy as np

from .io.pcd import read_cloud, write_pcd  # noqa: F401

_AXIS_BITS = 21
_AXIS_OFFSET = 1 << (_AXIS_BITS - 1)


def _fma32(a, b, c) -> np.ndarray:
    """f32 fused multiply-add `a * b + c`, rounded once: the product is
    exact in f64 and the f64 sum is rounded to odd (Boldo and Melquiond),
    after which one rounding to f32 is the correctly rounded result."""
    p = np.asarray(a, np.float64) * np.asarray(b, np.float64)
    c = np.broadcast_to(np.asarray(c, np.float64), p.shape)
    s = p + c
    bp = s - c
    err = (p - bp) + (c - (s - bp))          # s + err == p + c exactly
    even = (s.view(np.int64) & 1) == 0
    fix = (err != 0) & even
    s = np.where(fix, np.nextafter(s, np.where(err > 0, np.inf, -np.inf)), s)
    return s.astype(np.float32)


def _voxel_slots(pts: np.ndarray, voxel: float, capacity: int):
    """(slot of each kept point, kept points, number of voxels): slots
    number the voxels by first touch; points out of the key range or in a
    voxel past `capacity` are not kept."""
    inv = 1.0 / float(np.float32(voxel))
    q = np.floor(pts.astype(np.float64) * inv)
    with np.errstate(invalid="ignore"):
        q = q.astype(np.int64) + _AXIS_OFFSET
    # in range on every axis: 0 <= q < 2^21, negatives wrapping high
    qu = q.view(np.uint64)
    ok = ((qu[:, 0] < (1 << _AXIS_BITS)) & (qu[:, 1] < (1 << _AXIS_BITS))
          & (qu[:, 2] < (1 << _AXIS_BITS)))
    kept = pts[ok]
    key = ((q[ok, 0] << (2 * _AXIS_BITS)) | (q[ok, 1] << _AXIS_BITS)
           | q[ok, 2])
    if len(key) == 0:
        return np.zeros(0, np.int64), kept, 0
    # group equal keys (an unstable sort; each group's first point is its
    # least index), then number the groups by their first points
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


def voxel_downsample(points: np.ndarray, voxel: float,
                     capacity: Optional[int] = None) -> np.ndarray:
    """Centroid voxel downsample on the host: (n, 3) f32, n <= capacity
    (default: the number of points)."""
    pts = np.ascontiguousarray(points, np.float32).reshape(-1, 3)
    cap = capacity or pts.shape[0]
    if not np.float32(voxel) > 0 or pts.shape[0] == 0:
        return np.zeros((0, 3), np.float32)
    return _centroids(pts, voxel, cap)


def voxel_downsample_q16(points: np.ndarray, voxel: float, capacity: int
                         ) -> tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Voxel downsample and int16 wire quantization in one pass: (q
    (capacity, 3) int16 zero-padded, scale (3,) f32, center (3,) f32,
    count). The device dequantizes p = q * scale + center."""
    pts = np.ascontiguousarray(points, np.float32).reshape(-1, 3)
    q = np.zeros((capacity, 3), np.int16)
    ds = (_centroids(pts, voxel, capacity)
          if np.float32(voxel) > 0 and pts.shape[0] else
          np.zeros((0, 3), np.float32))
    n = ds.shape[0]
    if n == 0:
        return (q, np.full(3, 1e-6, np.float32), np.zeros(3, np.float32), 0)
    q[:n], scale, center = quantize_q16(ds)
    return q, scale, center, n


def quantize_q16(pts: np.ndarray):
    """int16 quantization of (n, 3) f32 points, n > 0: (q (n, 3) int16,
    scale (3,) f32, center (3,) f32); the step is the extent / 65534 per
    axis, at least 1e-6, and offsets round half to even."""
    lo, hi = pts.min(axis=0), pts.max(axis=0)
    center = (hi + lo) * np.float32(0.5)
    scale = np.maximum((hi - lo) / np.float32(65534.0), np.float32(1e-6))
    return np.rint((pts - center) / scale).astype(np.int16), scale, center


class ScanAccumulator:
    """Batches `batch_size` sensor-frame scans into one odom-frame cloud
    with a [min_range, max_range] crop, up to `capacity` points."""

    def __init__(self, capacity: int = 262144, batch_size: int = 10,
                 min_range: float = 0.5, max_range: float = 30.0):
        self.capacity = int(capacity)
        self.batch_size = int(batch_size)
        self.min_range = float(min_range)
        self.max_range = float(max_range)
        self._parts: list = []
        self._count = 0
        self._n_scans = 0

    def push(self, points: np.ndarray, T_sensor_to_odom: np.ndarray) -> int:
        """Returns the number of points kept from this scan, or -1 when the
        batch is already full."""
        if self._n_scans >= self.batch_size:
            return -1
        self._n_scans += 1
        pts = np.ascontiguousarray(points, np.float32).reshape(-1, 3)
        T = np.ascontiguousarray(T_sensor_to_odom, np.float32).reshape(4, 4)
        x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
        lo, hi = np.float32(self.min_range), np.float32(self.max_range)
        r2 = _fma32(z, z, _fma32(x, x, y * y))
        keep = ~((r2 < lo * lo) | (r2 > hi * hi))
        x, y, z = x[keep], y[keep], z[keep]
        room = max(self.capacity - self._count, 0)
        x, y, z = x[:room], y[:room], z[:room]
        out = np.empty((len(x), 3), np.float32)
        for r in range(3):
            out[:, r] = _fma32(z, T[r, 2], _fma32(x, T[r, 0], y * T[r, 1])) \
                + T[r, 3]
        self._parts.append(out)
        self._count += len(out)
        return len(out)

    @property
    def count(self) -> int:
        return self._count

    @property
    def finished(self) -> bool:
        return self._n_scans >= self.batch_size

    def take(self) -> np.ndarray:
        """Returns the accumulated odom-frame cloud and resets."""
        out = (np.concatenate(self._parts) if self._parts
               else np.zeros((0, 3), np.float32))
        self.clear()
        return out

    def clear(self) -> None:
        self._parts = []
        self._count = 0
        self._n_scans = 0


def _load_padded(path: str, capacity: int, voxel: float):
    """(points padded to capacity, count, viewpoint) or None when the file
    cannot be read."""
    try:
        pts, vp = read_cloud(path)
    except (OSError, ValueError, KeyError):
        return None
    out = np.zeros((capacity, 3), np.float32)
    if voxel > 0:
        pts = voxel_downsample(pts, voxel, capacity)
    elif len(pts) > capacity:
        pts = pts[(np.arange(capacity) * (len(pts) / capacity)).astype(
            np.int64)]
    out[:len(pts)] = pts
    return out, len(pts), np.asarray(vp, np.float64)


class SequencePrefetcher:
    """Ordered multi-threaded cloud loader: iterates (index, points, count,
    viewpoint), points a (capacity, 3) f32 array zero past `count`, at most
    `window` files read ahead of delivery. Files that fail to read are
    skipped."""

    def __init__(self, paths: Sequence[str], capacity: int,
                 n_threads: int = 4, window: int = 8, voxel: float = 0.0):
        self.paths = [str(p) for p in paths]
        self.capacity = int(capacity)
        self.voxel = float(voxel)
        self._window = max(int(window), 1)
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=max(int(n_threads), 1),
            thread_name_prefix="aicp-prefetch")
        self._futures: dict = {}
        self._next_submit = 0
        self._next_deliver = 0

    def _fill(self) -> None:
        while (self._next_submit < len(self.paths)
               and self._next_submit < self._next_deliver + self._window):
            i = self._next_submit
            self._futures[i] = self._pool.submit(
                _load_padded, self.paths[i], self.capacity, self.voxel)
            self._next_submit += 1

    def __iter__(self):
        return self

    def __next__(self):
        while self._next_deliver < len(self.paths):
            self._fill()
            i = self._next_deliver
            item = self._futures.pop(i).result()
            self._next_deliver += 1
            if item is not None:
                return (i, *item)
        raise StopIteration

    def close(self) -> None:
        for fut in self._futures.values():
            fut.cancel()
        self._futures.clear()
        self._pool.shutdown(wait=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()
