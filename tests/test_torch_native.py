"""The port's host wire functions (`aicp_mapping_tpu_torch.native`) against
the JAX package's C++ runtime library, bit for bit: the voxel grid and its
int16 quantization, the scan accumulator and the ordered prefetcher."""
import os

import numpy as np
import pytest

from aicp_mapping_tpu import native as jnative
from aicp_mapping_tpu_torch import native
from aicp_mapping_tpu_torch.io.pcd import write_pcd


@pytest.fixture(scope="module", autouse=True)
def library():
    """JAX's results here must come from the runtime library, not from its
    Python fallback (which keys voxels differently)."""
    if not jnative.available():
        pytest.skip("the JAX package's runtime library is not loaded")


def _cloud(n, seed, lo=-30.0, hi=30.0):
    rng = np.random.default_rng(seed)
    return rng.uniform(lo, hi, (n, 3)).astype(np.float32)


def _boundary_cloud(voxel=0.08, seed=5):
    """Points on and one ulp around voxel boundaries, repeated so that
    voxels collect several points in shuffled order."""
    rng = np.random.default_rng(seed)
    k = rng.integers(-400, 400, (3000, 3))
    on = (k * np.float32(voxel)).astype(np.float32)
    pts = np.concatenate([on, np.nextafter(on, np.float32(np.inf)),
                          np.nextafter(on, np.float32(-np.inf)),
                          on + np.float32(voxel / 2)])
    return pts[rng.permutation(len(pts))]


def _huge_cloud():
    """Points whose 21-bit keys overflow on some axis (skipped) among
    points in range."""
    pts = _cloud(2000, 7)
    pts[::7, 0] = 9.0e4          # 9e4 / 0.08 > 2^20 voxels
    pts[3::11, 2] = -8.5e4
    pts[5::13, 1] = np.float32(2 ** 20 * 0.08 - 0.01)
    return pts


CASES = {
    "random": (_cloud(60000, 1), 0.08, 32768),
    "capacity cut": (_cloud(20000, 2), 0.2, 1000),
    "boundaries": (_boundary_cloud(), 0.08, 16384),
    "out of range keys": (_huge_cloud(), 0.08, 4096),
    "coarse voxel": (_cloud(5000, 3, 0.0, 4.0), 1.0, 64),
    "one point": (_cloud(1, 4), 0.08, 16),
    "empty": (np.zeros((0, 3), np.float32), 0.08, 16),
    "voxel zero": (_cloud(100, 6), 0.0, 128),
    "voxel negative": (_cloud(100, 6), -0.5, 128),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_voxel_downsample_matches_native(case):
    pts, voxel, cap = CASES[case]
    want = jnative.voxel_downsample(pts, voxel, capacity=cap)
    got = native.voxel_downsample(pts, voxel, capacity=cap)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", sorted(CASES))
def test_voxel_downsample_q16_matches_native(case):
    pts, voxel, cap = CASES[case]
    want = jnative.voxel_downsample_q16(pts, voxel, cap)
    got = native.voxel_downsample_q16(pts, voxel, cap)
    assert got[3] == want[3]
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_voxel_downsample_default_capacity():
    pts = _cloud(3000, 8, 0.0, 2.0)
    np.testing.assert_array_equal(native.voxel_downsample(pts, 0.3),
                                  jnative.voxel_downsample(pts, 0.3))


def test_fma32_is_the_fused_multiply_add():
    """`_fma32` rounds a*b + c once: against exact rational arithmetic on
    cases chosen so that rounding the product first, or the f64 sum,
    would round differently."""
    from fractions import Fraction

    rng = np.random.default_rng(9)
    a = rng.uniform(-3, 3, 4000).astype(np.float32)
    b = rng.uniform(-3, 3, 4000).astype(np.float32)
    c = (-(a.astype(np.float64) * b)).astype(np.float32)   # cancellation
    c[::2] = rng.uniform(-1e3, 1e3, 2000).astype(np.float32)
    c[1::4] = np.float32(1.0)
    a[1::4] = np.float32(2.0 ** -24)
    b[1::4] = np.float32(1.0) + np.float32(2.0 ** -23) * rng.integers(
        0, 4, 1000).astype(np.float32)
    got = native._fma32(a, b, c)
    for i in range(0, 4000, 7):
        exact = Fraction(float(a[i])) * Fraction(float(b[i])) \
            + Fraction(float(c[i]))
        lo = np.float32(float(exact))
        # the nearest f32 (ties to even) to the exact value
        cands = [np.nextafter(lo, np.float32(-np.inf)), lo,
                 np.nextafter(lo, np.float32(np.inf))]
        best = min(cands, key=lambda v: (abs(Fraction(float(v)) - exact),
                                         int(np.float32(v).view(np.int32))
                                         & 1))
        assert got[i] == best, (i, a[i], b[i], c[i], got[i], best)


def _scans(seed, n_scans=4, n=3000):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_scans):
        pts = rng.normal(0, 12, (n, 3)).astype(np.float32)
        pts[:5] = 0.0                                   # below min_range
        th = rng.uniform(-np.pi, np.pi)
        T = np.eye(4, dtype=np.float32)
        T[:2, :2] = [[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]]
        T[:3, 3] = rng.normal(0, 20, 3)
        out.append((pts, T))
    return out


@pytest.mark.parametrize("capacity,batch", [(262144, 3), (5000, 4), (7, 2)])
def test_scan_accumulator_matches_native(capacity, batch):
    kw = dict(capacity=capacity, batch_size=batch, min_range=0.5,
              max_range=30.0)
    got, want = native.ScanAccumulator(**kw), jnative.ScanAccumulator(**kw)
    for pts, T in _scans(capacity + batch):
        assert got.push(pts, T) == want.push(pts, T)
        assert (got.count, got.finished) == (want.count, want.finished)
    a, b = got.take(), want.take()
    assert a.dtype == np.float32
    np.testing.assert_array_equal(a, b)
    assert got.count == want.count == 0 and not got.finished
    pts, T = _scans(1, 1)[0]
    got.push(pts, T)
    want.push(pts, T)
    got.clear()
    want.clear()
    assert got.take().shape == want.take().shape == (0, 3)


def _write_sequence(tmp_path, n=6):
    paths = []
    for i in range(n):
        path = str(tmp_path / f"c{i}.pcd")
        pts = _cloud(500 + 300 * i, 20 + i, -8.0, 8.0)
        write_pcd(path, pts, viewpoint=(i, 0, 0, 1, 0, 0, 0))
        paths.append(path)
    bad = str(tmp_path / "broken.pcd")
    with open(bad, "w") as f:
        f.write("not a point cloud\n")
    return paths[:2] + [bad, str(tmp_path / "missing.pcd")] + paths[2:]


@pytest.mark.parametrize("voxel,capacity", [(0.0, 1024), (0.0, 4096),
                                            (0.5, 1024)])
def test_prefetcher_matches_native(tmp_path, voxel, capacity):
    """In order, padded, cut by the runtime's stride (or voxelized), the
    unreadable files skipped."""
    paths = _write_sequence(tmp_path)
    want = list(jnative.SequencePrefetcher(paths, capacity, n_threads=3,
                                           window=2, voxel=voxel))
    with native.SequencePrefetcher(paths, capacity, n_threads=3, window=2,
                                   voxel=voxel) as pf:
        got = list(pf)
    assert [g[0] for g in got] == [w[0] for w in want] == [0, 1, 4, 5, 6, 7]
    for (gi, gp, gn, gv), (wi, wp, wn, wv) in zip(got, want):
        assert gn == wn and gp.shape == wp.shape == (capacity, 3)
        np.testing.assert_array_equal(gp, wp)
        np.testing.assert_allclose(gv, wv)
    assert os.path.exists(paths[0])
