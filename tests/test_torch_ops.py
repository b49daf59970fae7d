"""Parity of the PyTorch port's geometry, voxel, quantile and Morton ops
with the JAX package on the same numpy inputs (CPU)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aicp_mapping_tpu.geometry import se3 as jse3
from aicp_mapping_tpu.ops import banded_nn as jband
from aicp_mapping_tpu.ops import quantile as jquant
from aicp_mapping_tpu.ops import voxel as jvox
from aicp_mapping_tpu_torch.geometry import se3
from aicp_mapping_tpu_torch.ops import banded_nn, quantile, voxel

torch.set_num_threads(1)


def _t(a):
    return torch.as_tensor(np.array(a))


def _twists(seed=0):
    rng = np.random.default_rng(seed)
    xi = rng.normal(0, 0.3, (6, 6)).astype(np.float32)
    xi[1, 3:] = [1e-5, -2e-5, 3e-6]        # small-angle branch of se3_log
    xi[2, 3:] = 0.0                        # pure translation
    xi[3, 3:] = [0.0, 0.0, 2.5]            # large rotation
    return xi


def test_se3_exp_log_round_trip_and_jax_parity():
    xi = _twists()
    T = se3.se3_exp(_t(xi))
    np.testing.assert_allclose(T.numpy(), np.asarray(jse3.se3_exp(xi)),
                               atol=2e-6)
    np.testing.assert_allclose(se3.se3_log(T).numpy(), xi, atol=2e-5)
    np.testing.assert_allclose(
        se3.se3_log(T).numpy(),
        np.asarray(jse3.se3_log(jnp.asarray(T.numpy()))), atol=2e-6)
    eye = torch.eye(4).expand(6, 4, 4)
    np.testing.assert_allclose((se3.inverse(T) @ T).numpy(), eye.numpy(),
                               atol=2e-6)
    np.testing.assert_allclose(se3.so3_exp(_t(xi[:, 3:])).numpy(),
                               np.asarray(jse3.so3_exp(xi[:, 3:])), atol=2e-6)


def test_transform_points_and_skew_match_jax():
    rng = np.random.default_rng(1)
    pts = rng.uniform(-60, 60, (257, 3)).astype(np.float32)
    T = np.asarray(jse3.se3_exp(_twists(1)[0]))
    np.testing.assert_allclose(
        se3.transform_points(_t(T), _t(pts)).numpy(),
        np.asarray(jse3.transform_points(T, pts)), atol=2e-5)
    np.testing.assert_allclose(se3.rotate_vectors(_t(T), _t(pts)).numpy(),
                               np.asarray(jse3.rotate_vectors(T, pts)),
                               atol=2e-5)
    np.testing.assert_array_equal(se3.skew(_t(pts)).numpy(),
                                  np.asarray(jse3.skew(pts)))
    R = np.asarray(jse3.so3_exp(np.float32([0.1, -0.2, 0.3])))
    t = np.float32([1.0, 2.0, 3.0])
    np.testing.assert_array_equal(se3.make_transform(_t(R), _t(t)).numpy(),
                                  np.asarray(jse3.make_transform(R, t)))


def _cloud(seed, n, cap, offset=(0.0, 0.0, 0.0), extent=2.0):
    rng = np.random.default_rng(seed)
    pts = np.zeros((cap, 3), np.float32)
    pts[:n] = rng.uniform(-extent, extent, (n, 3)) + np.float32(offset)
    mask = np.zeros(cap, bool)
    mask[:n] = rng.uniform(size=n) > 0.05
    return pts, mask


def test_mix_keys_bit_exact():
    rng = np.random.default_rng(2)
    keys = rng.integers(0, 2**30, 4096).astype(np.int32)
    keys[:3] = [0, 2**30 - 1, 2**31 - 1]
    np.testing.assert_array_equal(
        voxel._mix_keys(_t(keys).long()).numpy(),
        np.asarray(jvox._mix_keys(jnp.asarray(keys))))


@pytest.mark.parametrize("offset,capacity", [((0.0, 0.0, 0.0), 2048),
                                             ((45.0, -38.0, 1.5), 2048),
                                             ((0.0, 0.0, 0.0), 300)])
def test_voxel_downsample_matches_jax(offset, capacity):
    """Same voxels in the same (mixed-key) order, including the overflow
    cut at a small capacity; centroids within 1e-5 m."""
    pts, mask = _cloud(3, 1000, 1024, offset, extent=0.6)
    jp, jm = jvox.voxel_downsample(pts, mask, 0.08, capacity)
    tp, tm = voxel.voxel_downsample(_t(pts), _t(mask), 0.08, capacity)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-5)


def test_voxel_keys_overlap_and_count_match_jax():
    pa, ma = _cloud(4, 1500, 2048, extent=3.0)
    pb, mb = _cloud(5, 1200, 1536, (0.5, 0.0, 0.0), extent=3.0)
    np.testing.assert_array_equal(
        voxel.voxel_keys(_t(pa), _t(ma), 0.2).numpy(),
        np.asarray(jvox.voxel_keys(pa, ma, 0.2)))
    got = voxel.voxel_set_overlap(_t(pa), _t(ma), _t(pb), _t(mb), 0.2)
    want = jvox.voxel_set_overlap(pa, ma, pb, mb, 0.2)
    assert [int(g) for g in got] == [int(w) for w in want]
    assert int(got[0]) > 0
    assert int(voxel.unique_voxel_count(_t(pa), _t(ma), 0.2)) == \
        int(jvox.unique_voxel_count(pa, ma, 0.2))


def test_crop_box_matches_jax():
    pts, mask = _cloud(6, 900, 1024, extent=10.0)
    T = np.asarray(jse3.se3_exp(np.float32([1.0, -2.0, 0.5, 0.1, 0.0, 0.3])))
    np.testing.assert_array_equal(
        voxel.crop_box(_t(pts), _t(mask), _t(T), -4.0, 4.0).numpy(),
        np.asarray(jvox.crop_box(pts, mask, T, -4.0, 4.0)))


def test_linspace_edges_bit_exact():
    got = quantile._linspace_f32(1.0 / 128, 1.0, 128, "cpu").numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jnp.linspace(1.0 / 128, 1.0, 128)))


@pytest.mark.parametrize("q", [0.25, 0.5, 0.7, 1.0])
def test_masked_quantile_hist_matches_jax(q):
    rng = np.random.default_rng(7)
    v = (rng.exponential(0.05, 3000) ** 2).astype(np.float32)
    m = rng.uniform(size=3000) > 0.2
    v[~m] = 3.4e38                          # unmatched sentinels, masked
    got = float(quantile.masked_quantile_hist(_t(v), _t(m),
                                              torch.tensor(q)))
    want = float(jquant.masked_quantile_hist(v, m, jnp.float32(q)))
    assert abs(got - want) <= 1e-6 * abs(want), (got, want)
    exact = float(jquant.masked_quantile(v, m, jnp.float32(q)))
    assert float(quantile.masked_quantile(_t(v), _t(m), q)) == exact


def test_morton_codes_and_window_starts_exact():
    pts, mask = _cloud(8, 1900, 2048, (30.0, 20.0, 0.0), extent=12.0)
    origin = pts[mask].min(0)
    want = np.asarray(jband.morton_codes(pts, mask, origin, 2.0))
    got = banded_nn.morton_codes(_t(pts), _t(mask), _t(origin), 2.0)
    np.testing.assert_array_equal(got.numpy(), want)

    rcodes = np.sort(want)
    qpts, qmask = _cloud(9, 1000, 1024, (30.0, 20.0, 0.0), extent=12.0)
    qcodes = np.sort(np.asarray(jband.morton_codes(qpts, qmask, origin,
                                                   2.0)))
    for band in (2, 4, 16):
        w = jband.banded_window_starts(jnp.asarray(qcodes),
                                       jnp.asarray(rcodes), 2048 // 128,
                                       band, 128, 128)
        g = banded_nn.banded_window_starts(_t(qcodes).long(),
                                           _t(rcodes).long(), 2048 // 128,
                                           band, 128, 128)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
