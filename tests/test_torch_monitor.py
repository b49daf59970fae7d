"""The port's ICP quality monitor (`registration.monitor`, every 1-NN
through K1's index mode, here its plain twin) and masked statistics against
the JAX package (CPU)."""
import numpy as np
import pytest
import torch

from aicp_mapping_tpu.ops import quantile as jq
from aicp_mapping_tpu.registration import monitor as jmon
from aicp_mapping_tpu_torch import _kernels, ops
from aicp_mapping_tpu_torch.ops import quantile as tq
from aicp_mapping_tpu_torch.registration import monitor as tmon

torch.set_num_threads(1)


def _pair(seed, M=1500, N=2000, offset=0.0):
    rng = np.random.default_rng(seed)
    a = (rng.uniform(-8, 8, (M, 3)) + offset).astype(np.float32)
    b = (a[rng.integers(0, M, N)] + rng.normal(0, 0.05, (N, 3))).astype(
        np.float32)
    return a, rng.uniform(size=M) > 0.05, b, rng.uniform(size=N) > 0.05


def T(a):
    return torch.as_tensor(np.array(a))


@pytest.mark.parametrize("quantile", [1.0, 0.9])
@pytest.mark.parametrize("offset", [0.0, 50.0])
def test_hausdorff_distance_matches_jax(quantile, offset):
    """Within 2e-3 m (JAX's expanded distance carries ~1e-3 m^2 at 60 m)."""
    a, am, b, bm = _pair(1, offset=offset)
    want = float(jmon.hausdorff_distance(a, am, b, bm, quantile))
    _kernels.reset_launch_counts()
    got = float(tmon.hausdorff_distance(T(a), T(am), T(b), T(bm), quantile))
    assert got == pytest.approx(want, abs=2e-3)
    assert got > 0.0
    assert _kernels.launch_counts()["nn_argmin"] == 0     # CPU: plain twin


def test_distances_knn_matches_jax():
    """Squared distances within 1e-4 m^2 (JAX's expanded form carries
    ~3e-5 m^2 of rounding at 8 m, which the square root blows up for the
    nearest pairs), >= 99.7% identical indices."""
    a, am, b, bm = _pair(2)
    dj, ij = (np.asarray(x) for x in jmon.distances_knn(a, am, b, bm))
    dt, it = (x.numpy() for x in tmon.distances_knn(T(a), T(am), T(b),
                                                    T(bm)))
    np.testing.assert_allclose(dt[am] ** 2, dj[am] ** 2, atol=1e-4)
    assert (it[am] == ij[am]).mean() >= 0.997
    assert (dt[~am] == dj[~am]).all()


def test_residual_stats_and_paired_mean_match_jax():
    a, am, b, bm = _pair(3)
    d2 = ((a - b[:len(a)]) ** 2).sum(1).astype(np.float32)
    want = jmon.residual_stats(d2, am, 0.75)
    got = tmon.residual_stats(T(d2), T(am), 0.75)
    for k in ("mean", "median", "quantile"):
        assert float(got[k]) == pytest.approx(float(want[k]), rel=1e-5), k
    assert float(tmon.paired_points_mean_distance(
        T(a), T(b[:len(a)]), T(am))) == pytest.approx(float(
            jmon.paired_points_mean_distance(a, b[:len(a)], am)), rel=1e-5)


def test_masked_statistics_match_jax():
    rng = np.random.default_rng(4)
    v = rng.normal(size=1001).astype(np.float32)
    m = rng.uniform(size=1001) > 0.3
    for name in ("masked_mean", "masked_median", "masked_max"):
        assert float(getattr(tq, name)(T(v), T(m))) == pytest.approx(
            float(getattr(jq, name)(v, m)), rel=1e-6), name
    assert float(tq.masked_mean(T(v), T(np.zeros(1001, bool)))) == 0.0


def test_ops_nn_argmin_is_the_kernel_entry_point():
    """`ops.nn_argmin` is K1's index-mode wrapper, as the JAX package's
    `ops.nn_argmin` dispatches to its Pallas kernel."""
    a, am, b, bm = _pair(5, M=200, N=300)
    for x, y in zip(ops.nn_argmin(T(a), T(am), T(b), T(bm)),
                    tmon.nn_argmin_kernel(T(a), T(am), T(b), T(bm))):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
    assert ops.nn_argmin.__name__ == "nn_argmin_kernel"
