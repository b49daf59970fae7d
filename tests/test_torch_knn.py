"""Parity of the port's nearest-neighbour search (plain twin of kernel K1)
with the JAX package's XLA path and its Pallas split kernel (interpret
mode), and the K1 wrapper's device rules."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aicp_mapping_tpu.ops.knn import nn_payload_pallas_split, nn_payload_xla
from aicp_mapping_tpu_torch import _kernels
from aicp_mapping_tpu_torch.ops import knn

torch.set_num_threads(1)


def _inputs(seed=3, M=512, N=1024, offset=0.0):
    rng = np.random.default_rng(seed)
    q = (rng.uniform(-10, 10, (M, 3)) + offset).astype(np.float32)
    r = (rng.uniform(-10, 10, (N, 3)) + offset).astype(np.float32)
    qm = rng.uniform(size=M) > 0.1
    rm = rng.uniform(size=N) > 0.1
    payload = np.concatenate(
        [r, rng.normal(size=(N, 5)).astype(np.float32)], axis=1)
    return q, qm, r, rm, payload


def _port(q, qm, r, rm, payload, fn=knn.nn_payload):
    d, p = fn(*(torch.as_tensor(a) for a in (q, qm, r, rm, payload)))
    return d.numpy(), p.numpy()


def _exact(q, qm, r, rm, payload):
    d2 = ((q[:, None, :].astype(np.float64) - r[None, :, :]) ** 2).sum(-1)
    d2[:, ~rm] = np.inf
    idx = np.argmin(d2, axis=1)
    return idx, np.where(qm[:, None], payload[idx], 0.0)


@pytest.mark.parametrize("jax_fn", ["xla", "pallas_split"])
def test_nn_payload_matches_jax(jax_fn):
    """Tolerances of tests/test_ops.py::test_nn_payload_matches_argmin for
    the split kernel: distances within rtol 3e-4 / atol 2e-3, > 99% of
    payload rows identical."""
    args = _inputs()
    if jax_fn == "xla":
        d_j, p_j = nn_payload_xla(*map(jnp.asarray, args))
    else:
        d_j, p_j = nn_payload_pallas_split(*map(jnp.asarray, args),
                                           interpret=True)
    d_t, p_t = _port(*args)
    qm = args[1]
    np.testing.assert_allclose(d_t[qm], np.asarray(d_j)[qm], rtol=3e-4,
                               atol=2e-3)
    assert (d_t[~qm] == np.float32(3.4e38)).all()
    same = np.all(p_t == np.asarray(p_j), axis=1)
    assert same.mean() > 0.99, same.mean()


def test_nn_payload_is_exact_at_lidar_range():
    """Difference-form distances: at a 60 m offset the plain twin still
    picks the exact (float64) nearest neighbour of every query."""
    q, qm, r, rm, payload = _inputs(seed=4, offset=55.0)
    d_t, p_t = _port(q, qm, r, rm, payload)
    idx, p_exact = _exact(q, qm, r, rm, payload)
    np.testing.assert_array_equal(p_t, p_exact.astype(np.float32))
    d64 = ((q - r[idx]).astype(np.float64) ** 2).sum(-1)
    np.testing.assert_allclose(d_t[qm], d64[qm], rtol=1e-5, atol=1e-9)


def test_nn_payload_all_refs_masked_matches_xla():
    q, qm, r, rm, payload = _inputs(seed=5, M=64, N=128)
    rm[:] = False
    d_j, p_j = nn_payload_xla(*map(jnp.asarray, (q, qm, r, rm, payload)))
    d_t, p_t = _port(q, qm, r, rm, payload)
    np.testing.assert_array_equal(d_t, np.asarray(d_j))
    np.testing.assert_array_equal(p_t, np.asarray(p_j))


def test_kernel_wrapper_uses_plain_twin_on_cpu():
    _kernels.reset_launch_counts()
    args = _inputs(seed=6, M=300, N=700)
    d_w, p_w = _port(*args, fn=knn.nn_payload_kernel)
    d_p, p_p = _port(*args)
    np.testing.assert_array_equal(d_w, d_p)
    np.testing.assert_array_equal(p_w, p_p)
    assert _kernels.launch_counts()["nn_payload"] == 0
