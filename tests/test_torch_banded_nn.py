"""Parity of the port's Morton-banded matcher (the plain twin of kernel K5)
with the JAX package: `banded_prepare_payload`, and the resident and
streaming bf16 split kernels, both of which K5 replaces, run in Pallas
interpret mode — the streaming one is tested nowhere else against an
independent version."""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aicp_mapping_tpu.ops import banded_nn as jband
from aicp_mapping_tpu.tools.synthetic import room_cloud
from aicp_mapping_tpu_torch import _kernels
from aicp_mapping_tpu_torch.ops import banded_nn

torch.set_num_threads(1)
knn = importlib.import_module("aicp_mapping_tpu_torch.ops.knn")
BIG = np.float32(3.4e38)
N, M, CELL = 8192, 1024, 2.0


def _room(n, seed, shift=0.0):
    """A 20 m room centred on the origin (|coordinates| <= 10 m)."""
    pts = room_cloud(n=n * 6 // 5 + 12, size=20.0, seed=seed,
                     noise=0.01)[:n]
    return (pts + np.float32(shift)).astype(np.float32)


@pytest.fixture(scope="module")
def scene():
    """A sorted reference with 5% masked rows and normals as payload, and
    Morton-sorted queries from a second scan, both packages' layouts."""
    rng = np.random.default_rng(0)
    ref = _room(N, 1)
    rmask = rng.uniform(size=N) > 0.05
    nrm = rng.normal(size=(N, 3)).astype(np.float32)
    origin = ref[rmask].min(0)
    jprep = jband.banded_prepare_payload(
        jnp.asarray(ref), jnp.asarray(rmask), jnp.asarray(nrm),
        jnp.asarray(origin), jnp.float32(CELL))
    tprep = banded_nn.banded_prepare_payload(
        torch.as_tensor(ref), torch.as_tensor(rmask), torch.as_tensor(nrm),
        torch.as_tensor(origin), CELL)
    q = _room(M, 2, 0.05)
    qc = np.asarray(jband.morton_codes(jnp.asarray(q), jnp.ones(M, bool),
                                       jnp.asarray(origin),
                                       jnp.float32(CELL)))
    order = np.argsort(qc, kind="stable")
    return dict(jprep=jprep, tprep=tprep, qs=q[order], qcodes=qc[order])


def test_banded_prepare_payload_matches_jax(scene):
    rt, rsq, rcodes_s, pay_t = (np.asarray(a) for a in scene["jprep"])
    rs, rpen, tcodes_s, pay_s = (a.numpy() for a in scene["tprep"])
    np.testing.assert_array_equal(tcodes_s, rcodes_s)
    np.testing.assert_array_equal(rs, rt.T)
    np.testing.assert_array_equal(pay_s, pay_t.T)
    assert pay_s.shape == (N, 8) and (pay_s[:, 6:] == 0).all()
    np.testing.assert_array_equal(rpen == BIG, rsq[0] >= BIG)
    assert set(np.unique(rpen)) == {0.0, BIG}


@pytest.mark.parametrize("band", [4, 8])
@pytest.mark.parametrize("jax_fn", ["resident", "stream"])
def test_banded_twin_matches_jax_split_kernels(scene, jax_fn, band):
    """Same windows, so the same matches: payload rows identical for
    >= 99%, distances within 2e-4 m^2 plus the packed key's quantum
    (13 mantissa bits, i.e. 2^-13 d; doubled for margin)."""
    rt, rsq, rcodes_s, pay_t = scene["jprep"]
    starts = jband.banded_window_starts(jnp.asarray(scene["qcodes"]),
                                        rcodes_s, N // 1024, band, 512, 1024)
    blocks = jband.banded_blocks_split(rt, rsq, pay_t)
    fn = (jband.nn_payload_banded_resident_split if jax_fn == "resident"
          else jband.nn_payload_banded_stream_split)
    dj, pj = (np.asarray(a) for a in fn(jnp.asarray(scene["qs"]), *blocks,
                                        starts, band=band, interpret=True))
    dt, pt = banded_nn.nn_payload_banded(
        torch.as_tensor(scene["qs"]), *scene["tprep"][:2],
        scene["tprep"][3], torch.as_tensor(np.array(starts)), band)
    dt, pt = dt.numpy(), pt.numpy()
    assert (np.abs(pt - pj) <= 1e-6).all(1).mean() >= 0.99
    assert (np.abs(dt - dj) <= 2e-4 + 2.0 ** -12 * dt).all(), \
        np.abs(dt - dj).max()


def test_banded_twin_at_full_coverage_is_exact_nn(scene):
    """A band covering the whole reference finds the exact nearest
    neighbour: identical payloads and distances."""
    rs, rpen, _, pay_s = scene["tprep"]
    q = torch.as_tensor(scene["qs"])
    starts = torch.zeros(M // 512, dtype=torch.int32)
    d, p = banded_nn.nn_payload_banded(q, rs, rpen, pay_s, starts,
                                       N // 1024)
    dx, px = knn.nn_payload(q, torch.ones(M, dtype=torch.bool), rs,
                            rpen == 0, pay_s)
    torch.testing.assert_close(d, dx, rtol=0, atol=0)
    torch.testing.assert_close(p, px, rtol=0, atol=0)
    # a narrower band never reports a distance below the exact one
    starts = banded_nn.banded_window_starts(
        torch.as_tensor(scene["qcodes"]).long(), scene["tprep"][2],
        N // 1024, 2, 512, 1024)
    d2, _ = banded_nn.nn_payload_banded(q, rs, rpen, pay_s, starts, 2)
    assert bool((d2 >= dx).all()) and bool((d2 > dx).any())


def test_window_clipping_and_a_masked_query_tile(scene):
    """Queries bracketed by the last blocks get a window clipped to
    n_blocks - band, as in JAX; a tile of masked queries (all codes at the
    sentinel) gets a legal window too, and a query whose window holds no
    valid reference gets +BIG and a zero payload row."""
    rs, rpen, rcodes_s, pay_s = scene["tprep"]
    n_valid = int((rpen == 0).sum())
    band = 4
    qcodes = torch.cat([rcodes_s[n_valid - 512:n_valid],
                        torch.full((512,), banded_nn.SENTINEL)])
    got = banded_nn.banded_window_starts(qcodes, rcodes_s, N // 1024, band,
                                         512, 1024)
    want = jband.banded_window_starts(jnp.asarray(qcodes.numpy()),
                                      scene["jprep"][2], N // 1024, band,
                                      512, 1024)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.tolist() == [N // 1024 - band] * 2
    # mask the whole last window: its queries find nothing
    dead = rpen.clone()
    dead[(N // 1024 - band) * 1024:] = float(BIG)
    d, p = banded_nn.nn_payload_banded(torch.as_tensor(scene["qs"]), rs,
                                       dead, pay_s, got, band)
    assert bool((d == BIG).all()) and bool((p == 0).all())


def test_wrappers_run_the_twin_on_cpu_and_check_inputs(scene):
    rs, rpen, _, pay_s = scene["tprep"]
    q = torch.as_tensor(scene["qs"])
    starts = torch.zeros(M // 512, dtype=torch.int32)
    _kernels.reset_launch_counts()
    want = banded_nn.nn_payload_banded(q, rs, rpen, pay_s, starts, 4)
    fn = banded_nn.nn_payload_banded_stream_kernel
    got = fn(q, rs, rpen, pay_s, starts, 4)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError, match="contiguous"):
        fn(q.T.contiguous().T, rs, rpen, pay_s, starts, 4)
    with pytest.raises(ValueError, match="band"):
        fn(q, rs, rpen, pay_s, starts, N // 1024 + 1)
    with pytest.raises(ValueError, match="bad shapes"):
        fn(q, rs, rpen, pay_s[:, :6].contiguous()[:-1], starts, 4)
    with pytest.raises(TypeError):
        fn(q, rs, rpen, pay_s, starts.long(), 4)
    assert _kernels.launch_counts()["banded_nn_payload_stream"] == 0
