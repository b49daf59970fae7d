"""The port's public nearest-neighbour API against the JAX package's (CPU):
`nn_payload_pallas` (Q2 #8), `nn_payload_banded_resident` (#9),
`nn_argmin_banded_prepared` / `nn_argmin_banded` (#10),
`nn_payload_banded_sorted` (#11), `banded_prepare`, `banded_blocks`, and
the export list of `aicp_mapping_tpu.ops`. JAX's kernels run in Pallas
interpret mode, as the JAX package's own tests run them; the port's run
their plain versions. Inputs come from numpy seeds; the prepared arrays of
JAX's `banded_prepare` are handed to the port's functions as they are.

Tolerances: the JAX tests' own, except for rounding. JAX expands the
distance, |q|^2 - 2 q.r + |r|^2, and that rounds by up to ~6 ulp of |q|^2
(1.8e-4 m^2 at 10 m coordinates here); the port's is exact. So every
distance compares at atol 2e-4 m^2, with rtol 1e-4 for JAX's unpacked
kernels and the packed key's quantum, rtol 3e-4, for its packed ones
(tests/test_ops.py:212-217 hold JAX's packed kernel to its own expanded
distance at rtol 3e-4 / atol 1e-5). Rows and indices: >= 99.7 %
identical for the unpacked kernels (CLAUDE.md:146-148), >= 99 % for the
packed ones (tests/test_banded_nn.py:167-171)."""
import ast
import importlib
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aicp_mapping_tpu.ops import banded_nn as jband
from aicp_mapping_tpu.tools.synthetic import room_cloud
from aicp_mapping_tpu_torch import _kernels
from aicp_mapping_tpu_torch import ops as tops
from aicp_mapping_tpu_torch.ops import banded_nn

torch.set_num_threads(1)
jknn = importlib.import_module("aicp_mapping_tpu.ops.knn")
knn = importlib.import_module("aicp_mapping_tpu_torch.ops.knn")
ROOT = os.path.join(os.path.dirname(__file__), "..")
BIG = np.float32(3.4e38)
ATOL = 2e-4             # m^2: the rounding of JAX's expanded distance


def T(a):
    return torch.as_tensor(np.array(a))


def _rows_agree(got, want, share):
    same = (got == want).all(1).mean()
    assert same >= share, same


@pytest.fixture(scope="module")
def uniform():
    """tests/test_ops.py::test_nn_payload_matches_argmin's inputs: 512
    queries and 1,024 references in a +-10 m cube, 10 % of each masked,
    payload = point + 5 normal columns."""
    rng = np.random.default_rng(3)
    M, N = 512, 1024
    q = rng.uniform(-10, 10, (M, 3)).astype(np.float32)
    r = rng.uniform(-10, 10, (N, 3)).astype(np.float32)
    qm = rng.uniform(size=M) > 0.1
    rm = rng.uniform(size=N) > 0.1
    pay = np.concatenate([r, rng.normal(size=(N, 5)).astype(np.float32)], 1)
    return q, qm, r, rm, pay


@pytest.mark.parametrize("packed", [False, True])
def test_nn_payload_tiled_matches_jax(uniform, packed):
    """#8: `nn_payload_tiled_kernel` against `nn_payload_pallas`."""
    q, qm, r, rm, pay = uniform
    dj, pj = (np.asarray(a) for a in jknn.nn_payload_pallas(
        q, qm, r, rm, pay, packed=packed, interpret=True))
    dt, pt = (a.numpy() for a in knn.nn_payload_tiled_kernel(
        T(q), T(qm), T(r), T(rm), T(pay), packed=packed))
    if packed:
        np.testing.assert_allclose(dt, dj, rtol=3e-4, atol=ATOL)
        _rows_agree(pt, pj, 0.99)
    else:
        np.testing.assert_allclose(dt, dj, rtol=1e-4, atol=ATOL)
        _rows_agree(pt, pj, 0.997)
    assert (dt[~qm] == BIG).all() and (pt[~qm] == 0).all()


def test_nn_payload_tiled_on_an_all_masked_reference(uniform):
    """No valid reference: +BIG and a zero row, as the unpacked TPU kernel
    returns; the packed one lets masked column 0 win (ROADMAP Q3)."""
    q, qm, r, _, pay = uniform
    rm = np.zeros(len(r), bool)
    want = [np.asarray(a) for a in jknn.nn_payload_pallas(
        q, qm, r, rm, pay, packed=False, interpret=True)]
    got = [a.numpy() for a in knn.nn_payload_tiled_kernel(
        T(q), T(qm), T(r), T(rm), T(pay))]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert (got[0] == BIG).all() and (got[1] == 0).all()
    packed_d, packed_p = jknn.nn_payload_pallas(q, qm, r, rm, pay,
                                                interpret=True)
    assert (np.asarray(packed_d)[qm] < BIG).all()
    np.testing.assert_array_equal(np.asarray(packed_p)[qm][0], pay[0])


@pytest.mark.parametrize("M,N,P,tm,tn", [(500, 1024, 8, 512, 1024),
                                         (512, 1000, 8, 512, 1024),
                                         (512, 1024, 6, 512, 1024),
                                         (256, 1024, 8, 512, 1024)])
def test_nn_payload_tiled_keeps_the_tile_rules(M, N, P, tm, tn):
    """M % tm, N % tn and P % 8 must be 0, or it raises (JAX asserts)."""
    args = (torch.zeros(M, 3), torch.ones(M, dtype=torch.bool),
            torch.zeros(N, 3), torch.ones(N, dtype=torch.bool),
            torch.zeros(N, P))
    with pytest.raises(ValueError, match="multiples"):
        knn.nn_payload_tiled_kernel(*args, tm=tm, tn=tn)


@pytest.fixture(scope="module")
def small_banded():
    """tests/test_banded_nn.py's payload scene: 512 queries, 1,024
    references in [0, 20 m]^3 (10 % masked), tiles of 128, JAX's prepared
    reference, sorted payload and window starts at full coverage."""
    rng = np.random.default_rng(2)
    M, N, tn = 512, 1024, 128
    q = rng.uniform(0, 20, (M, 3)).astype(np.float32)
    r = rng.uniform(0, 20, (N, 3)).astype(np.float32)
    rm = rng.uniform(size=N) > 0.1
    pay = np.concatenate([r, rng.normal(size=(N, 5)).astype(np.float32)], 1)
    origin, cell = jnp.zeros(3), jnp.float32(4.0)
    rt, rsq, rcodes_s, rperm = jband.banded_prepare(r, rm, origin, cell)
    qcodes = jband.morton_codes(q, jnp.ones(M, bool), origin, cell)
    qperm = jnp.argsort(qcodes)
    band = N // tn
    starts = jband.banded_window_starts(qcodes[qperm], rcodes_s, N // tn,
                                        band, 128, tn)
    return dict(q=q, r=r, rm=rm, pay=pay, prep=(rt, rsq, rcodes_s, rperm),
                qs=np.asarray(q[np.asarray(qperm)]),
                pay_t=np.asarray(pay[np.asarray(rperm)].T),
                starts=np.asarray(starts), band=band, tn=tn)


def test_banded_prepare_and_blocks_match_jax(small_banded):
    s = small_banded
    got = banded_nn.banded_prepare(T(s["r"]), T(s["rm"]), torch.zeros(3),
                                   4.0)
    rt, rsq, rcodes_s, rperm = (np.asarray(a) for a in s["prep"])
    np.testing.assert_array_equal(got[0].numpy(), rt)
    np.testing.assert_allclose(got[1].numpy(), rsq, rtol=1e-6)
    np.testing.assert_array_equal(got[1].numpy() >= BIG, rsq >= BIG)
    np.testing.assert_array_equal(got[2].numpy(), rcodes_s)
    np.testing.assert_array_equal(got[3].numpy(), rperm)
    want = jband.banded_blocks(*s["prep"][:2], s["pay_t"], tn=s["tn"])
    blocks = banded_nn.banded_blocks(T(rt), T(rsq), T(s["pay_t"]),
                                     tn=s["tn"])
    for g, w in zip(blocks, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("fn", ["sorted", "resident"])
def test_banded_payload_at_full_coverage_matches_jax(small_banded, fn):
    """#11 (`nn_payload_banded_sorted`) and #9 (`_resident`) on JAX's own
    prepared arrays, band = every block: JAX's packed-key result within
    its quantum, and the port's the exact NN's."""
    s = small_banded
    rt, rsq = s["prep"][:2]
    kw = dict(band=s["band"], tm=128, tn=s["tn"])
    if fn == "sorted":
        ref_args = (rt, rsq, s["pay_t"])
        jfn, tfn = jband.nn_payload_banded_sorted, \
            banded_nn.nn_payload_banded_sorted
    else:
        ref_args = jband.banded_blocks(rt, rsq, s["pay_t"], tn=s["tn"])
        jfn, tfn = jband.nn_payload_banded_resident, \
            banded_nn.nn_payload_banded_resident
    dj, pj = (np.asarray(a) for a in jfn(
        jnp.asarray(s["qs"]), *ref_args, s["starts"], interpret=True, **kw))
    dt, pt = (a.numpy() for a in tfn(
        T(s["qs"]), *(T(a) for a in ref_args), T(s["starts"]), **kw))
    np.testing.assert_allclose(dt, dj, rtol=3e-4, atol=ATOL)
    _rows_agree(pt, pj, 0.99)
    qs = T(s["qs"])
    dx, px = knn.nn_payload(qs, torch.ones(len(qs), dtype=torch.bool),
                            T(s["r"]), T(s["rm"]), T(s["pay"]))
    np.testing.assert_array_equal(dt, dx.numpy())
    np.testing.assert_array_equal(pt, px.numpy())


@pytest.fixture(scope="module")
def room_banded():
    """tests/test_banded_nn.py's map scene in a 20 m room centred on the
    origin (so that JAX's expanded distance rounds as at 10 m): 16,384
    references, 4,096 queries drawn from them 1 cm off (5 cm there: then
    JAX's rounding of near-ties picks another index for 0.4 % of them),
    the ICP's 4 m cell."""
    world = room_cloud(n=16500, size=20.0, seed=0, noise=0.02)[:16384] - 10.0
    rng = np.random.default_rng(1)
    q = world[rng.choice(len(world), 4096, replace=False)] + \
        rng.normal(0, 0.01, (4096, 3)).astype(np.float32)
    return q.astype(np.float32), world.astype(np.float32)


@pytest.mark.parametrize("fn", ["sorted", "resident"])
def test_banded_payload_at_a_partial_band_matches_jax(room_banded, fn):
    """#11 and #9 at band 4 of 16 blocks: >= 99 % identical rows."""
    q, world = room_banded
    N, band, cell = len(world), 4, jnp.float32(4.0)
    rm = np.ones(N, bool)
    origin = jnp.asarray(np.minimum(q.min(0), world.min(0)))
    rt, rsq, rcodes_s, rperm = jband.banded_prepare(world, rm, origin, cell)
    qcodes = jband.morton_codes(q, jnp.ones(len(q), bool), origin, cell)
    qperm = np.asarray(jnp.argsort(qcodes))
    starts = jband.banded_window_starts(qcodes[qperm], rcodes_s, N // 1024,
                                        band, 512, 1024)
    pay_t = np.concatenate([np.asarray(rt), np.asarray(rperm)[None, :]
                            .astype(np.float32),
                            np.zeros((4, N), np.float32)])
    ref_args = (rt, rsq, pay_t) if fn == "sorted" else \
        jband.banded_blocks(rt, rsq, pay_t)
    jfn = getattr(jband, f"nn_payload_banded_{fn}")
    tfn = getattr(banded_nn, f"nn_payload_banded_{fn}")
    pj = np.asarray(jfn(jnp.asarray(q[qperm]), *ref_args, starts, band=band,
                        interpret=True)[1])
    dt, pt = tfn(T(q[qperm]), *(T(a) for a in ref_args), T(starts),
                 band=band)
    _rows_agree(pt.numpy(), pj, 0.99)
    assert bool(torch.isfinite(dt).all()) and float(dt.max()) < 1.0


def test_nn_argmin_banded_matches_jax(room_banded):
    """#10 one-shot at band 4: >= 99.7 % of JAX's indices, the distances
    where they agree, and upper bounds of the exact NN's. Where the
    indices differ, the port's pick is the nearer in float64 by less than
    JAX's rounding."""
    q, world = room_banded
    qm, rm = np.ones(len(q), bool), np.ones(len(world), bool)
    dj, ij = (np.asarray(a) for a in jband.nn_argmin_banded(
        q, qm, world, rm, band=4, cell_size=4.0, interpret=True))
    dt, it = banded_nn.nn_argmin_banded(T(q), T(qm), T(world), T(rm),
                                        band=4, cell_size=4.0)
    dt, it = dt.numpy(), it.numpy()
    agree = it == ij
    assert agree.mean() >= 0.997, agree.mean()
    np.testing.assert_allclose(dt[agree], dj[agree], rtol=1e-4, atol=ATOL)
    q64, w64 = q.astype(np.float64), world.astype(np.float64)
    gap = (((q64 - w64[it]) ** 2).sum(1) - ((q64 - w64[ij]) ** 2).sum(1))
    assert (gap[~agree] <= 0).all() and (gap[~agree] > -ATOL).all()
    dx, ix = knn.nn_argmin(T(q), T(qm), T(world), T(rm))
    assert (dt >= dx.numpy()).all() and (it == ix.numpy()).mean() > 0.98


def test_nn_argmin_banded_at_full_coverage_is_exact_nn():
    """#10 with band = every block equals the port's exact 1-NN."""
    world = room_cloud(n=4200, size=20.0, seed=3, noise=0.01)[:4096]
    q = world[:2048] + np.float32(0.03)
    qm, rm = torch.ones(2048, dtype=torch.bool), torch.ones(4096,
                                                            dtype=torch.bool)
    d, i = banded_nn.nn_argmin_banded(T(q), qm, T(world), rm, band=4)
    dx, ix = knn.nn_argmin(T(q), qm, T(world), rm)
    torch.testing.assert_close(d, dx, rtol=0, atol=0)
    torch.testing.assert_close(i, ix, rtol=0, atol=0)


def test_nn_argmin_banded_prepared_edge_windows():
    """A last tile of 188 valid queries with the highest codes and 324
    masked ones: JAX brackets it from its first and last code, sentinel
    included, so its band-1 window is the reference's last block, which
    holds only masked rows. Its valid queries find nothing and get (BIG,
    rperm[0]); masked queries get (BIG, 0); the first tile matches."""
    rng = np.random.default_rng(4)
    N, M, origin, cell = 4096, 1024, np.zeros(3, np.float32), 4.0
    r = rng.uniform(0, 20, (N, 3)).astype(np.float32)
    codes = np.asarray(jband.morton_codes(r, np.ones(N, bool), origin,
                                          jnp.float32(cell)))
    rm = np.zeros(N, bool)
    rm[np.argsort(codes, kind="stable")[:2048]] = True
    q = rng.uniform(0, 20, (M, 3)).astype(np.float32)
    qm = np.arange(M) < 700
    prep = jband.banded_prepare(r, rm, origin, jnp.float32(cell))
    dj, ij = (np.asarray(a) for a in jband.nn_argmin_banded_prepared(
        q, qm, *prep, origin, jnp.float32(cell), band=1, interpret=True))
    dt, it = banded_nn.nn_argmin_banded_prepared(
        T(q), T(qm), *(T(a) for a in prep), T(origin), cell, band=1)
    dt, it = dt.numpy(), it.numpy()
    rperm0 = int(np.asarray(prep[3])[0])
    lost = qm & (dj == BIG)
    assert lost.sum() > 100 and rperm0 != 0
    np.testing.assert_array_equal(dt[lost], BIG)
    np.testing.assert_array_equal(it[lost], rperm0)
    np.testing.assert_array_equal(ij[lost], rperm0)
    np.testing.assert_array_equal(dt[~qm], BIG)
    np.testing.assert_array_equal(it[~qm], 0)
    found = qm & ~lost
    assert (it[found] == ij[found]).mean() >= 0.997
    np.testing.assert_allclose(dt[found], dj[found], rtol=1e-4, atol=ATOL)


def test_banded_index_wrapper_runs_the_twin_on_cpu_and_checks_inputs():
    """K5's index-mode wrapper on CPU tensors: the plain version, no
    launch; -1 for a window without a valid reference; bad inputs raise."""
    rng = np.random.default_rng(6)
    q = T(rng.uniform(0, 5, (1024, 3)).astype(np.float32))
    rs = T(rng.uniform(0, 5, (4096, 3)).astype(np.float32))
    rpen = torch.zeros(4096)
    rpen[3072:] = float(BIG)
    starts = torch.tensor([0, 3], dtype=torch.int32)
    _kernels.reset_launch_counts()
    d, i = banded_nn.banded_nn_argmin_kernel(q, rs, rpen, starts, 1)
    assert _kernels.launch_counts()["banded_nn_argmin"] == 0
    assert i.dtype == torch.int64
    assert bool((i[512:] == -1).all()) and bool((d[512:] == BIG).all())
    assert bool((i[:512] >= 0).all()) and bool((i[:512] < 1024).all())
    dx, ix = knn.nn_argmin(q[:512], torch.ones(512, dtype=torch.bool),
                           rs[:1024], torch.ones(1024, dtype=torch.bool))
    torch.testing.assert_close(d[:512], dx, rtol=0, atol=0)
    torch.testing.assert_close(i[:512], ix, rtol=0, atol=0)
    fn = banded_nn.banded_nn_argmin_kernel
    with pytest.raises(ValueError, match="band"):
        fn(q, rs, rpen, starts, 5)
    with pytest.raises(ValueError, match="contiguous"):
        fn(q.T.contiguous().T, rs, rpen, starts, 1)
    with pytest.raises(TypeError):
        fn(q, rs, rpen, starts.long(), 1)
    with pytest.raises(ValueError, match="multiples"):
        banded_nn.nn_argmin_banded_prepared(
            q[:1000], torch.ones(1000, dtype=torch.bool), rs.T, rpen[None],
            torch.zeros(4096, dtype=torch.int64), torch.arange(4096),
            torch.zeros(3), 4.0)


def _jax_ops_exports():
    path = os.path.join(ROOT, "aicp_mapping_tpu", "ops", "__init__.py")
    tree = ast.parse(open(path).read())
    return [a.asname or a.name for node in tree.body
            if isinstance(node, ast.ImportFrom) for a in node.names]


# JAX's name -> the port's (ops/knn.py's module docstring)
EXPORTS = {"nn_argmin_pallas": "nn_argmin_kernel",
           "nn_argmin_xla": "nn_argmin"}


def test_ops_export_list_mirrors_jax():
    names = _jax_ops_exports()
    assert len(names) == 14 and "knn" in names
    for name in names:
        assert callable(getattr(tops, EXPORTS.get(name, name))), name
    assert tops.nn_argmin is knn.nn_argmin_kernel


def test_exported_nn_argmin_names_match_jax(uniform):
    """The exported 1-NN names on CPU tensors against JAX's tiled kernel
    (interpret mode), XLA fallback and dispatcher."""
    q, qm, r, rm, _ = uniform
    jops = importlib.import_module("aicp_mapping_tpu.ops")
    for name in ("nn_argmin", "nn_argmin_pallas", "nn_argmin_xla"):
        kw = {"interpret": True} if name == "nn_argmin_pallas" else {}
        dj, ij = (np.asarray(a) for a in getattr(jops, name)(
            q, qm, r, rm, **kw))
        dt, it = (a.numpy() for a in getattr(tops, EXPORTS.get(name, name))(
            T(q), T(qm), T(r), T(rm)))
        agree = it == ij
        assert agree.mean() >= 0.997, (name, agree.mean())
        np.testing.assert_allclose(dt[agree], dj[agree], rtol=1e-4,
                                   atol=ATOL)
