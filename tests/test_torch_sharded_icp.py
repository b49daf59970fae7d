"""The port's distributed ICP (`parallel.sharded_icp`) and the quantiles
with a mesh axis, on gloo CPU ranks, against the JAX package's shard_map
versions on meshes of the same size (2 and 4 of the 8 virtual CPU devices)
and against the port's own single-device solve.

One launch of 4 ranks serves every case: a 1-D mesh of 4 ("points") and
the "points" axis of a 2 x 2 mesh (two groups of 2 ranks, each a mesh of
2). Inputs and results cross as .npz files; the ranks import nothing of
JAX (its modules are imported inside the JAX-side helpers only)."""
import os

import numpy as np
import pytest
import torch

from aicp_mapping_tpu_torch.parallel import launch

torch.set_num_threads(1)
DEADLINE_S = 300.0
SIZES = (2, 4)
ROT, TRANS = [0.01, -0.02, 0.05], [0.1, -0.08, 0.05]
MAP_ROT, MAP_TRANS = [0.01, -0.015, 0.04], [0.09, -0.07, 0.04]
BAND_ROT, BAND_TRANS = [0.0, 0.0, 0.03], [0.06, 0.0, 0.0]
COARSE = dict(coarse_iterations=3)
FIXED = dict(max_iterations=4, min_diff_trans=0.0, min_diff_rot=0.0)
BANDED = dict(nn_mode="banded", nn_cell_size=2.0)


# ---------------------------------------------------------------- ranks

def _meshes():
    from aicp_mapping_tpu_torch.parallel import make_mesh, make_mesh_2d

    return {4: make_mesh(4, "points", device="cpu"),
            2: make_mesh_2d((2, 2), ("graph", "points"), device="cpu")}


def _icp_rank(inputs: str, out_dir: str) -> None:
    """Every case on both meshes; rank r writes rank{r}.npz."""
    from aicp_mapping_tpu_torch.eval.multichip import collective_stats
    from aicp_mapping_tpu_torch.ops.quantile import masked_quantile_hist
    from aicp_mapping_tpu_torch.parallel import (
        histogram_quantile, map_sharded_point_to_plane_icp,
        sharded_point_to_plane_icp)
    from aicp_mapping_tpu_torch.registration.icp import (ICPConfig,
                                                         point_to_plane_icp)

    torch.set_num_threads(1)
    x = {k: torch.as_tensor(v) for k, v in np.load(inputs).items()}
    meshes = _meshes()
    eye, ratio = torch.eye(4), torch.tensor(0.7)
    out = {}

    def keep(tag, res):
        out[f"{tag}_T"] = res.T.numpy()
        out[f"{tag}_d"] = res.match_dist2.numpy()
        out[f"{tag}_m"] = res.inlier_mask.numpy()
        out[f"{tag}_it"] = np.int64(res.n_iterations)
        out[f"{tag}_rms"] = res.inlier_rms.numpy()

    read = (x["reading"], x["ref_mask"], x["ref"], x["ref_n"], x["ref_mask"])
    mapped = (x["map_reading"], x["map_reading_mask"], x["map"], x["map_n"],
              x["map_mask"])
    banded = (x["band_reading"], x["band_reading_mask"], x["band"],
              x["band_n"], x["band_mask"])
    for D, mesh in meshes.items():
        keep(f"read{D}", sharded_point_to_plane_icp(
            mesh, *read, eye, ratio, ICPConfig()))
        keep(f"map{D}", map_sharded_point_to_plane_icp(
            mesh, *mapped, eye, ratio, ICPConfig()))
        keep(f"band{D}", map_sharded_point_to_plane_icp(
            mesh, *banded, eye, ratio, ICPConfig(**BANDED)))
        rows = mesh.shard(x["values"].shape[0], "points")
        out[f"quantile{D}"] = masked_quantile_hist(
            x["values"][rows], x["values_mask"][rows], 0.7,
            axis_name="points", mesh=mesh).numpy()
        out[f"hist{D}"] = histogram_quantile(
            x["uniform"][rows], torch.ones(rows.stop - rows.start), 0.7,
            0.0, 10.0, axis_name="points", mesh=mesh).numpy()
        # collectives per iteration at two reading sizes
        for n in (2048, 4096):
            mesh.reset_counts()
            res = sharded_point_to_plane_icp(
                mesh, read[0][:n].contiguous(), read[1][:n].contiguous(),
                *read[2:], eye, ratio, ICPConfig(**FIXED))
            stats = collective_stats(mesh.counts(), res.n_iterations)
            out[f"bytes{D}_{n}"] = np.float64(stats["bytes_per_iteration"])
            out[f"psums{D}_{n}"] = np.int64(stats["ops"]["psum"])
    keep("read2coarse", sharded_point_to_plane_icp(
        meshes[2], *read, eye, ratio, ICPConfig(**COARSE)))
    if meshes[4].rank == 0:
        keep("read1", point_to_plane_icp(*read, eye, ratio, ICPConfig()))
        keep("map1", point_to_plane_icp(*mapped, eye, ratio, ICPConfig()))
    np.savez(os.path.join(out_dir, f"rank{meshes[4].rank}.npz"), **out)


# ---------------------------------------------------------------- inputs

def _transform(rot, trans):
    from aicp_mapping_tpu.geometry import se3 as jse3
    import jax.numpy as jnp

    return np.asarray(jse3.make_transform(jse3.so3_exp(jnp.array(rot)),
                                          jnp.array(trans)))


def _apply(T, pts):
    return (pts @ T[:3, :3].T + T[:3, 3]).astype(np.float32)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The scenes of tests/test_parallel.py's sharded-ICP cases, with
    normals by the JAX package's kNN normals."""
    import jax.numpy as jnp

    from aicp_mapping_tpu.cloud import Cloud
    from aicp_mapping_tpu.ops import estimate_normals
    from aicp_mapping_tpu.tools.synthetic import room_cloud

    def scene(n, **kw):
        c = Cloud.from_numpy(room_cloud(n=n, noise=0.005, **kw), capacity=n)
        normals, _, _ = estimate_normals(c.points, c.mask, k=12)
        return (np.asarray(c.points), np.asarray(c.mask),
                np.asarray(normals))

    x = {}
    x["ref"], x["ref_mask"], x["ref_n"] = scene(4096, seed=5)
    x["reading"] = _apply(_transform(ROT, TRANS), x["ref"])
    x["map"], x["map_mask"], x["map_n"] = scene(8192, seed=9)
    x["map_reading"] = _apply(_transform(MAP_ROT, MAP_TRANS),
                              x["map"][::4][:2048])
    x["map_reading_mask"] = np.ones(2048, bool)
    x["band"], x["band_mask"], x["band_n"] = scene(32768, seed=11,
                                                   size=12.0)
    x["band_reading"] = _apply(_transform(BAND_ROT, BAND_TRANS),
                               x["band"][::16][:2048])
    x["band_reading_mask"] = np.ones(2048, bool)
    rng = np.random.default_rng(0)
    x["values"] = rng.exponential(0.05, 4096).astype(np.float32)
    x["values_mask"] = rng.random(4096) < 0.8
    x["uniform"] = rng.uniform(0, 10, 4096).astype(np.float32)
    root = tmp_path_factory.mktemp("sharded_icp")
    np.savez(root / "inputs.npz", **x)
    return root, x


@pytest.fixture(scope="module")
def port(inputs):
    root, _ = inputs
    launch(_icp_rank, 4, str(root / "inputs.npz"), str(root),
           device="cpu", timeout_s=DEADLINE_S)
    return [dict(np.load(root / f"rank{r}.npz")) for r in range(4)]


@pytest.fixture(scope="module")
def jax_sharded(inputs):
    """JAX's sharded solves on meshes of 2 and 4."""
    import jax.numpy as jnp
    from aicp_mapping_tpu.geometry import se3 as jse3
    from aicp_mapping_tpu.parallel import (make_mesh,
                                           map_sharded_point_to_plane_icp,
                                           sharded_point_to_plane_icp)
    from aicp_mapping_tpu.registration.icp import ICPConfig

    _, x = inputs
    j = {k: jnp.asarray(v) for k, v in x.items()}
    out = {}
    for D in SIZES:
        mesh = make_mesh(D, axis="points")
        out[f"read{D}"] = sharded_point_to_plane_icp(
            mesh, j["reading"], j["ref_mask"], j["ref"], j["ref_n"],
            j["ref_mask"], jse3.identity(), 0.7)
        out[f"map{D}"] = map_sharded_point_to_plane_icp(
            mesh, j["map_reading"], j["map_reading_mask"], j["map"],
            j["map_n"], j["map_mask"], jse3.identity(), 0.7)
        out[f"band{D}"] = map_sharded_point_to_plane_icp(
            mesh, j["band_reading"], j["band_reading_mask"], j["band"],
            j["band_n"], j["band_mask"], jse3.identity(), 0.7,
            ICPConfig(**BANDED))
    out["read2coarse"] = sharded_point_to_plane_icp(
        make_mesh(2, axis="points"), j["reading"], j["ref_mask"], j["ref"],
        j["ref_n"], j["ref_mask"], jse3.identity(), 0.7, ICPConfig(**COARSE))
    return out


# ---------------------------------------------------------------- tests

def _recovers(T, rot, trans, t_tol=0.02, r_tol_deg=0.3):
    err = T @ _transform(rot, trans)
    angle = np.degrees(np.arccos(np.clip((np.trace(err[:3, :3]) - 1) / 2,
                                         -1, 1)))
    assert np.linalg.norm(err[:3, 3]) < t_tol, err
    assert angle < r_tol_deg, angle


@pytest.mark.parametrize("D", SIZES)
def test_reading_sharded_matches_jax_and_single_device(port, jax_sharded, D):
    """Reading-sharded ICP (tests/test_parallel.py:114-145): T within 1e-4
    of JAX's sharded solve on a mesh of D and of the port's single-device
    solve, the same on every rank; per-point outputs full length, in the
    caller's order."""
    want = jax_sharded[f"read{D}"]
    for r in port:
        np.testing.assert_allclose(r[f"read{D}_T"], np.asarray(want.T),
                                   atol=1e-4)
        np.testing.assert_array_equal(r[f"read{D}_T"], port[0][f"read{D}_T"])
    p = port[0]
    np.testing.assert_allclose(p[f"read{D}_T"], p["read1_T"], atol=1e-4)
    _recovers(p[f"read{D}_T"], ROT, TRANS)
    assert p[f"read{D}_d"].shape == p["read1_d"].shape == (4096,)
    assert p[f"read{D}_m"].shape == (4096,)
    assert abs(int(p[f"read{D}_it"]) - int(want.n_iterations)) <= 1
    # per-point outputs in the caller's order: the single solve's rows
    assert np.mean(np.abs(p[f"read{D}_d"] - p["read1_d"]) < 1e-6) > 0.99
    # the reading is the reference moved: residuals are ~1e-7 m
    np.testing.assert_allclose(p[f"read{D}_rms"], np.asarray(
        want.inlier_rms), atol=1e-5)


def test_reading_sharded_coarse_to_fine_matches_jax(port, jax_sharded):
    """Coarse-to-fine under the reading layout: each rank decimates its
    own slice, the psum-reduced solve sees the globally decimated
    problem (JAX icp.py:244); 2,048 rows per rank keep the coarse phase."""
    want = jax_sharded["read2coarse"]
    np.testing.assert_allclose(port[0]["read2coarse_T"], np.asarray(want.T),
                               atol=1e-4)
    assert abs(int(port[0]["read2coarse_it"]) - int(want.n_iterations)) <= 1


@pytest.mark.parametrize("D", SIZES)
def test_map_sharded_matches_jax_and_single_device_bit_for_bit(
        port, jax_sharded, D):
    """Map-sharded ICP with exhaustive blocks (tests/test_parallel.py:
    194-227): match_dist2 within 1e-5 of JAX's, T within 1e-4; against
    the port's single-device solve, match_dist2 and T bit for bit (the
    global nearest neighbour is the least of the blocks', ties to the
    lowest block, the payload selected exactly)."""
    want = jax_sharded[f"map{D}"]
    for r in port:
        np.testing.assert_allclose(r[f"map{D}_d"],
                                   np.asarray(want.match_dist2), atol=1e-5)
        np.testing.assert_allclose(r[f"map{D}_T"], np.asarray(want.T),
                                   atol=1e-4)
    p = port[0]
    np.testing.assert_array_equal(p[f"map{D}_d"], p["map1_d"])
    np.testing.assert_array_equal(p[f"map{D}_T"], p["map1_T"])
    np.testing.assert_array_equal(p[f"map{D}_m"], p["map1_m"])
    assert int(p[f"map{D}_it"]) == int(p["map1_it"])
    _recovers(p[f"map{D}_T"], MAP_ROT, MAP_TRANS)


@pytest.mark.parametrize("D", SIZES)
def test_map_sharded_banded_blocks(port, jax_sharded, D):
    """The banded matcher on each map block (tests/test_parallel.py:
    229-254): the reading's Morton sort uses the blocks' pmin origin so
    rows align across blocks; the perturbation is recovered to JAX's own
    tolerances, with the same T on every rank, T within 1e-4 of JAX's
    banded map-sharded solve on a mesh of D and match_dist2 within 1e-4 in
    the caller's rows. JAX's banded kernels form d2 as |q|^2 + |r|^2 -
    2 q.r in float32 (an error of a few ulps of |q|^2 <= 108 m^2 in this
    12 m room, up to 6.1e-5 here), the port's as |q - r|^2; at residuals
    of ~1e-7 m that noise reorders the trim, so the inlier masks differ."""
    want = jax_sharded[f"band{D}"]
    for r in port:
        _recovers(r[f"band{D}_T"], BAND_ROT, BAND_TRANS)
        np.testing.assert_array_equal(r[f"band{D}_T"], port[0][f"band{D}_T"])
        np.testing.assert_allclose(r[f"band{D}_T"], np.asarray(want.T),
                                   atol=1e-4)
        np.testing.assert_allclose(r[f"band{D}_d"],
                                   np.asarray(want.match_dist2), atol=1e-4)
    assert abs(int(port[0][f"band{D}_it"]) - int(want.n_iterations)) <= 1


@pytest.mark.parametrize("D", SIZES)
def test_quantiles_with_an_axis_match_jax(inputs, port, D):
    """`masked_quantile_hist` and `histogram_quantile` with `axis_name`:
    every rank returns JAX's global quantile over the same shards."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from aicp_mapping_tpu.ops.quantile import masked_quantile_hist
    from aicp_mapping_tpu.parallel import histogram_quantile, make_mesh

    _, x = inputs
    mesh = make_mesh(D, axis="points")
    want_q = jax.shard_map(
        lambda v, m: masked_quantile_hist(v, m, 0.7, axis_name="points"),
        mesh=mesh, in_specs=(P("points"), P("points")), out_specs=P())(
        jnp.asarray(x["values"]), jnp.asarray(x["values_mask"]))
    want_h = jax.shard_map(
        lambda v, w: histogram_quantile(v, w, 0.7, 0.0, 10.0,
                                        axis_name="points"),
        mesh=mesh, in_specs=(P("points"), P("points")), out_specs=P())(
        jnp.asarray(x["uniform"]), jnp.ones(4096, jnp.float32))
    for r in port:
        np.testing.assert_allclose(r[f"quantile{D}"], np.asarray(want_q),
                                   rtol=1e-6)
        np.testing.assert_allclose(r[f"hist{D}"], np.asarray(want_h),
                                   rtol=1e-6)
    assert abs(float(port[0][f"hist{D}"]) - 7.0) < 0.1


@pytest.mark.parametrize("D", SIZES)
def test_collective_bytes_per_iteration_are_the_design_count(port, D):
    """From the mesh's counters: a reading-sharded ICP iteration moves the
    design count of JAX's sharded_icp.py:17-19 — two 128-bin histograms,
    the 6x6 system and the 6-vector — plus the valid count, the range and
    the two inlier sums: 1,208 bytes in 4 psums and 1 pmax, whatever the
    number of points."""
    design = 2 * 128 * 4 + 36 * 4 + 6 * 4
    for r in port:
        for n in (2048, 4096):
            assert r[f"bytes{D}_{n}"] == design + 4 + 4 + 2 * 4 == 1208
            assert r[f"psums{D}_{n}"] == 4 * FIXED["max_iterations"]
