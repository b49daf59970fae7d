"""Parity of the port's ICP (plain matcher on CPU) with the JAX solver on
the same inputs: every single-device branch, on synthetic rooms and on the
shipped planar scans data/scan_0*.csv."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aicp_mapping_tpu.geometry import se3 as jse3
from aicp_mapping_tpu.io.planar import planar_to_cloud, read_planar_csv
from aicp_mapping_tpu.ops.normals import estimate_normals
from aicp_mapping_tpu.registration import icp as jicp
from aicp_mapping_tpu.tools.synthetic import room_cloud
from aicp_mapping_tpu_torch.registration import icp

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "..", "data")
# Same solution: translation within 1 mm, rotation within 0.05 deg.
T_TOL_M, R_TOL_DEG = 1e-3, 0.05


def _assert_same_solution(res_t, res_j):
    Tt, Tj = res_t.T.numpy(), np.asarray(res_j.T)
    assert np.linalg.norm(Tt[:3, 3] - Tj[:3, 3]) <= T_TOL_M, (Tt, Tj)
    rel = np.asarray(jse3.rotation_angle_deg(jnp.asarray(Tj.T @ Tt)))
    assert rel <= R_TOL_DEG, rel
    assert abs(res_t.n_iterations - int(res_j.n_iterations)) <= 1


def _solve_both(reading, rmask, ref, normals, ref_mask, ratio, **cfg):
    res_j = jicp.point_to_plane_icp(
        jnp.asarray(reading), jnp.asarray(rmask), jnp.asarray(ref),
        jnp.asarray(normals), jnp.asarray(ref_mask), jse3.identity(),
        jnp.float32(ratio), jicp.ICPConfig(**cfg))
    t = [torch.as_tensor(np.array(a))
         for a in (reading, rmask, ref, normals, ref_mask)]
    res_t = icp.point_to_plane_icp(*t, torch.eye(4), torch.tensor(ratio),
                                   icp.ICPConfig(**cfg))
    return res_t, res_j


@pytest.fixture(scope="module")
def room():
    pts = room_cloud(n=2100, size=8.0, seed=21, noise=0.005)[:2048]
    mask = np.ones(2048, bool)
    mask[-48:] = False
    normals, _, _ = estimate_normals(jnp.asarray(pts), jnp.asarray(mask),
                                     k=12)
    T = jse3.make_transform(jse3.so3_exp(jnp.float32([0.02, -0.03, 0.06])),
                            jnp.float32([0.12, -0.08, 0.03]))
    reading = np.asarray(jse3.transform_points(T, jnp.asarray(pts)))
    return reading, mask, pts, np.array(normals), mask


@pytest.mark.parametrize("cfg", [
    dict(),
    dict(trim_normal_space=True),
    dict(coarse_iterations=4, coarse_decimation=4),
    dict(error_metric="point_to_point"),
    dict(degeneracy_threshold=30.0, max_match_dist=0.5),
], ids=["plane", "normal_space_trim", "coarse_to_fine", "point", "degen"])
def test_icp_matches_jax_on_room(room, cfg):
    res_t, res_j = _solve_both(*room, 0.7, **cfg)
    _assert_same_solution(res_t, res_j)
    # the solve recovered the perturbation (the comparison is not vacuous)
    assert res_t.n_iterations >= 3
    assert abs(float(res_t.T[0, 3]) + 0.12) < 0.03


@pytest.mark.parametrize("scan", ["scan_00.csv", "scan_01.csv",
                                  "scan_02.csv"])
def test_icp_matches_jax_on_planar_scans(scan):
    """Self-registration of a shipped planar scan under an in-plane
    perturbation, point-to-point with the degeneracy-aware solve (the
    planar analog of corridor degeneracy) — the JAX suite's own pattern."""
    pts = planar_to_cloud(read_planar_csv(os.path.join(DATA, scan)))
    cap = 1024
    ref = np.zeros((cap, 3), np.float32)
    ref[:len(pts)] = pts
    mask = np.arange(cap) < len(pts)
    T = jse3.make_transform(jse3.so3_exp(jnp.float32([0.0, 0.0, 0.05])),
                            jnp.float32([0.06, -0.05, 0.0]))
    reading = np.asarray(jse3.transform_points(T, jnp.asarray(ref)))
    res_t, res_j = _solve_both(reading, mask, ref, np.zeros_like(ref), mask,
                               0.85, error_metric="point_to_point",
                               degeneracy_threshold=20.0)
    _assert_same_solution(res_t, res_j)


def test_solver_plan_and_unported_branches():
    """Every operating point's matcher, pinned: K1 (or its twin) below
    32,768 references; the banded matcher (K5 at any number of reference
    blocks) by shape on CPU and CUDA alike."""
    cfg = icp.ICPConfig(coarse_iterations=6, coarse_decimation=8)
    assert icp.solver_plan(cfg, 8192, 8192, "cuda") == {
        "nn": "kernel", "coarse": True}
    assert icp.solver_plan(cfg, 8192, 8192, "cpu") == {
        "nn": "plain", "coarse": True}
    assert not icp.solver_plan(cfg, 1024, 8192, "cpu")["coarse"]
    for dev, nn in (("cuda", "kernel"), ("cpu", "plain")):
        assert icp.solver_plan(cfg, 8192, 31744, dev) == {
            "nn": nn, "coarse": True}
    for dev in ("cpu", "cuda"):
        for N in (32768, 65536, 66560, 131072, 262144):
            assert icp.solver_plan(cfg, 8192, N, dev) == {
                "nn": "banded", "coarse": True}
        # unaligned shapes keep the full matcher
        assert icp.solver_plan(cfg, 8000, 65536, dev)["nn"] != "banded"
    assert icp.solver_plan(icp.ICPConfig(nn_mode="banded"), 512, 2048,
                           "cpu")["nn"] == "banded"
    pts = torch.zeros((512, 3))
    m = torch.ones(512, dtype=torch.bool)
    # an SPMD solve needs its mesh (tests/test_torch_sharded_icp.py)
    with pytest.raises(ValueError, match="mesh"):
        icp.point_to_plane_icp(pts, m, pts, pts, m, torch.eye(4), 0.5,
                               icp.ICPConfig(axis_name="x"))


@pytest.fixture(scope="module")
def map_scene():
    """An 8,192-point reference with normals (a 16 m room centred on the
    origin) and a 1,024-point second scan of it, moved by a small
    transform: the banded ICP's shapes cut to CPU size."""
    ref = room_cloud(n=9900, size=16.0, seed=31, noise=0.005)[:8192]
    mask = np.ones(8192, bool)
    mask[-100:] = False
    normals, _, _ = estimate_normals(jnp.asarray(ref), jnp.asarray(mask),
                                     k=12)
    scan = room_cloud(n=1240, size=16.0, seed=32, noise=0.005)[:1024]
    T = jse3.make_transform(jse3.so3_exp(jnp.float32([0.01, -0.01, 0.04])),
                            jnp.float32([0.15, -0.1, 0.02]))
    reading = np.asarray(jse3.transform_points(T, jnp.asarray(scan)))
    rmask = np.ones(1024, bool)
    rmask[::97] = False
    return reading, rmask, ref, np.array(normals), mask


@pytest.mark.parametrize("cfg", [
    dict(nn_mode="banded", nn_band=0, nn_cell_size=2.0),
    dict(nn_mode="banded", nn_band=4, nn_cell_size=2.0),
    dict(nn_mode="banded", nn_band=0, nn_cell_size=2.0,
         coarse_iterations=4, coarse_decimation=2),
], ids=["auto_band", "band4", "coarse_to_fine"])
def test_banded_icp_matches_jax(map_scene, cfg):
    """The port's banded ICP (the plain twin of K5) against JAX's banded
    ICP (its split kernels in interpret mode): the same T, and per-point
    outputs back in the caller's order."""
    res_t, res_j = _solve_both(*map_scene, 0.7, **cfg)
    _assert_same_solution(res_t, res_j)
    assert res_t.n_iterations >= 3
    assert abs(float(res_t.T[0, 3]) + 0.15) < 0.03
    dt, dj = res_t.match_dist2.numpy(), np.asarray(res_j.match_dist2)
    valid = map_scene[1]
    assert (dt[~valid] >= 3.39e38).all() and (dj[~valid] >= 3.39e38).all()
    np.testing.assert_allclose(dt[valid], dj[valid], atol=2e-3)
    assert (res_t.inlier_mask.numpy() == np.asarray(res_j.inlier_mask)
            ).mean() >= 0.98


def test_clamp_trim_ratio_and_degeneracy_predictions_match_jax():
    for ov in (5.0, 40.0, 95.0):
        assert float(icp.clamp_trim_ratio(torch.tensor(ov))) == \
            float(jicp.clamp_trim_ratio(jnp.float32(ov)))
    rng = np.random.default_rng(4)
    J = rng.normal(size=(300, 6)).astype(np.float32)
    J[:, 0] *= 0.05                                   # weak x translation
    H = J.T @ J
    got = [float(v) for v in icp.degeneracy_predictions(torch.as_tensor(H))]
    want = [float(v) for v in jicp.degeneracy_predictions(jnp.asarray(H))]
    np.testing.assert_allclose(got, want, rtol=1e-4)
