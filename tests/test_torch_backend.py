"""The port's SLAM back-end solvers against the JAX package on the CPU: the
pose graph (edge terms, Gauss-Newton + PCG), plane BA (Jacobians, blocks,
the Schur solve, association, plane extraction), the urban simulator,
trajectory metrics and pose IO. The back-end as a whole, replayed on
JAX's keyframes: tests/test_torch_slam.py."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aicp_mapping_tpu.eval import kitti as jkitti
from aicp_mapping_tpu.eval import slam_accuracy as jslam
from aicp_mapping_tpu.geometry import se3 as jse3
from aicp_mapping_tpu.io import poses as jposes
from aicp_mapping_tpu.tools import urban as jurban
from aicp_mapping_tpu.tools.synthetic import room_cloud
from aicp_mapping_tpu_torch import convert
from aicp_mapping_tpu_torch.eval import kitti, slam_accuracy
from aicp_mapping_tpu_torch.geometry import se3
from aicp_mapping_tpu_torch.io import poses
from aicp_mapping_tpu_torch.tools import urban
from test_ba import _random_problem

torch.set_num_threads(1)
jba = importlib.import_module("aicp_mapping_tpu.parallel.ba")
jpg = importlib.import_module("aicp_mapping_tpu.parallel.posegraph")
jseg = importlib.import_module("aicp_mapping_tpu.ops.segmentation")
jnormals = importlib.import_module("aicp_mapping_tpu.ops.normals")
ba = importlib.import_module("aicp_mapping_tpu_torch.parallel.ba")
pg = importlib.import_module("aicp_mapping_tpu_torch.parallel.posegraph")
seg = importlib.import_module("aicp_mapping_tpu_torch.ops.segmentation")

GRAPH_FIELDS = ("poses", "edges", "measurements", "weights", "edge_mask")


def _t(a, dtype=None):
    a = np.asarray(a)
    t = torch.as_tensor(a.astype(np.int64) if a.dtype.kind == "i" else a)
    return t if dtype is None else t.to(dtype)


def _close(got, want, rtol, scale=None):
    """Normwise relative agreement: |got - want| <= rtol * scale, the scale
    by default max|want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max()) if got.size else 0.0
    if scale is None:
        scale = float(np.abs(want).max())
    assert err <= rtol * max(scale, 1e-30), (err, rtol, scale)


def _angle(D):
    """Rotation angles (rad) of (..., 3, 3) near-identity rotations, from
    their antisymmetric part (arccos of the trace loses ~1e-4 rad to f32
    rounding there)."""
    v = np.stack([D[..., 2, 1] - D[..., 1, 2], D[..., 0, 2] - D[..., 2, 0],
                  D[..., 1, 0] - D[..., 0, 1]], axis=-1)
    return np.arcsin(np.clip(np.linalg.norm(v, axis=-1) / 2, 0, 1))


def _pose_err(a, b):
    """Largest translation (m) and rotation (rad) difference of two pose
    stacks."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    t = np.linalg.norm(a[:, :3, 3] - b[:, :3, 3], axis=1).max()
    return float(t), float(_angle(np.linalg.inv(a) @ b).max())


# ---------------------------------------------------------------------------
# pose graph
# ---------------------------------------------------------------------------

def _loop_graph(seed=0, K=12):
    """A drifted 12-pose loop: ground truth on a 2 m circle, odometry edges
    with noise, four loop edges and one gross outlier closure; the initial
    poses chain the noisy odometry. Returns the graph as numpy arrays."""
    rng = np.random.default_rng(seed)

    def exp(xi):
        return np.asarray(jse3.se3_exp(jnp.asarray(xi, jnp.float32)),
                          np.float64)

    gt = []
    for k in range(K):
        a = 2 * np.pi * k / K
        T = exp(np.r_[0, 0, 0, rng.normal(0, 0.02, 2), a])
        T[:3, 3] = [2 * np.cos(a), 2 * np.sin(a), rng.normal(0, 0.1)]
        gt.append(T)
    pairs = [(k, k + 1) for k in range(K - 1)] + [(0, 11), (0, 6), (3, 9),
                                                  (2, 10), (1, 7)]
    Z, W = [], []
    for n, (i, j) in enumerate(pairs):
        noise = np.r_[rng.normal(0, 0.03, 3), rng.normal(0, 0.01, 3)]
        if (i, j) == (1, 7):
            noise[:3] += [1.0, -0.6, 0.2]          # a wrong closure
        Z.append(np.linalg.inv(gt[i]) @ gt[j] @ exp(noise))
        W.append([100.0] * 3 + [400.0] * 3 if j == i + 1
                 else [50.0] * 3 + [200.0] * 3)
    init = [gt[0]]
    for k in range(K - 1):
        init.append(init[-1] @ Z[k])
    return dict(poses=np.stack(init).astype(np.float32),
                edges=np.asarray(pairs, np.int32),
                measurements=np.stack(Z).astype(np.float32),
                weights=np.asarray(W, np.float32),
                edge_mask=np.ones(len(pairs), bool))


@pytest.mark.parametrize("robust", [0.0, 10.0])
def test_edge_terms_and_reduce_match_jax(robust):
    g = _loop_graph()
    K = g["poses"].shape[0]
    jargs = [jnp.asarray(g[f]) for f in GRAPH_FIELDS]
    targs = [_t(g[f]) for f in GRAPH_FIELDS]
    # The residual is the log of a product of poses 4 m apart: its f32
    # rounding is relative to that lever arm, not to the residual.
    lever = float(np.abs(g["poses"][:, :3, 3]).max())
    got = pg._edge_terms(*targs, robust)
    want = jax.jit(jpg._edge_terms, static_argnums=5)(*jargs, robust)
    _close(got[0], want[0], 1e-5, scale=lever)
    for a, b in zip(got[1:], want[1:]):
        _close(a, b, 1e-5)
    b, H, terms, chi2 = pg._edge_reduce(*targs, K, robust)
    jb, jH, jterms, jchi2 = jax.jit(jpg._edge_reduce, static_argnums=(
        5, 6))(*jargs, K, robust)
    _close(terms[0], jterms[0], 1e-5, scale=lever)
    for a, b in zip((b, H, chi2, *terms[1:]), (jb, jH, jchi2, *jterms[1:])):
        _close(a, b, 1e-5)
    # the matvec the PCG runs
    x = np.random.default_rng(1).normal(size=(K, 6)).astype(np.float32)
    _close(pg._matvec(_t(x), targs[1], *terms[1:], K),
           jax.jit(jpg._matvec, static_argnums=5)(jnp.asarray(x), jargs[1],
                                                  *jterms[1:], K), 1e-5)


@pytest.mark.parametrize("robust", [0.0, 10.0])
def test_optimize_pose_graph_matches_jax(robust):
    g = _loop_graph()
    want, jchi2 = jpg.optimize_pose_graph(
        jpg.PoseGraph(*(jnp.asarray(g[f]) for f in GRAPH_FIELDS)),
        robust_delta=robust)
    graph = convert.pose_graph_from_numpy(**g, device="cpu")
    got, chi2 = pg.optimize_pose_graph(graph, robust_delta=robust)
    t_err, r_err = _pose_err(got.numpy(), want)
    assert t_err <= 1e-4 and r_err <= 1e-4, (t_err, r_err)
    np.testing.assert_allclose(chi2.numpy(), np.asarray(jchi2), rtol=1e-3)
    assert float(chi2[-1]) < 0.5 * float(chi2[0])
    # the same bits on a second solve (deterministic reductions)
    assert torch.equal(pg.optimize_pose_graph(graph, robust_delta=robust)[0],
                       got)
    # a JAX graph as numpy round-trips through `convert`
    back = convert.pose_graph_to_numpy(graph)
    for f in GRAPH_FIELDS:
        np.testing.assert_array_equal(back[f], g[f])


def test_pose_graph_helpers_match_jax():
    g = _loop_graph()
    jo = jax.jit(jpg.make_odometry_edges)(jnp.asarray(g["poses"]))
    to = pg.make_odometry_edges(_t(g["poses"]))
    for got, want in zip(to, jo):
        _close(got, want, 1e-6)
    je = jpg.pad_edges(*(jnp.asarray(g[f]) for f in GRAPH_FIELDS[1:4]), 8)
    te = pg.pad_edges(*(_t(g[f]) for f in GRAPH_FIELDS[1:4]), 8)
    for got, want in zip(te, je):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    T = np.asarray(g["poses"][:5])
    _close(se3.adjoint(_t(T)), jax.vmap(jse3.adjoint)(jnp.asarray(T)), 1e-6)
    _close(se3.compose(_t(T[0]), _t(T[1])),
           jse3.compose(jnp.asarray(T[0]), jnp.asarray(T[1])), 1e-6)
    # the sharded solvers on a mesh of one rank are the single-device
    # solves, bit for bit (their collectives are the identity there; the
    # multi-rank cases are tests/test_torch_sharded_backend.py)
    from aicp_mapping_tpu_torch.parallel import make_mesh

    graph = convert.pose_graph_from_numpy(**_loop_graph(), device="cpu")
    got = pg.optimize_pose_graph_sharded(
        graph, make_mesh(1, "edges", device="cpu"), gn_iters=2)
    want = pg.optimize_pose_graph(graph, gn_iters=2)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    prob, _, _ = _random_problem(seed=3)
    p = convert.plane_ba_from_numpy(**_ba_numpy(prob), device="cpu")
    got = ba.optimize_plane_ba_sharded(
        p, make_mesh(1, "graph", device="cpu"), gn_iters=2)
    want = ba.optimize_plane_ba(p, gn_iters=2)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# plane BA
# ---------------------------------------------------------------------------

def _ba_numpy(prob) -> dict:
    return {k: np.asarray(v) for k, v in convert.plane_ba_to_numpy(
        prob).items()}


def test_linearize_matches_jacfwd():
    prob, _, _ = _random_problem(seed=3)
    T, lm, meas = prob.poses[prob.obs_k], prob.landmarks[prob.obs_l], \
        prob.obs_plane
    want = jax.jit(jax.vmap(jba._linearize))(T, lm, meas)
    got = ba._linearize(_t(T), _t(lm), _t(meas))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)
    # the residual the Jacobians linearize
    np.testing.assert_allclose(
        ba.plane_residual(torch.zeros(6), torch.zeros(4), _t(T[0]),
                          _t(lm[0]), _t(meas[0])).numpy(),
        np.asarray(jba.plane_residual(jnp.zeros(6), jnp.zeros(4), T[0],
                                      lm[0], meas[0])), atol=1e-6)


@pytest.mark.parametrize("robust", [False, True])
def test_accumulate_blocks_match_jax(robust):
    prob, _, _ = _random_problem(seed=3)
    prob = jba.pad_observations(prob, 64)       # masked rows take no part
    sig = (0.09, 0.10) if robust else (0.0, 0.0)
    p = _ba_numpy(prob)
    K, L = p["poses"].shape[0], p["landmarks"].shape[0]
    want = jax.jit(jba._accumulate, static_argnums=(7, 8, 9, 10))(
        *(jnp.asarray(p[k]) for k in p), K, L, *sig)
    got = ba._accumulate(*(_t(p[k]) for k in p), K, L, *sig)
    for g, w in zip(got, want):
        _close(g, w, 1e-5)


def _room_drift_problem():
    """tests/test_ba.py's room-drift problem: six keyframes along a room
    with accumulated z / pitch drift, planes extracted by JAX. Returns
    (numpy per-keyframe planes, weights, valid; drifted poses)."""
    world = room_cloud(n=6000, size=10.0, seed=4, noise=0.004)
    K = 6
    rng = np.random.default_rng(11)
    gt = np.tile(np.eye(4), (K, 1, 1))
    gt[:, 0, 3] = np.arange(K, dtype=np.float64)
    pert, z_err, pitch_err = [], 0.0, 0.0
    for k in range(K):
        z_err += rng.normal(0.0, 0.08)
        pitch_err += np.deg2rad(rng.normal(0.0, 1.5))
        c, s = np.cos(pitch_err), np.sin(pitch_err)
        D = np.eye(4)
        D[0, 0], D[0, 2], D[2, 0], D[2, 2], D[2, 3] = c, s, -s, c, z_err
        pert.append(gt[k] @ D)
    planes, ws, vs = [], [], []
    for k in range(K):
        Tb = jnp.asarray(np.linalg.inv(gt[k]).astype(np.float32))
        body = jse3.transform_points(Tb, jnp.asarray(world))
        m = jnp.ones((body.shape[0],), bool)
        normals, curv, _ = jnormals.radius_normals(body, m, 0.5)
        pl, w, v = jba.extract_planes(body, m, normals, curv, max_planes=12,
                                      min_points=80)
        planes.append(np.asarray(pl))
        ws.append(np.asarray(w))
        vs.append(np.asarray(v))
    return (np.stack(planes), np.stack(ws), np.stack(vs),
            np.stack(pert).astype(np.float32))


@pytest.fixture(scope="module")
def room_drift():
    return _room_drift_problem()


def test_build_plane_ba_association_matches_jax(room_drift):
    planes, ws, vs, pert = room_drift
    for kw in (dict(), dict(reject_normal_deg=8.0, reject_offset_m=0.3,
                            min_obs_per_landmark=2)):
        want = _ba_numpy(jba.build_plane_ba(pert, planes, ws, vs, **kw))
        got = convert.plane_ba_to_numpy(ba.build_plane_ba(
            pert, planes, ws, vs, device="cpu", **kw))
        for k in ("obs_k", "obs_l", "obs_mask", "obs_w"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        for k in ("landmarks", "obs_plane", "poses"):
            np.testing.assert_allclose(got[k], want[k], atol=1e-5, err_msg=k)
    with pytest.raises(ValueError, match="no valid planes"):
        ba.build_plane_ba(pert, planes, ws, np.zeros_like(vs), device="cpu")


def test_optimize_plane_ba_matches_jax(room_drift):
    """tests/test_ba.py's problems: the noiseless random problem alone, and
    the room-drift problem jointly with its odometry edges, Huber on."""
    prob, _, _ = _random_problem(seed=3)
    want, jlms, jchi2 = jba.optimize_plane_ba(prob, gn_iters=8)
    p = convert.plane_ba_from_numpy(**_ba_numpy(prob), device="cpu")
    got, lms, chi2 = ba.optimize_plane_ba(p, gn_iters=8)
    t_err, r_err = _pose_err(got.numpy(), want)
    assert t_err <= 1e-4 and r_err <= 1e-4, (t_err, r_err)
    np.testing.assert_allclose(lms.numpy(), np.asarray(jlms), atol=1e-4)

    planes, ws, vs, pert = room_drift
    jprob = jba.build_plane_ba(pert, planes, ws, vs, reject_normal_deg=8.0,
                               reject_offset_m=0.3, min_obs_per_landmark=2)
    edges, Z, ew = jpg.make_odometry_edges(jnp.asarray(pert))
    kw = dict(gn_iters=6, pose_damping=1.0, robust_sigma_n=0.09,
              robust_sigma_e=0.10, edge_robust_delta=10.0)
    want, _, jchi2 = jba.optimize_plane_ba(
        jprob, graph_edges=edges, graph_Z=Z, graph_w=ew,
        graph_mask=jnp.ones((edges.shape[0],), bool), **kw)
    p = convert.plane_ba_from_numpy(**_ba_numpy(jprob), device="cpu")
    got, _, chi2 = ba.optimize_plane_ba(
        p, graph_edges=_t(edges), graph_Z=_t(Z), graph_w=_t(ew),
        graph_mask=torch.ones(edges.shape[0], dtype=torch.bool), **kw)
    t_err, r_err = _pose_err(got.numpy(), want)
    assert t_err <= 1e-4 and r_err <= 1e-4, (t_err, r_err)
    np.testing.assert_allclose(float(chi2), float(jchi2), rtol=1e-3)
    # padding is a no-op
    padded = ba.pad_observations(p, 16)
    assert padded.obs_k.shape[0] % 16 == 0
    got2 = ba.optimize_plane_ba(
        padded, graph_edges=_t(edges), graph_Z=_t(Z), graph_w=_t(ew),
        graph_mask=torch.ones(edges.shape[0], dtype=torch.bool), **kw)[0]
    np.testing.assert_allclose(got2.numpy(), got.numpy(), atol=1e-5)


# ---------------------------------------------------------------------------
# plane extraction and the region-growing front-end pieces
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def room():
    pts = room_cloud(n=4000, size=8.0, seed=0, noise=0.003)
    mask = np.ones(len(pts), bool)
    mask[::37] = False
    normals, curv, _ = (np.asarray(a) for a in jnormals.radius_normals(
        jnp.asarray(pts), jnp.asarray(mask), 0.5))
    return pts, mask, normals, curv


def test_hough_labels_and_extract_planes_match_jax(room):
    pts, mask, normals, curv = room
    jargs = [jnp.asarray(a) for a in room]
    targs = [_t(a) for a in room]
    want = np.asarray(jseg.hough_plane_labels(*jargs))
    np.testing.assert_array_equal(seg.hough_plane_labels(*targs).numpy(),
                                  want)
    assert want.max() > 10
    jp, jw, jv = jba.extract_planes(*jargs, max_planes=12, min_points=80)
    tp, tw, tv = ba.extract_planes(*targs, max_planes=12, min_points=80)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-5)
    assert int(tv.sum()) >= 4
    # a plane in a keyframe's frame goes to the world as JAX puts it
    T = np.asarray(jse3.se3_exp(jnp.asarray([0.3, -0.2, 0.1, 0.05, -0.1, 0.7],
                                            jnp.float32)))
    np.testing.assert_allclose(
        ba.transform_plane(_t(T), tp).numpy(),
        np.asarray(jax.vmap(lambda p: jba.transform_plane(T, p))(jp)),
        atol=1e-5)


# ---------------------------------------------------------------------------
# the urban simulator, metrics and pose IO
# ---------------------------------------------------------------------------

def test_urban_drive_inputs_bit_equal_to_jax():
    kw = dict(seed=0, extent=60.0, pitch=28.0, street=12.0)
    world, jworld = urban.make_urban_world(**kw), jurban.make_urban_world(**kw)
    np.testing.assert_array_equal(world.boxes, jworld.boxes)
    lap = int(round(4 * world.pitch / 3.0))
    gt = slam_accuracy.loop_circuit_poses(world, lap, 44, 3.0)
    np.testing.assert_array_equal(
        gt, jslam.loop_circuit_poses(jworld, lap, 44, 3.0))
    for i in (0, 9, 30):
        skw = dict(n_beams=48, n_azimuth=384, max_range=25.0, noise=0.02,
                   seed=10 + i)
        np.testing.assert_array_equal(
            urban.velodyne_scan(world, gt[i].astype(np.float64), **skw),
            jurban.velodyne_scan(jworld, gt[i].astype(np.float64), **skw))


def test_ate_rmse_matches_jax():
    rng = np.random.default_rng(3)
    gt = np.tile(np.eye(4), (20, 1, 1))
    gt[:, :3, 3] = np.cumsum(rng.normal(size=(20, 3)), axis=0)
    est = gt.copy()
    est[:, :3, 3] += rng.normal(0, 0.1, (20, 3)) + [3.0, -1.0, 0.5]
    for align in (True, False):
        assert kitti.ate_rmse(gt, est, align) == jkitti.ate_rmse(gt, est,
                                                                 align)
    R, t = kitti.umeyama_alignment(est[:, :3, 3], gt[:, :3, 3])
    jR, jt = jkitti.umeyama_alignment(est[:, :3, 3], gt[:, :3, 3])
    np.testing.assert_array_equal(R, jR)
    np.testing.assert_array_equal(t, jt)


def test_pose_files_match_jax(tmp_path):
    g = _loop_graph()
    mine, theirs = str(tmp_path / "a.csv"), str(tmp_path / "b.csv")
    recs = [poses.PoseWithTime(i, 10 + i, 500 * i, g["poses"][i])
            for i in range(6)]
    poses.write_pose_csv(mine, recs)
    jposes.write_pose_csv(theirs, [jposes.PoseWithTime(
        r.counter, r.sec, r.nsec, r.pose) for r in recs])
    for a, b in zip(poses.read_pose_csv(mine), jposes.read_pose_csv(theirs)):
        assert (a.counter, a.sec, a.nsec, a.utime) == \
            (b.counter, b.sec, b.nsec, b.utime)
        np.testing.assert_allclose(a.pose, b.pose, atol=1e-6)
    mine, theirs = str(tmp_path / "a.txt"), str(tmp_path / "b.txt")
    poses.write_kitti_poses(mine, g["poses"])
    jposes.write_kitti_poses(theirs, g["poses"])
    assert open(mine).read() == open(theirs).read()
    np.testing.assert_array_equal(poses.read_kitti_poses(mine),
                                  jposes.read_kitti_poses(theirs))
