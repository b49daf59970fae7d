"""The port's numpy modules against the JAX package's on the CPU: VTK and
planar-scan IO, the drawing geometry and `occupied_cells`, the talker,
timing and the profiler trace, the six `se3` functions, `NormalCloud`,
the `native` file names, and the planar 2D registration chain."""
import glob
import os
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aicp_mapping_tpu.geometry import se3 as jse3
from aicp_mapping_tpu.io import planar as jplanar
from aicp_mapping_tpu.io import vtk as jvtk
from aicp_mapping_tpu.utils import drawing as jdrawing
from aicp_mapping_tpu.utils import talker as jtalker
from aicp_mapping_tpu.utils import timing as jtiming
from aicp_mapping_tpu.utils import visualizer as jvisualizer
from aicp_mapping_tpu_torch import cloud as tcloud
from aicp_mapping_tpu_torch.geometry import se3
from aicp_mapping_tpu_torch.io import planar, vtk
from aicp_mapping_tpu_torch.utils import (drawing, profiler_trace, talker,
                                          timing, visualizer)

torch.set_num_threads(1)
ROOT = os.path.join(os.path.dirname(__file__), "..")
# tests/test_se3.py's tolerance for the same cases
SE3_TOL = 1e-6


def _cloud(n=200, seed=0, lo=-5.0, hi=5.0):
    return np.random.default_rng(seed).uniform(lo, hi, (n, 3)).astype(
        np.float32)


# ------------------------------------------------------------------- VTK
@pytest.mark.parametrize("binary", [False, True])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_vtk_points_cross_read(tmp_path, binary, writer):
    """A VTK file written by either package: the same bytes from both
    writers, and both readers return the same points bit for bit (binary:
    the written floats exactly; ASCII: the 6-digit text)."""
    pts = _cloud()
    pts[3] = np.nan           # dropped by both readers
    paths = {}
    for name, mod in (("jax", jvtk), ("port", vtk)):
        paths[name] = str(tmp_path / f"{name}.vtk")
        mod.write_vtk(paths[name], pts, binary=binary)
    assert open(paths["jax"], "rb").read() == open(paths["port"],
                                                    "rb").read()
    got, want = vtk.read_vtk(paths[writer]), jvtk.read_vtk(paths[writer])
    np.testing.assert_array_equal(got, want)
    assert got.shape == (199, 3) and got.dtype == np.float32
    if binary:
        np.testing.assert_array_equal(got, np.delete(pts, 3, axis=0))


def test_vtk_binary_is_big_endian(tmp_path):
    p = str(tmp_path / "b.vtk")
    vtk.write_vtk(p, np.array([[1.0, 2.0, 3.0]], np.float32), binary=True)
    raw = open(p, "rb").read()
    assert np.array([1.0, 2.0, 3.0], ">f4").tobytes() in raw
    assert b"VERTICES 1 2\n" + np.array([1, 0], ">i4").tobytes() in raw


@pytest.mark.parametrize("binary", [False, True])
def test_vtk_lines_bytes_equal_jax(tmp_path, binary):
    """tests/test_utils.py::test_write_vtk_lines's case, byte for byte
    the JAX writer's output."""
    segs = np.arange(24, dtype=np.float32).reshape(4, 2, 3)
    a, b = str(tmp_path / "a.vtk"), str(tmp_path / "b.vtk")
    vtk.write_vtk_lines(a, segs, binary=binary)
    jvtk.write_vtk_lines(b, segs, binary=binary)
    assert open(a, "rb").read() == open(b, "rb").read()
    text = open(a, "rb").read()
    assert b"POINTS 8 float" in text and b"LINES 4 12" in text
    if not binary:
        assert b"2 0 1" in text and b"2 6 7" in text


# ---------------------------------------------------------------- planar
def test_planar_csv_round_trip(tmp_path):
    pts = (np.random.default_rng(3).uniform(-6, 6, (300, 2))
           .astype(np.float32))
    a, b = str(tmp_path / "a.csv"), str(tmp_path / "b.csv")
    planar.write_planar_csv(a, pts)
    jplanar.write_planar_csv(b, np.concatenate(
        [pts, np.ones((300, 1), np.float32)], axis=1))   # z is dropped
    assert open(a).read() == open(b).read()
    got = planar.read_planar_csv(a)
    np.testing.assert_array_equal(got, jplanar.read_planar_csv(a))
    np.testing.assert_allclose(got, pts, rtol=1e-5, atol=1e-5)
    lifted = planar.planar_to_cloud(got)
    np.testing.assert_array_equal(lifted, jplanar.planar_to_cloud(got))
    assert lifted.shape == (300, 3) and not lifted[:, 2].any()


@pytest.mark.parametrize("path", sorted(glob.glob(
    os.path.join(ROOT, "data", "scan_0*.csv"))))
def test_shipped_scans_load_equal(path):
    got = planar.read_planar_csv(path)
    np.testing.assert_array_equal(got, jplanar.read_planar_csv(path))
    assert got.shape[0] > 100


@pytest.mark.parametrize("kw", [
    dict(pose_xytheta=(0.0, 0.0, 0.0), seed=0),
    dict(pose_xytheta=(0.25, -0.15, 0.06), seed=1),
    dict(pose_xytheta=(-1.0, 2.0, 1.2), n_beams=360, noise=0.01, seed=7),
    dict(pose_xytheta=(0.5, 0.5, -0.4), room=6.0, max_range=3.0,
         noise=0.02, seed=3),
])
def test_synthetic_room_scan_bits(kw):
    got = planar.synthetic_room_scan(**kw)
    want = jplanar.synthetic_room_scan(**kw)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------- drawing, sinks
@pytest.mark.parametrize("res", [0.2, 0.5, 1.3])
def test_octree_geometry_equals_jax(res):
    pts = _cloud(500, seed=4, lo=-3.0, hi=3.0)
    np.testing.assert_array_equal(visualizer.occupied_cells(pts, res),
                                  jvisualizer.occupied_cells(pts, res))
    got = drawing.octree_wireframe(pts, res)
    np.testing.assert_array_equal(got, jdrawing.octree_wireframe(pts, res))
    assert got.shape == (len(visualizer.occupied_cells(pts, res)) * 12, 2, 3)
    empty = drawing.octree_wireframe(np.zeros((0, 3), np.float32), res)
    assert empty.shape == (0, 2, 3)


def test_drawing_cases_of_the_jax_suite():
    """tests/test_utils.py's and tests/test_io.py's drawing cases."""
    pts = np.array([[0.05, 0.05, 0.05], [0.06, 0.04, 0.05],
                    [1.05, 0.05, 0.05]], np.float32)
    segs = drawing.octree_wireframe(pts, 0.2)
    d = segs[:, 1] - segs[:, 0]
    np.testing.assert_allclose(np.linalg.norm(d, axis=1), 0.2, atol=1e-6)
    assert np.all((np.abs(d) > 1e-7).sum(axis=1) == 1)
    cells = visualizer.occupied_cells(np.array(
        [[0.1, 0.1, 0.1], [0.15, 0.12, 0.13], [1.3, 0.1, 0.1]], np.float32),
        0.5)
    assert cells.shape == (2, 3)
    np.testing.assert_allclose(cells[0], [0.25, 0.25, 0.25], atol=1e-6)


@pytest.mark.parametrize("stride,scale", [(1, 0.2), (2, 0.5), (7, 1.0)])
def test_normals_and_pose_segments_equal_jax(stride, scale):
    pts = _cloud(40, seed=5)
    nrm = _cloud(40, seed=6, lo=-1.0, hi=1.0)
    np.testing.assert_array_equal(
        drawing.normals_segments(pts, nrm, scale=scale, stride=stride),
        jdrawing.normals_segments(pts, nrm, scale=scale, stride=stride))
    poses = np.asarray(jse3.se3_exp(jnp.asarray(
        np.random.default_rng(stride).normal(size=(5, 6)), jnp.float32)))
    for p in (poses, poses[0]):
        np.testing.assert_array_equal(
            drawing.pose_axes_segments(p, scale=scale),
            jdrawing.pose_axes_segments(p, scale=scale))


def test_recording_and_file_sinks(tmp_path):
    """The sinks keep every publish as JAX's do; FileVisualizer's PCDs read
    back to the published points."""
    from aicp_mapping_tpu_torch.io.pcd import read_pcd

    pts = _cloud(50, seed=9)
    for cls in (visualizer.RecordingVisualizer, visualizer.FileVisualizer):
        sink = (cls(str(tmp_path / "dump")) if cls is
                visualizer.FileVisualizer else cls())
        assert np.array_equal(sink.get_path()[0], np.eye(4))
        sink.publish_cloud(pts, 0, "reading", 7)
        sink.publish_map(pts[:20], 8, 1)
        sink.publish_pose(np.eye(4, dtype=np.float32) * 2, 0, "", 9)
        sink.publish_metric("octree_overlap", np.float32(55.5), 9)
        sink.publish_lines(drawing.octree_wireframe(pts, 1.0), "octree", 9)
        assert [u for u, _ in sink.clouds] == [7]
        assert sink.metrics == {"octree_overlap": [(9, 55.5)]}
        assert sink.get_path()[-1][0, 0] == 2
        assert sink.lines[0][1] == "octree"
    got, _ = read_pcd(str(tmp_path / "dump" / "cloud_reading_7.pcd"))
    np.testing.assert_array_equal(got, pts)
    got, _ = read_pcd(str(tmp_path / "dump" / "aligned_map.pcd"))
    np.testing.assert_array_equal(got, pts[:20])
    null = visualizer.NullVisualizer()
    null.publish_cloud(pts, 0, "", 0)
    assert len(null.get_path()) == 1


# ---------------------------------------------------------- talker, timing
def test_talker_cases_of_the_jax_suite():
    """tests/test_utils.py's talker cases, and the same plans as JAX's."""
    path = []
    for i in range(4):
        T = np.eye(4, dtype=np.float32)
        T[0, 3] = float(i)
        path.append(T)
    rev = talker.reverse_path(path)
    assert [p[0, 3] for p in rev] == [3.0, 2.0, 1.0, 0.0]
    for p in rev[:-1]:
        np.testing.assert_allclose(p[:3, 0], [-1, 0, 0], atol=1e-6)
    got = {}
    t = talker.Talker(publish=lambda plan, u: got.update(n=len(plan), t=u))
    t.publish_footstep_plan(path, 123, reverse=True)
    assert got == {"n": 4, "t": 123}
    assert abs(talker.angle_between_2d(np.array([1, 0]),
                                       np.array([0, 1])) - 90) < 1e-9
    assert abs(talker.angle_between_2d(np.array([1, 0]),
                                       np.array([0, -1])) + 90) < 1e-9
    # a curved path: the same re-oriented poses as JAX's, bit for bit
    curve = [np.asarray(jse3.se3_exp(jnp.float32(
        [0.8 * i, 0.3 * i * i, 0.0, 0.0, 0.0, 0.2 * i]))) for i in range(6)]
    for a, b in zip(talker.reverse_path(curve), jtalker.reverse_path(curve)):
        np.testing.assert_array_equal(a, b)
    assert len(talker.Talker().publish_footstep_plan(curve, 1)) == 6


def test_timing_sections_and_summary(capsys):
    t, jt = timing.TimingUtils(verbose=True), jtiming.TimingUtils()
    for tu in (t, jt):
        with tu.section("a"):
            tu.tic()
            tu.toc("b")
        with tu.section("a"):
            pass
    assert t.summary().keys() == jt.summary().keys() == {"a", "b"}
    assert t.summary()["a"]["count"] == 2 and t.summary()["b"]["count"] == 1
    assert "[Timing] a:" in capsys.readouterr().out
    # one stack per thread: a section open here is not closed by another
    # thread's toc
    t.tic()
    errors = []

    def other():
        try:
            t.toc("other")
        except IndexError as e:
            errors.append(e)

    th = threading.Thread(target=other)
    th.start()
    th.join(timeout=10)
    assert not th.is_alive() and len(errors) == 1
    assert t.toc("mine") >= 0.0


def test_profiler_trace_writes_a_trace(tmp_path):
    with profiler_trace(str(tmp_path)):
        (torch.ones(64) * 2).sum()
    traces = glob.glob(str(tmp_path / "*.pt.trace.json"))
    assert len(traces) == 1 and os.path.getsize(traces[0]) > 0


# ------------------------------------------------------------------ se3
def _t(a):
    return torch.as_tensor(np.array(a))


def test_quaternion_functions_match_jax():
    np.testing.assert_array_equal(se3.quat_identity().numpy(),
                                  np.asarray(jse3.quat_identity()))
    rng = np.random.default_rng(0)
    a = rng.normal(size=(16, 4)).astype(np.float32)
    b = rng.normal(size=(16, 4)).astype(np.float32)
    np.testing.assert_allclose(se3.quat_multiply(_t(a), _t(b)).numpy(),
                               np.asarray(jse3.quat_multiply(a, b)),
                               atol=SE3_TOL)
    # tests/test_se3.py::test_euler_quat_roundtrip's angles
    rpy = np.array([[0.3, -0.2, 1.4], [0.0, 0.0, 0.0], [1.0, 0.5, -2.0]])
    q = se3.euler_to_quat(rpy[:, 0], rpy[:, 1], rpy[:, 2])
    assert q.dtype == torch.float32
    np.testing.assert_allclose(q.numpy(), np.asarray(jse3.euler_to_quat(
        rpy[:, 0], rpy[:, 1], rpy[:, 2])), atol=SE3_TOL)
    for got, want, angle in zip(se3.quat_to_euler(q),
                                jse3.quat_to_euler(jnp.asarray(q.numpy())),
                                rpy.T):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=SE3_TOL)
        np.testing.assert_allclose(got.numpy(), angle, atol=SE3_TOL)


def test_repin_roll_pitch_and_rotation_angle_match_jax():
    # tests/test_se3.py::test_repin_roll_pitch's poses
    corrected = jse3.make_transform(jse3.quat_to_matrix(
        jse3.euler_to_quat(0.2, 0.1, 0.7)), jnp.array([1.0, 2.0, 3.0]))
    odom = jse3.make_transform(jse3.quat_to_matrix(
        jse3.euler_to_quat(0.05, -0.02, 2.0)), jnp.zeros(3))
    cases = [(corrected, odom)]
    for seed in range(6):      # tests/test_se3.py::test_repin_numpy_...
        xi = np.random.default_rng(seed).normal(size=(2, 6)).astype(
            np.float32)
        cases.append(tuple(jse3.se3_exp(jnp.asarray(x)) for x in xi))
    for c, o in cases:
        got = se3.repin_roll_pitch(_t(c), _t(o)).numpy()
        np.testing.assert_allclose(got, np.asarray(jse3.repin_roll_pitch(
            c, o)), atol=SE3_TOL)
        np.testing.assert_allclose(got, tcloud.repin_roll_pitch_np(
            np.asarray(c), np.asarray(o)), atol=1e-5)
    r, p, y = se3.quat_to_euler(se3.matrix_to_quat(se3.rotation(
        se3.repin_roll_pitch(_t(corrected), _t(odom)))))
    assert abs(float(r) - 0.05) < 1e-5 and abs(float(p) + 0.02) < 1e-5
    assert abs(float(y) - 0.7) < 1e-5
    T = se3.make_transform(se3.so3_exp(torch.tensor([0.0, 0.0, np.pi / 6])),
                           torch.zeros(3))
    assert abs(float(se3.rotation_angle_deg(T)) - 30.0) < 1e-3
    Ts = jse3.se3_exp(jnp.asarray(np.random.default_rng(9).normal(
        size=(8, 6)).astype(np.float32)))
    np.testing.assert_allclose(se3.rotation_angle_deg(_t(Ts)).numpy(),
                               np.asarray(jse3.rotation_angle_deg(Ts)),
                               atol=1e-4)


# ------------------------------------------------- cloud, native, chain
def test_normal_cloud_and_current_reference():
    from aicp_mapping_tpu.cloud import NormalCloud as JNormalCloud

    import aicp_mapping_tpu_torch as port

    rng = np.random.default_rng(2)
    pts = rng.normal(size=(32, 3)).astype(np.float32)
    nrm = rng.normal(size=(32, 3)).astype(np.float32)
    curv = rng.uniform(size=32).astype(np.float32)
    mask = rng.uniform(size=32) > 0.3
    T = np.asarray(jse3.se3_exp(jnp.float32([0.3, -0.1, 0.2, 0.1, 0.2,
                                             -0.3])))
    nc = port.NormalCloud(_t(pts), _t(nrm), _t(curv), _t(mask))
    jnc = JNormalCloud(jnp.asarray(pts), jnp.asarray(nrm),
                       jnp.asarray(curv), jnp.asarray(mask))
    assert nc.capacity == 32 and int(nc.count()) == int(jnc.count())
    moved, jmoved = nc.transform(_t(T)), jnc.transform(jnp.asarray(T))
    np.testing.assert_allclose(moved.points.numpy(),
                               np.asarray(jmoved.points), atol=1e-5)
    np.testing.assert_allclose(moved.normals.numpy(),
                               np.asarray(jmoved.normals), atol=1e-5)
    assert moved.curvature is nc.curvature
    np.testing.assert_array_equal(nc.as_cloud().to_numpy(), pts[mask])

    g = port.AlignedCloudsGraph()
    clouds = [port.AlignedCloud.create(i, nc.as_cloud(), np.eye(4))
              for i in range(3)]
    g.initialize(clouds[0])
    g.add(clouds[1])
    g.add(clouds[2])
    assert g.current_reference() is clouds[0]
    g.update_reference(2)
    assert g.current_reference() is clouds[2]


def test_native_file_names(tmp_path):
    from aicp_mapping_tpu import native as jnative

    from aicp_mapping_tpu_torch import native

    pts = _cloud(300, seed=8)
    for mode in (False, True, "compressed"):
        p = str(tmp_path / f"c_{mode}.pcd")
        native.write_pcd(p, pts, viewpoint=(1, 2, 3, 1, 0, 0, 0),
                         binary=mode)
        got, vp = native.read_cloud(p)
        want, jvp = jnative.read_cloud(p)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(vp, jvp)
        if mode:
            np.testing.assert_array_equal(got, pts)


def test_2d_registration_recovers_pose():
    """tests/test_chain.py::test_2d_registration_recovers_pose through the
    port's own planar IO and configs/icp/icp_2d_testing.yaml: the relative
    pose recovered as JAX's test asserts, and within 2 mm / 0.05 deg of
    JAX's T. The room slides along a wall, so point-to-point ICP creeps by
    under min_diff_trans (0.1 mm) an iteration before it stops: the two
    packages stop 8 iterations apart (64 and 56) and 1.1 mm apart, both
    within 1.5 mm of the true pose; 2 mm is 20 such steps."""
    from aicp_mapping_tpu.pipeline.config import \
        load_icp_chain_yaml as jload
    from aicp_mapping_tpu.registration import point_to_plane_icp as jicp

    from aicp_mapping_tpu_torch.pipeline.config import load_icp_chain_yaml
    from aicp_mapping_tpu_torch.registration import point_to_plane_icp

    pose_b = (0.25, -0.15, 0.06)
    ref2d = planar.synthetic_room_scan((0.0, 0.0, 0.0), n_beams=720, seed=0)
    read2d = planar.synthetic_room_scan(pose_b, n_beams=720, seed=1)
    yaml = os.path.join(ROOT, "configs", "icp", "icp_2d_testing.yaml")
    cfg = load_icp_chain_yaml(yaml)[0]
    T_gt = np.eye(4, dtype=np.float32)
    c, s = np.cos(pose_b[2]), np.sin(pose_b[2])
    T_gt[:2, :2] = [[c, -s], [s, c]]
    T_gt[:2, 3] = pose_b[:2]

    def pad(pts):
        out = np.zeros((1024, 3), np.float32)
        out[:len(pts)] = pts
        return out, np.arange(1024) < len(pts)

    (rp, rm), (qp, qm) = (pad(planar.planar_to_cloud(ref2d)),
                          pad(planar.planar_to_cloud(read2d)))
    res = point_to_plane_icp(_t(qp), _t(qm), _t(rp), torch.zeros(1024, 3),
                             _t(rm), torch.eye(4),
                             torch.tensor(cfg.trim_ratio), cfg)
    T = res.T.numpy()
    assert np.linalg.norm(T[:3, 3] - T_gt[:3, 3]) < 0.03
    dR = T[:3, :3] @ T_gt[:3, :3].T
    assert np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1)) < 0.01
    jcfg = jload(yaml)[0]
    jres = jicp(jnp.asarray(qp), jnp.asarray(qm), jnp.asarray(rp),
                jnp.zeros((1024, 3)), jnp.asarray(rm), jse3.identity(),
                jnp.float32(jcfg.trim_ratio), jcfg)
    Tj = np.asarray(jres.T)
    assert np.linalg.norm(T[:3, 3] - Tj[:3, 3]) <= 2e-3
    assert float(jse3.rotation_angle_deg(jnp.asarray(Tj.T @ T))) <= 0.05
