"""The KITTI odometry path of the port against the JAX package (CPU): the
devkit metrics, the urban drive and OXTS poses, `run_kitti_sequence` with
and without ground removal, and the new CLI commands' JSON summaries."""
import json
import os

import numpy as np
import pytest
import torch

from aicp_mapping_tpu import cli as jcli
from aicp_mapping_tpu.eval import kitti as jkitti
from aicp_mapping_tpu.eval.kitti_runner import run_kitti_sequence as j_run
from aicp_mapping_tpu.io import oxts as joxts
from aicp_mapping_tpu.pipeline.config import PipelineConfig as JConfig
from aicp_mapping_tpu.pipeline.sequence import synthetic_sequence
from aicp_mapping_tpu.tools import synthetic as jsynth
from aicp_mapping_tpu.tools import urban as jurban
from aicp_mapping_tpu_torch import cli
from aicp_mapping_tpu_torch.eval import kitti
from aicp_mapping_tpu_torch.eval.kitti_runner import (kitti_config,
                                                      run_kitti_sequence)
from aicp_mapping_tpu_torch.io import oxts
from aicp_mapping_tpu_torch.io.pcd import read_cloud, write_pcd
from aicp_mapping_tpu_torch.io.poses import write_kitti_poses
from aicp_mapping_tpu_torch.pipeline.config import PipelineConfig
from aicp_mapping_tpu_torch.tools import synthetic, urban

torch.set_num_threads(1)
ROOT = os.path.join(os.path.dirname(__file__), "..")
# m, runner poses port vs JAX: the two prefilters keep other subsets of
# the scene's plane points (hough output order under rounding, ROADMAP Q3),
# which moves single frames' corrections by up to 4 mm on this scene
TOL_POSE = 1e-2
TOL_OVERLAP = 2.0   # %, the golden file's
SCENE_CFG = dict(raw_capacity=8192, downsample_capacity=4096,
                 filtered_capacity=2048, min_cluster_size=20,
                 max_correction_magnitude=2.0, trim_ratio_floor=0.50)


def _random_drive(seed: int, n: int = 260) -> tuple:
    """A random planar drive (~1.1 m a frame, slow yaw) and a noisy estimate
    of it, float64 poses."""
    rng = np.random.default_rng(seed)
    gt, est = [np.eye(4)], [np.eye(4)]
    for _ in range(n - 1):
        yaw = rng.normal(0, 0.02)
        step = np.eye(4)
        step[:2, :2] = [[np.cos(yaw), -np.sin(yaw)], [np.sin(yaw),
                                                      np.cos(yaw)]]
        step[:3, 3] = [1.1 + rng.normal(0, 0.1), rng.normal(0, 0.05),
                       rng.normal(0, 0.01)]
        noise = np.eye(4)
        e = rng.normal(0, 0.003)
        noise[:2, :2] = [[np.cos(e), -np.sin(e)], [np.sin(e), np.cos(e)]]
        noise[:3, 3] = rng.normal(0, 0.02, 3)
        gt.append(gt[-1] @ step)
        est.append(est[-1] @ step @ noise)
    return np.stack(gt), np.stack(est)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_devkit_metrics_equal_jax(seed):
    gt, est = _random_drive(seed)
    np.testing.assert_allclose(kitti.trajectory_distances(gt),
                               jkitti.trajectory_distances(gt), atol=1e-12)
    for lengths in (kitti.LENGTHS, (50, 100, 150, 200)):
        got = kitti.calc_sequence_errors(gt, est, lengths=lengths)
        want = jkitti.calc_sequence_errors(gt, est, lengths=lengths)
        assert len(got) == len(want) > 0
        for a, b in zip(got, want):
            assert (a.first_frame, a.length) == (b.first_frame, b.length)
            np.testing.assert_allclose([a.r_err, a.t_err, a.speed],
                                       [b.r_err, b.t_err, b.speed],
                                       rtol=0, atol=1e-12)
        ga, wa = kitti.average_errors(got), jkitti.average_errors(want)
        assert ga.keys() == wa.keys()
        for k in ga:
            assert ga[k] == pytest.approx(wa[k], abs=1e-12)
    for delta in (1, 10):
        g, w = kitti.rpe(gt, est, delta), jkitti.rpe(gt, est, delta)
        assert g.keys() == w.keys()
        for k in g:
            assert g[k] == pytest.approx(w[k], abs=1e-12)
    for align in (True, False):
        assert kitti.ate_rmse(gt, est, align) == pytest.approx(
            jkitti.ate_rmse(gt, est, align), abs=1e-12)
    assert kitti.average_errors([])["n_segments"] == 0


def test_urban_sequence_and_drive_equal_jax():
    world = urban.make_urban_world(seed=3)
    np.testing.assert_array_equal(
        urban.drive_trajectory(30, world, speed=10.0, seed=3),
        jurban.drive_trajectory(30, jurban.make_urban_world(seed=3),
                                speed=10.0, seed=3))
    kw = dict(n_frames=3, seed=1, n_azimuth=256, n_points_cap=5000)
    items, gt = urban.urban_sequence(**kw)
    j_items, j_gt = jurban.urban_sequence(**kw)
    np.testing.assert_array_equal(gt, j_gt)
    for (u, pts, pose), (ju, jpts, jpose) in zip(items, j_items):
        assert u == ju
        np.testing.assert_array_equal(pts, jpts)
        np.testing.assert_array_equal(pose, jpose)


def test_oxts_poses_and_cube_equal_jax(tmp_path):
    rng = np.random.default_rng(0)
    rec = np.zeros((6, 30))
    rec[:, 0] = 49.0 + np.cumsum(rng.normal(0, 1e-5, 6))
    rec[:, 1] = 8.4 + np.cumsum(rng.normal(0, 1e-5, 6))
    rec[:, 2] = 110.0 + rng.normal(0, 0.1, 6)
    rec[:, 3:6] = rng.normal(0, 0.05, (6, 3))
    np.testing.assert_array_equal(oxts.oxts_records_to_poses(rec),
                                  joxts.oxts_records_to_poses(rec))
    assert oxts.lat_to_scale(49.0) == joxts.lat_to_scale(49.0)
    d = tmp_path / "oxts" / "data"
    d.mkdir(parents=True)
    for i, r in enumerate(rec):
        np.savetxt(str(d / f"{i:010d}.txt"), r[None])
    np.testing.assert_array_equal(
        oxts.read_oxts_directory(str(tmp_path / "oxts")),
        joxts.read_oxts_directory(str(tmp_path / "oxts")))
    np.testing.assert_array_equal(
        synthetic.cube_cloud(n_per_face=50, seed=4, noise=0.01),
        jsynth.cube_cloud(n_per_face=50, seed=4, noise=0.01))


@pytest.fixture(scope="module")
def scan_dir(tmp_path_factory):
    """The 5-scan KITTI-layout scene of tests/test_eval.py's runner test:
    sensor-frame scans with an intensity column, and the ground truth."""
    items, gt = synthetic_sequence(n_frames=5, n_points=5000, step=1.0,
                                   seed=4, drift_per_frame=0.0,
                                   drift_yaw_deg=0.0)
    d = tmp_path_factory.mktemp("velodyne")
    for i, (_utime, pts_odom, pose) in enumerate(items):
        local = (pts_odom - pose[:3, 3]) @ pose[:3, :3]
        raw = np.concatenate([local, np.zeros((len(local), 1))], axis=1)
        raw.astype(np.float32).tofile(str(d / f"{i:06d}.bin"))
    rel = np.linalg.inv(gt[0])[None] @ np.asarray(gt)
    write_kitti_poses(str(d / "gt.txt"), rel.astype(np.float32))
    return str(d), np.asarray(gt)


@pytest.mark.parametrize("remove_ground", [False, True])
def test_run_kitti_sequence_matches_jax(scan_dir, remove_ground):
    d, gt = scan_dir
    traj, results, app = run_kitti_sequence(
        d, config=PipelineConfig(**SCENE_CFG), remove_ground=remove_ground,
        device="cpu")
    j_traj, j_results, _ = j_run(d, config=JConfig(**SCENE_CFG),
                                 remove_ground=remove_ground)
    assert traj.shape == j_traj.shape == (5, 4, 4)
    for r, jr in zip(results, j_results):
        assert (r.accepted, r.registered) == (jr.accepted, jr.registered)
        assert r.reference_id == jr.reference_id
        assert r.filtered_size == jr.filtered_size
        assert abs(r.octree_overlap - jr.octree_overlap) <= TOL_OVERLAP
    np.testing.assert_allclose(traj[:, :3, 3], j_traj[:, :3, 3],
                               atol=TOL_POSE)
    np.testing.assert_allclose(traj[:, :3, :3], j_traj[:, :3, :3],
                               atol=TOL_POSE)
    # the test_eval.py assertion: the relative motion within 0.5 m
    rel_est = np.linalg.inv(traj[0]) @ traj[-1]
    rel_gt = np.linalg.inv(gt[0]) @ gt[-1]
    assert np.linalg.norm(rel_est[:3, 3] - rel_gt[:3, 3]) < 0.5
    assert app.device.type == "cpu"


def test_kitti_defaults_and_device():
    cfg = kitti_config()
    assert (cfg.raw_capacity, cfg.downsample_capacity,
            cfg.filtered_capacity) == (131072, 32768, 16384)
    assert cfg.sensor_range == 80.0 and cfg.icp.trim_normal_space
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            run_kitti_sequence(".")


def _json(main, argv, capsys):
    assert main(argv) == 0
    return json.loads(capsys.readouterr().out)


def test_cli_kitti_run_and_eval_match_jax(scan_dir, tmp_path, capsys):
    d, _ = scan_dir
    yaml = tmp_path / "kitti.yaml"
    yaml.write_text("AICP:\n  Pipeline:\n    rawCapacity: 8192\n"
                    "    downsampleCapacity: 4096\n"
                    "    filteredCapacity: 2048\n    minClusterSize: 20\n")
    gt = os.path.join(d, "gt.txt")
    outs = {}
    for name, main, extra in (("port", cli.main, ["--device", "cpu"]),
                              ("jax", jcli.main, [])):
        out = str(tmp_path / f"{name}.txt")
        outs[name] = out
        argv = ["kitti-run", d, "-o", out, "--config", str(yaml),
                "--ground-truth", gt, "--remove-ground"] + extra
        outs[name + "_json"] = _json(main, argv, capsys)
    got, want = outs["port_json"], outs["jax_json"]
    assert got.keys() == want.keys()
    for k in ("frames", "registered", "accepted", "n_segments"):
        assert got[k] == want[k], k
    assert got["ate_rmse"] == pytest.approx(want["ate_rmse"], abs=TOL_POSE)

    # kitti-eval: the port reports rpe's numbers where JAX's command
    # unpacks rpe's dict into its key strings (a reference fault)
    for align in ([], ["--align"]):
        argv = ["kitti-eval", gt, outs["port"]] + align
        got = _json(cli.main, argv, capsys)
        want = _json(jcli.main, argv, capsys)
        assert got.keys() == want.keys()
        assert (want["rpe_trans"], want["rpe_rot"]) == (
            "rpe_trans_rmse_m", "rpe_rot_rmse_deg")
        from aicp_mapping_tpu_torch.io.poses import read_kitti_poses
        r = kitti.rpe(read_kitti_poses(gt), read_kitti_poses(outs["port"]))
        assert got["rpe_trans"] == r["rpe_trans_rmse_m"]
        assert got["rpe_rot"] == r["rpe_rot_rmse_deg"]
        for k in ("ate_rmse", "n_segments"):
            assert got[k] == pytest.approx(want[k], abs=1e-12), k
    # --plot: both commands draw the same pictures, pixel for pixel
    import matplotlib.image as mpimg
    pngs = {}
    for name, main in (("port", cli.main), ("jax", jcli.main)):
        pngs[name] = str(tmp_path / f"{name}_plot.png")
        argv = ["kitti-eval", gt, outs["port"], "--plot", pngs[name]]
        assert _json(main, argv, capsys)["plot"] == pngs[name]
    for suffix in ("", "_err"):
        got, want = (pngs[k].replace(".png", suffix + ".png")
                     for k in ("port", "jax"))
        assert os.path.exists(got) == os.path.exists(want)
        if os.path.exists(want):
            np.testing.assert_array_equal(mpimg.imread(got),
                                          mpimg.imread(want))
    assert os.path.exists(pngs["port"])


def _ground_scene(seed=0):
    """tests/test_tools.py's scene: flat ground and two boxes on it."""
    rng = np.random.default_rng(seed)
    ground = np.column_stack([
        rng.uniform(-20, 20, 4000), rng.uniform(-20, 20, 4000),
        rng.normal(0, 0.02, 4000)]).astype(np.float32)
    box1 = np.column_stack([
        rng.uniform(2, 4, 800), rng.uniform(2, 4, 800),
        rng.uniform(0.5, 2.5, 800)]).astype(np.float32)
    box2 = np.column_stack([
        rng.uniform(-8, -6, 800), rng.uniform(1, 3, 800),
        rng.uniform(0.5, 3.5, 800)]).astype(np.float32)
    return np.concatenate([ground, box1, box2])


def test_cli_cloud_commands_match_jax(tmp_path, capsys):
    """make-cube, concat (with and without a voxel grid), overlap,
    remove-ground and oxts-to-kitti: the same JSON, the same clouds."""
    for name, main in (("port", cli.main), ("jax", jcli.main)):
        dev = ["--device", "cpu"] if name == "port" else []
        cube = str(tmp_path / f"{name}_cube.pcd")
        got = _json(main, ["make-cube", cube, "--n-per-face", "100",
                           "--seed", "3"], capsys)
        assert got == {"points": 600, "output": cube}
        merged = str(tmp_path / f"{name}_merged.pcd")
        assert _json(main, ["concat", merged, cube, cube], capsys) == {
            "points": 1200, "output": merged}
        vox = str(tmp_path / f"{name}_vox.pcd")
        got = _json(main, ["concat", vox, cube, cube, "--voxel", "0.5"],
                    capsys)
        assert got["points"] == len(read_cloud(vox)[0])
    np.testing.assert_array_equal(
        read_cloud(str(tmp_path / "port_cube.pcd"))[0],
        read_cloud(str(tmp_path / "jax_cube.pcd"))[0])
    np.testing.assert_array_equal(
        read_cloud(str(tmp_path / "port_vox.pcd"))[0],
        read_cloud(str(tmp_path / "jax_vox.pcd"))[0])

    a = synthetic.room_cloud(n=3000, seed=0, noise=0.01)
    b = a + np.float32([0.3, 0.0, 0.0])
    write_pcd(str(tmp_path / "a.pcd"), a)
    write_pcd(str(tmp_path / "b.pcd"), b)
    argv = ["overlap", str(tmp_path / "a.pcd"), str(tmp_path / "b.pcd")]
    got = _json(cli.main, argv + ["--device", "cpu"], capsys)
    want = _json(jcli.main, argv, capsys)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-4), k

    write_pcd(str(tmp_path / "scene.pcd"), _ground_scene())
    for name, main, extra in (("port", cli.main, ["--device", "cpu"]),
                              ("jax", jcli.main, [])):
        argv = ["remove-ground", "-i", str(tmp_path / "scene.pcd"),
                "-o", str(tmp_path / f"{name}_obj.pcd"),
                "--ground-out", str(tmp_path / f"{name}_gnd.pcd"),
                "--cell-size", "0.5"] + extra
        if name == "port":
            got = _json(main, argv, capsys)
        else:
            want = _json(main, argv, capsys)
    assert got == want
    for part in ("obj", "gnd"):
        np.testing.assert_array_equal(
            read_cloud(str(tmp_path / f"port_{part}.pcd"))[0],
            read_cloud(str(tmp_path / f"jax_{part}.pcd"))[0])

    rec = np.zeros((4, 30))
    rec[:, 0] = 49.0 + np.arange(4) * 1e-5
    rec[:, 1] = 8.4 + np.arange(4) * 2e-5
    d = tmp_path / "oxts"
    d.mkdir()
    for i, r in enumerate(rec):
        np.savetxt(str(d / f"{i:010d}.txt"), r[None])
    outs = [str(tmp_path / f"{n}_oxts.txt") for n in ("port", "jax")]
    got = _json(cli.main, ["oxts-to-kitti", str(d), "-o", outs[0]], capsys)
    want = _json(jcli.main, ["oxts-to-kitti", str(d), "-o", outs[1]], capsys)
    assert got["poses"] == want["poses"] == 4
    assert open(outs[0]).read() == open(outs[1]).read()


def test_write_kitti_drive_and_drive_errors(tmp_path):
    """The card phase's KITTI drive writer and error summary: the scans in
    the velodyne layout both packages read, the truth relative to the first
    frame; a trajectory on the truth has zero error, the prior chain's
    error is the priors' noise walk."""
    from aicp_mapping_tpu.native import read_cloud as j_read_cloud
    from aicp_mapping_tpu_torch.eval.kitti_runner import (drive_errors,
                                                          list_velodyne_scans)
    from aicp_mapping_tpu_torch.io.poses import read_kitti_poses
    from aicp_mapping_tpu_torch.tools.urban import write_kitti_drive

    scan_dir, gt_path, gt, priors = write_kitti_drive(
        str(tmp_path), 4, n_azimuth=128, cap=3000)
    paths = list_velodyne_scans(scan_dir)
    assert len(paths) == 4
    for p in paths:
        pts, _ = read_cloud(p)
        assert pts.shape == (3000, 3)
        np.testing.assert_array_equal(pts, j_read_cloud(p)[0])
    rel = read_kitti_poses(gt_path)
    np.testing.assert_allclose(rel[0], np.eye(4), atol=1e-6)
    np.testing.assert_allclose(rel[-1][:3, 3], [3.0, 0.0, 0.0], atol=1e-5)
    assert np.abs(priors[:, :2, 3] - gt[:, :2, 3]).max() > 0
    e = drive_errors(gt.astype(np.float32), gt, priors)
    assert e["ate_m"] == 0.0 and e["final_yaw_deg"] == 0.0
    assert e["prior_chain_ate_m"] > 0.05 and e["ratio"] == 0.0
