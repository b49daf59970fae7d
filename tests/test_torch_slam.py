"""The port's SLAM slice against the JAX package on the CPU, over
tests/test_mapper.py's 8-frame loop (seed 2, 45 deg/frame): the back-end
replayed on the keyframes JAX's front-end made (read from JAX's own
snapshot file), and the whole slice, App + SequenceRunner +
PoseGraphMapper, with the hough prefilter; and a recorded sequence
replayed from disk. The region-growing front-end and the `slam` CLI:
tests/test_torch_slam_cli.py."""
import dataclasses
import importlib.util
import os

import numpy as np
import pytest
import torch

from aicp_mapping_tpu.eval import slam_accuracy as jslam
from aicp_mapping_tpu.io import poses as jposes
from aicp_mapping_tpu.pipeline import App as JApp
from aicp_mapping_tpu.pipeline import SequenceRunner as JRunner
from aicp_mapping_tpu.pipeline import mapper as jmapper
from aicp_mapping_tpu_torch import convert
from aicp_mapping_tpu_torch.eval import slam_accuracy
from aicp_mapping_tpu_torch.parallel import build_plane_ba
from aicp_mapping_tpu_torch.pipeline import (App, SequenceRecorder,
                                             SequenceRunner,
                                             synthetic_sequence)
from aicp_mapping_tpu_torch.pipeline import mapper
from test_mapper import small_config
from test_torch_backend import _angle, _loop_graph, _pose_err

torch.set_num_threads(1)
# `near_gate` lives in chip_smoke.py, which holds the card's back-end to the
# CPU's with it
_spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(
    os.path.dirname(__file__), "..", "chip_smoke.py"))
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)
# Back-end replay tolerances: closure measurements (m, deg), poses (m);
# the whole slice's keyframe positions (m).
TOL_Z_T, TOL_Z_DEG, TOL_POSE = 0.02, 0.5, 0.02
TOL_KF = 0.05


def loop_items():
    return synthetic_sequence(n_frames=8, n_points=6000, seed=2,
                              yaw_rate_deg=45.0, step=1.2)


def port_config(method="hough"):
    cfg = convert.config_from_dict(dataclasses.asdict(small_config()))
    cfg.segmentation_method = method
    return cfg


def closure_residual(kfs, closures):
    """tests/test_mapper.py's measure: mean translation residual of the
    closure edges at the keyframes' poses."""
    errs = [np.linalg.norm((np.linalg.inv(lc.measurement) @ np.linalg.inv(
        kfs[lc.i].pose) @ kfs[lc.j].pose)[:3, 3]) for lc in closures]
    return float(np.mean(errs)) if errs else 0.0


def check_slice(app, results, japp, jresults):
    """The port's front-end against JAX's (which may have run only the first
    frames): the same accept and registered decisions, keyframes at the
    same frames within `TOL_KF`; then tests/test_mapper.py's assertion on
    the port's back-end over all its frames."""
    n = len(jresults)
    assert [(r.accepted, r.registered) for r in results[:n]] == \
        [(r.accepted, r.registered) for r in jresults]
    jkfs = jmapper.PoseGraphMapper(japp).keyframes()
    kfs = mapper.PoseGraphMapper(app).keyframes()[:len(jkfs)]
    assert len(jkfs) >= 3
    assert [k.utime for k in kfs] == [k.utime for k in jkfs]
    err = max(np.linalg.norm(a.pose[:3, 3] - b.pose[:3, 3])
              for a, b in zip(kfs, jkfs))
    assert err <= TOL_KF, err
    m = mapper.PoseGraphMapper(app, **MAPPER_KW)
    m.propose_loop_closures()
    assert len(m.loop_closures) >= 1
    res_pre = closure_residual(m.keyframes(), m.loop_closures)
    m.optimize()
    res_post = closure_residual(m.keyframes(), m.loop_closures)
    assert all(np.isfinite(k.pose).all() for k in m.keyframes())
    assert app.aligned_map_np.shape[0] > 0
    assert res_post <= res_pre + 1e-6, (res_pre, res_post)
    if res_pre > 0.005:
        assert res_post < 0.8 * res_pre, (res_pre, res_post)


MAPPER_KW = dict(min_keyframe_gap=1, min_loop_overlap=10.0,
                 max_loop_distance=30.0)


def _backend_rounds(m):
    """run_backend's sequence with tests/test_mapper.py's mapper: two
    rounds of proposal + PGO, then plane BA. Returns what each stage left."""
    out = {}
    for r in (1, 2):
        out[f"pre{r}"] = np.stack([k.pose for k in m.keyframes()])
        out[f"proposed{r}"] = list(m.propose_loop_closures())
        m.optimize()
        out[f"kept{r}"] = list(m.loop_closures)
        out[f"pgo{r}"] = np.stack([k.pose for k in m.keyframes()])
    m.run_plane_ba(gn_iters=4, min_points=30)
    out["ba"] = np.stack([k.pose for k in m.keyframes()])
    out["ba_summary"] = m.last_ba_summary
    return out


@pytest.fixture(scope="module")
def jax_snapshot(tmp_path_factory):
    """tests/test_mapper.py's 8-frame loop (seed 2, 45 deg/frame) through
    JAX's App, saved by JAX's `save_frontend_snapshot`, and JAX's back-end
    replayed on it."""
    items, gt = loop_items()
    app = JApp(small_config())
    results = JRunner(app).run_clouds(items)
    path = str(tmp_path_factory.mktemp("snap") / "frontend.npz")
    meta = {"n_frames": 8, "seed": 2, "ate_odometry_m": 0.0,
            "frames_accepted": 8, "frames_registered": 7}
    # ground truth by utime // 100_000, as the urban drive indexes it
    jslam.save_frontend_snapshot(app, np.repeat(gt, 10, axis=0), meta, path)
    japp, _, _ = jslam.load_frontend_snapshot(path)
    want = _backend_rounds(jmapper.PoseGraphMapper(japp, **MAPPER_KW))
    return path, want, app, results


def _same_closures(got, want, m, pre, post, what):
    g = {(lc.i, lc.j): lc for lc in got}
    w = {(lc.i, lc.j): lc for lc in want}
    for pair in set(g) ^ set(w):
        lc = g.get(pair) or w.get(pair)
        assert chip_smoke.near_gate(m, lc, pre, post), (what, pair, lc)
        print(f"{what}: closure {pair} sits at a gate edge: {lc}")
    assert set(g) & set(w), (what, set(g), set(w))
    for pair in set(g) & set(w):
        D = np.linalg.inv(w[pair].measurement) @ g[pair].measurement
        ang = np.degrees(_angle(D[:3, :3]))
        assert np.linalg.norm(D[:3, 3]) <= TOL_Z_T and ang <= TOL_Z_DEG, \
            (what, pair, D)


def test_backend_replayed_on_jax_keyframes(jax_snapshot):
    """The port's back-end on the keyframes JAX's front-end made, read from
    JAX's snapshot file: the same closures (a pair at a gate edge is
    printed, not failed), measurements within 2 cm / 0.5 deg, PGO and BA
    poses within 2 cm, the same BA verdict and landmark count."""
    path, want, _, _ = jax_snapshot
    app, _, meta = slam_accuracy.load_frontend_snapshot(path, device="cpu")
    assert meta["n_frames"] == 8
    m = mapper.PoseGraphMapper(app, **MAPPER_KW)
    kfs = m.keyframes()
    assert len(kfs) == 4
    mapper.reset_backend_counts()
    got = _backend_rounds(m)
    counts = mapper.backend_counts()
    for r in (1, 2):
        poses = got[f"pre{r}"], got[f"pgo{r}"]
        _same_closures(got[f"proposed{r}"], want[f"proposed{r}"], m, *poses,
                       f"round {r}")
        _same_closures(got[f"kept{r}"], want[f"kept{r}"], m, *poses,
                       f"round {r} after PGO")
        t_err, _ = _pose_err(got[f"pgo{r}"], want[f"pgo{r}"])
        assert t_err <= TOL_POSE, (r, t_err)
    t_err, _ = _pose_err(got["ba"], want["ba"])
    assert t_err <= TOL_POSE, t_err
    assert got["ba_summary"]["ran"] == want["ba_summary"]["ran"]
    assert got["ba_summary"].get("n_landmarks") == \
        want["ba_summary"].get("n_landmarks")
    # each ICP reads once, and nothing else reads per ICP iteration
    assert counts["icp_calls"] >= len(got["proposed1"]) + len(
        got["proposed2"])
    assert counts["host_reads"] <= 2 * counts["icp_calls"] + 30, counts
    # the state the mapper leaves, as numpy
    state = convert.mapper_state_to_numpy(m)
    assert len(state["keyframes"]) == 4
    assert [(c["i"], c["j"]) for c in state["loop_closures"]] == \
        [(lc.i, lc.j) for lc in m.loop_closures]
    assert state["last_ba_summary"] == got["ba_summary"]


def test_snapshot_round_trip(jax_snapshot, tmp_path):
    """The port writes JAX's layout: its snapshot of JAX's keyframes reads
    back in JAX bit for bit."""
    path = jax_snapshot[0]
    app, gt, meta = slam_accuracy.load_frontend_snapshot(path, device="cpu")
    mine = str(tmp_path / "port.npz")
    slam_accuracy.save_frontend_snapshot(app, gt, meta, mine)
    a, b = np.load(path), np.load(mine)
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    japp, _, _ = jslam.load_frontend_snapshot(mine)
    assert len(japp.graph.clouds) == len(app.graph.clouds)


def test_entry_points_need_a_card_or_cpu(jax_snapshot):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    path = jax_snapshot[0]
    g = _loop_graph()
    for call in (
            lambda: slam_accuracy.load_frontend_snapshot(path),
            lambda: slam_accuracy.run_backend_from_snapshot(path),
            lambda: slam_accuracy.run_slam_accuracy(n_frames=2),
            lambda: convert.pose_graph_from_numpy(**g),
            lambda: build_plane_ba(np.eye(4)[None], np.zeros((1, 1, 4)),
                                   np.ones((1, 1)), np.ones((1, 1), bool))):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    with pytest.raises(NotImplementedError, match="urban"):
        slam_accuracy.scenario_config(failure_prediction_mode=True)
    app, _, _ = slam_accuracy.load_frontend_snapshot(path, device="cpu")
    # a mapper over a mesh of one rank solves the PGO as the mapper
    # without one (the two-rank back-end: tests/test_torch_slam_cli.py)
    from aicp_mapping_tpu_torch.parallel import make_mesh

    plain = mapper.PoseGraphMapper(app)
    meshed = mapper.PoseGraphMapper(app, mesh=make_mesh(1, "graph",
                                                        device="cpu"))
    graph = plain.build_graph(plain.keyframes())
    assert torch.equal(meshed._solve_pgo(graph, 2)[0],
                       plain._solve_pgo(graph, 2)[0])
    assert os.path.exists(path)


def test_whole_slice_matches_jax(jax_snapshot):
    """App + SequenceRunner + PoseGraphMapper on the CPU with the hough
    prefilter, against JAX's run of the same loop."""
    _, _, japp, jresults = jax_snapshot
    items, _ = loop_items()
    app = App(port_config(), device="cpu")
    results = SequenceRunner(app).run_clouds(items)
    check_slice(app, results, japp, jresults)
    # the pipelined front-end (depth 4, async finalize) on the loop's
    # first frames: JAX's pipelined results equal its synchronous ones on
    # this nominal loop (tests/test_pipeline.py), and so do the port's
    cfg = dataclasses.replace(port_config(), pipeline_depth=4,
                              async_finalize=True)
    piped = App(cfg, device="cpu")
    pres = SequenceRunner(piped, pipelined=True).run_clouds(items[:5])
    piped.close()
    for a, b in zip(results[:5], pres):
        assert (a.accepted, a.registered, a.reference_id) == \
            (b.accepted, b.registered, b.reference_id)
        np.testing.assert_allclose(a.corrected_pose, b.corrected_pose,
                                   atol=1e-6, rtol=0)


def test_recorded_sequence_replays_from_disk(tmp_path):
    """SequenceRecorder writes the replayable layout (JAX reads its pose
    file); `run_directory` replays it, frame by frame, as `run_clouds` runs
    the same clouds."""
    items, _ = loop_items()
    items = items[:4]
    rec = SequenceRecorder(str(tmp_path))
    for utime, pts, pose in items:
        rec.record(utime, pts, pose)
    recorded = jposes.read_pose_csv(str(tmp_path / "aicp_input_poses.csv"))
    assert [p.utime for p in recorded] == [it[0] for it in items]
    for p, it in zip(recorded, items):
        np.testing.assert_allclose(p.pose, it[2], atol=1e-6)
    want = SequenceRunner(App(port_config(), device="cpu")).run_clouds(items)
    got = SequenceRunner(App(port_config(), device="cpu")).run_directory(
        str(tmp_path))
    assert [(r.accepted, r.registered) for r in got] == \
        [(r.accepted, r.registered) for r in want]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.corrected_pose, b.corrected_pose,
                                   atol=1e-3)


def test_near_gate(jax_snapshot):
    """A closure at the prior with rms and overlap far from their gates is
    not at a gate edge; one within rounding of the rms or overlap gate
    is."""
    app, _, _ = slam_accuracy.load_frontend_snapshot(jax_snapshot[0],
                                                     device="cpu")
    m = mapper.PoseGraphMapper(app, **MAPPER_KW)
    pre = np.stack([k.pose for k in m.keyframes()])
    Z = (np.linalg.inv(pre[0]) @ pre[2]).astype(np.float32)
    lc = mapper.LoopClosure(0, 2, Z, 50.0, 0.05)
    assert not chip_smoke.near_gate(m, lc, pre, pre)
    for kw in (dict(inlier_rms=0.295), dict(overlap=10.5)):
        assert chip_smoke.near_gate(m, dataclasses.replace(lc, **kw), pre,
                                    pre)

