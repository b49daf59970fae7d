"""The port's pairwise experiments (`eval.experiment`) and the offline
analysis (`eval.analysis`) against the JAX package's (CPU)."""
import numpy as np
import pytest
import torch

from aicp_mapping_tpu.eval import analysis as janalysis
from aicp_mapping_tpu.eval import experiment as jexperiment
from aicp_mapping_tpu_torch.classification import RiskClassifier
from aicp_mapping_tpu_torch.eval import analysis, experiment
from aicp_mapping_tpu_torch.tools.synthetic import room_cloud

torch.set_num_threads(1)
CLF = "data/classification/risk_classifier.npz"
# pair metrics against JAX: overlap and FOV %, alignability 0-100, risk,
# |t| m (the golden file's; tests/test_torch_cli.py's `register`)
TOL = {"octree_overlap": 2.0, "fov_overlap": 2.0, "alignability": 5.0,
       "risk": 0.1, "t_error": 0.01}
# the ICP-Hessian predictors are eigenvalue ratios of the last iteration's
# inliers, which the trim quantile picks: relative tolerance
RTOL_PREDICTORS = 0.05


def _world_scene():
    """tests/test_eval.py's scene: 3 subsets of one room, identity poses."""
    world = room_cloud(n=4000, seed=6, noise=0.01)
    rng = np.random.default_rng(0)
    clouds = [world[rng.choice(len(world), 3000, replace=False)]
              for _ in range(3)]
    return clouds, [np.eye(4, dtype=np.float32)] * 3, 4096


def _shifted_scene():
    pts = room_cloud(n=2000, seed=0, noise=0.01)
    return [pts, pts + np.array([0.2, -0.1, 0.0], np.float32)], None, 2048


def _compare(got, want, predictors: bool = True):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.reference_id, g.reading_id) == (w.reference_id,
                                                  w.reading_id)
        for k, tol in TOL.items():
            a, b = getattr(g, k), getattr(w, k)
            if np.isnan(b):
                assert np.isnan(a), k
            else:
                assert abs(a - b) <= tol, (k, a, b)
        np.testing.assert_allclose(g.correction[:3, 3], w.correction[:3, 3],
                                   atol=0.01)
        for k in ("degeneracy", "icn") if predictors else ():
            assert getattr(g, k) == pytest.approx(
                getattr(w, k), rel=RTOL_PREDICTORS), k


@pytest.mark.parametrize("scene", [_world_scene, _shifted_scene])
def test_run_pairwise_matches_jax(scene, tmp_path):
    """The world-frame scene, and the shifted pair with the shipped risk
    classifier."""
    from aicp_mapping_tpu.classification import RiskClassifier as JClf

    clouds, poses, cap = scene()
    clf = jclf = None
    if poses is None:
        clf, jclf = RiskClassifier(), JClf()
        clf.load(CLF)
        jclf.load(CLF)
    got = experiment.run_pairwise(clouds, poses, capacity=cap,
                                  classifier=clf, device="cpu")
    want = jexperiment.run_pairwise(clouds, poses, capacity=cap,
                                    classifier=jclf)
    # The shifted pair is one cloud moved exactly: at convergence every
    # residual is rounding noise (~1e-8 m), so the trim keeps a subset that
    # rounding picks, and the Hessian predictors of that subset are only
    # held to their ranges (as tests/test_eval.py holds JAX's).
    _compare(got, want, predictors=poses is not None)
    if poses is not None:
        # tests/test_eval.py's assertions
        for r in got:
            assert r.octree_overlap > 50 and r.t_error < 0.05
        ov, terr = experiment.matrices(got, 3)
        assert np.isnan(np.diag(ov)).all() and np.nanmin(ov) > 50
        np.testing.assert_allclose(ov, jexperiment.matrices(want, 3)[0],
                                   atol=TOL["octree_overlap"])
    else:
        for r in got:
            assert 0 <= r.degeneracy <= 100 and 0 <= r.icn <= 1
            assert 0.0 <= r.risk <= 1.0
    out = tmp_path / "compare_results.txt"
    experiment.write_compare_results(str(out), got)
    rows = np.loadtxt(str(out), ndmin=2)
    assert rows.shape == (len(got), 24)
    np.testing.assert_array_equal(rows[:, :2], [[r.reference_id,
                                                 r.reading_id] for r in got])


def test_analysis_equals_jax():
    rng = np.random.default_rng(0)
    n = 200
    terr = rng.uniform(0, 0.06, n)
    failed = terr > 0.02
    risks = np.clip(failed * 0.7 + rng.normal(0, 0.15, n) + 0.15, 0, 1)
    deg = np.clip((~failed) * 40 + rng.normal(0, 10, n) + 5, 0, 100)
    assert analysis.confusion_stats(risks, failed) == \
        janalysis.confusion_stats(risks, failed)
    for fn in ("roc_curve", "f_scores"):
        for a, b in zip(getattr(analysis, fn)(risks, failed),
                        getattr(janalysis, fn)(risks, failed)):
            np.testing.assert_array_equal(a, b)
    assert analysis.risk_vs_degeneracy(risks, deg, terr) == \
        janalysis.risk_vs_degeneracy(risks, deg, terr)
    overlaps = rng.uniform(0, 100, n)
    assert analysis.accuracy_vs_overlap(overlaps, terr) == \
        janalysis.accuracy_vs_overlap(overlaps, terr)
    poses = np.tile(np.eye(4), (5, 1, 1))
    est = poses.copy()
    est[:, :3, 3] = rng.normal(0, 0.1, (5, 3))
    a, b = analysis.pose_errors(poses, est), janalysis.pose_errors(poses, est)
    for k in b:
        np.testing.assert_array_equal(a[k], b[k])
    assert analysis.correction_magnitudes(est) == \
        janalysis.correction_magnitudes(est)
    res = [experiment.PairResult(i, j, float(rng.uniform(0, 100)), 0.0, 0.0,
                                 -1.0, 3, 0.01, np.eye(4))
           for i in range(3) for j in range(3) if i != j]
    np.testing.assert_array_equal(analysis.overlap_matrix(res),
                                  janalysis.overlap_matrix(res))
