"""Failure prediction in the port against the JAX package (CPU): kNN
normals and region growing given the same neighbours, FOV overlap,
alignability, the risk classifier, the ICP-chain filters, the App's risk
stage and its gated flow. Tolerances: the golden file's (tests/test_golden.py
TOLERANCES) end to end, tighter where the inputs are identical."""
import dataclasses
import importlib
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aicp_mapping_tpu.classification.classifier import \
    RiskClassifier as JaxClassifier
from aicp_mapping_tpu.cloud import AlignedCloud as JAC
from aicp_mapping_tpu.cloud import Cloud as JCloud
from aicp_mapping_tpu.overlap import alignability as jal
from aicp_mapping_tpu.overlap import fov as jfov
from aicp_mapping_tpu.pipeline import config as jconfig
from aicp_mapping_tpu.pipeline.app import App as JaxApp
from aicp_mapping_tpu.registration import chain as jchain
from aicp_mapping_tpu.tools.synthetic import corridor_cloud as jax_corridor
from aicp_mapping_tpu.tools.synthetic import room_cloud
from aicp_mapping_tpu_torch import (AlignedCloud, App, Cloud, PipelineConfig,
                                    convert)
from aicp_mapping_tpu_torch.classification import classifier as tclf
from aicp_mapping_tpu_torch.overlap import alignability as tal
from aicp_mapping_tpu_torch.overlap import fov as tfov
from aicp_mapping_tpu_torch.overlap import voxel_overlap as tvo
from aicp_mapping_tpu_torch.pipeline.sequence import synthetic_sequence
from aicp_mapping_tpu_torch.registration import chain as tchain
from aicp_mapping_tpu_torch.tools.synthetic import corridor_cloud
from test_golden import TOLERANCES, _load_golden, _result_lines

torch.set_num_threads(1)
ROOT = os.path.join(os.path.dirname(__file__), "..")
CLF_PATH = os.path.join(ROOT, "data", "classification", "risk_classifier.npz")
jknn = importlib.import_module("aicp_mapping_tpu.ops.knn")
jnormals = importlib.import_module("aicp_mapping_tpu.ops.normals")
jseg = importlib.import_module("aicp_mapping_tpu.ops.segmentation")
jvo = importlib.import_module("aicp_mapping_tpu.overlap.voxel_overlap")
tnormals = importlib.import_module("aicp_mapping_tpu_torch.ops.normals")
tseg = importlib.import_module("aicp_mapping_tpu_torch.ops.segmentation")


def T(a):
    return torch.as_tensor(np.array(a))


def _room(seed, n=2048, offset=(0.0, 0.0, 0.0)):
    pts = room_cloud(n=n * 6 // 5 + 12, size=10.0, seed=seed,
                     noise=0.01)[:n]
    return (pts + np.float32(offset)).astype(np.float32), \
        np.arange(n) < n - 100


@pytest.fixture(scope="module")
def graph():
    """A noisy room, JAX's 15-NN graph and JAX's normals from it."""
    p, m = _room(1)
    _, idx = jknn.knn(p, m, p, m, 15)
    idx = np.asarray(idx)
    vp = np.float32([0.0, 0.0, 1.5])
    n, c, _ = (np.asarray(a) for a in jnormals.normals_from_neighbors(
        p, m, idx, vp))
    return p, m, idx, vp, n, c


def test_corridor_cloud_matches_jax():
    np.testing.assert_array_equal(corridor_cloud(n=900, seed=3, noise=0.01),
                                  jax_corridor(n=900, seed=3, noise=0.01))


def test_normals_from_neighbors_matches_jax(graph):
    """Given JAX's neighbour indices: normals and curvature within 1e-4."""
    p, m, idx, vp, n, c = graph
    got_n, got_c, _ = tnormals.normals_from_neighbors(T(p), T(m), T(idx),
                                                      T(vp))
    np.testing.assert_allclose(got_n.numpy(), n, atol=1e-4)
    np.testing.assert_allclose(got_c.numpy(), c, atol=1e-4)
    en, ec, _ = tnormals.estimate_normals(T(p), T(m), 15, T(vp))
    agree = (np.abs(en.numpy() - n).max(1) <= 1e-4)[m]
    assert agree.mean() >= 0.99, agree.mean()


@pytest.mark.parametrize("min_size,clusters", [(20, 8), (1, 64)])
def test_region_growing_matches_jax(graph, min_size, clusters):
    """label_propagation_clusters, filter_small_clusters and compact_labels
    identical to JAX's given the same neighbours; the (1, 64) case has many
    equal-size clusters (singletons and pairs) to rank."""
    p, m, idx, vp, n, c = graph
    lj = np.asarray(jseg.label_propagation_clusters(p, m, n, c, k=15,
                                                    neighbor_idx=idx))
    tseg.reset_propagation_rounds()
    lt = tseg.label_propagation_clusters(T(p), T(m), T(n), T(c), k=15,
                                         neighbor_idx=T(idx))
    np.testing.assert_array_equal(lt.numpy(), lj)
    assert tseg.propagation_rounds()["rounds"] >= 2
    kj = np.asarray(jseg.filter_small_clusters(lj, m, min_size))
    kt = tseg.filter_small_clusters(lt, T(m), min_size)
    np.testing.assert_array_equal(kt.numpy(), kj)
    want = jseg.compact_labels(np.where(kj, lj, -1), kj, clusters)
    got = tseg.compact_labels(torch.where(kt, lt, -1), kt, clusters)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    sizes = np.asarray(want[2])
    assert len(set(sizes[sizes > 0])) < (sizes > 0).sum() or min_size > 1


def test_label_propagation_round_cap_matches_jax(graph):
    """A cap of 2 rounds stops both loops at the same labels."""
    p, m, idx, vp, n, c = graph
    lj = jseg.label_propagation_clusters(p, m, n, c, k=15, max_iters=2,
                                         neighbor_idx=idx, jumps_per_iter=1)
    lt = tseg.label_propagation_clusters(T(p), T(m), T(n), T(c), k=15,
                                         max_iters=2, neighbor_idx=T(idx),
                                         jumps_per_iter=1)
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))


def _poses():
    from aicp_mapping_tpu.geometry import se3 as jse3

    a = np.asarray(jse3.se3_exp(jnp.float32([0.5, -0.2, 0.1, 0, 0, 0.4])))
    b = np.asarray(jse3.se3_exp(jnp.float32([2.0, 1.0, 0.0, 0, 0.02, -1.0])))
    return a, b


@pytest.mark.parametrize("view,rng", [(360.0, 100.0), (270.0, 6.0)])
def test_fov_overlap_matches_jax(view, rng):
    pa, ma = _room(2)
    pb, mb = _room(3, offset=(1.0, 0.5, 0.0))
    a, b = _poses()
    want = jfov.fov_overlap(pa, ma, a, pb, mb, b, rng, view)
    got = tfov.fov_overlap(T(pa), T(ma), T(a), T(pb), T(mb), T(b), rng, view)
    assert abs(float(got[0]) - float(want[0])) <= 1e-4
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert 0.0 < float(got[0]) <= 100.0


def test_compute_overlap_matches_jax():
    pa, ma = _room(4)
    pb, mb = _room(5, offset=(0.3, 0.0, 0.0))
    want = jvo.compute_overlap(pa, ma, pb, mb)
    got = tvo.compute_overlap(T(pa), T(ma), T(pb), T(mb))
    assert float(got.overlap_percent) == pytest.approx(
        float(want.overlap_percent), abs=1e-4)
    for g, w in zip(got.loop_closure_tuple(), want.loop_closure_tuple()):
        assert float(g) == pytest.approx(float(w), abs=1e-4)


@pytest.mark.parametrize("shift,ds,clusters", [
    ((0.3, 0.1, 0.0), 1024, 8), ((2.0, -1.0, 0.0), 2048, 16)])
def test_alignability_matches_jax(shift, ds, clusters):
    """Golden-size clouds (2,048 points of two scans of a room): within the
    golden tolerance 5.0; a degenerate corridor pair scores near 0."""
    pa, ma = _room(6)
    pb, mb = _room(7, offset=shift)
    eye = np.eye(4, dtype=np.float32)
    want, _ = jal.alignability_filter(pa, ma, eye, pb, mb, eye,
                                      ds_capacity=ds, max_clusters=clusters)
    got, diag = tal.alignability_filter(T(pa), T(ma), T(eye), T(pb), T(mb),
                                        T(eye), ds_capacity=ds,
                                        max_clusters=clusters)
    assert abs(float(got) - float(want)) <= TOLERANCES["alignability"]
    assert diag["box_overlap"].shape == (clusters, clusters)
    c = corridor_cloud(n=2048, seed=1, noise=0.01)
    cm = np.ones(len(c), bool)
    deg, _ = tal.alignability_filter(T(c), T(cm), T(eye), T(c), T(cm),
                                     T(eye), ds_capacity=ds,
                                     max_clusters=clusters)
    assert float(deg) < 1.0


def test_classifier_matches_jax(tmp_path):
    """poly3_features and test() on the shipped model within 1e-5; save /
    load and the convert round trip."""
    jclf = JaxClassifier()
    jclf.load(CLF_PATH)
    clf = tclf.RiskClassifier()
    clf.load(CLF_PATH)
    rng = np.random.default_rng(0)
    x = np.stack([rng.uniform(0, 100, 200), rng.uniform(0, 60, 200)],
                 1).astype(np.float32)
    from aicp_mapping_tpu.classification.classifier import poly3_features

    np.testing.assert_allclose(tclf.poly3_features(T(x)).numpy(),
                               np.asarray(poly3_features(x)), rtol=1e-5)
    np.testing.assert_allclose(clf.test(x).numpy(),
                               np.asarray(jclf.test(x)), atol=1e-5)
    labels = (rng.uniform(size=200) > 0.5).astype(np.float32)
    assert clf.test(x, labels)[1] == jclf.test(x, labels)[1]
    clf.save(str(tmp_path / "m.npz"))
    again = tclf.RiskClassifier()
    again.load(str(tmp_path / "m.npz"))
    np.testing.assert_array_equal(again.test(x).numpy(), clf.test(x).numpy())
    moved = convert.classifier_from_numpy(**convert.classifier_to_numpy(jclf))
    np.testing.assert_allclose(moved.test(x).numpy(),
                               np.asarray(jclf.test(x)), atol=1e-5)
    assert moved.threshold == jclf.threshold
    # training is ported (tests/test_torch_classifier_train.py holds it to
    # JAX's); it runs on the classifier's device, the card by default
    trained = tclf.RiskClassifier(device="cpu")
    trained.train(x, labels, steps=50)
    assert trained.test(x).shape == (200,)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            clf.train(x, labels)


def test_load_label_file_matches_jax():
    from aicp_mapping_tpu.classification.classifier import load_label_file

    path = os.path.join(ROOT, "data", "labels", "testing_synthetic.txt")
    for a, b in zip(tclf.load_label_file(path), load_label_file(path)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n", [1, 7, 4096, 65536])
@pytest.mark.parametrize("seed", [0, 4, 12345])
def test_jax_uniform_draws_bit_for_bit(seed, n):
    """`jax_uniform` is `jax.random.uniform(PRNGKey(seed), (n,))` to the
    bit (threefry2x32, the random-sampling filter's draws)."""
    import jax

    want = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), (n,)))
    got = tchain.jax_uniform(seed, n).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_chain_filters_match_jax():
    """Every filter, the random one included, keeps exactly JAX's points."""
    p, m = _room(8, n=4096, offset=(1.0, 2.0, 0.0))
    origin = np.float32([0.5, 1.0, 0.3])
    for cfg in (jchain.ChainFilterConfig(min_dist=2.0),
                jchain.ChainFilterConfig(max_dist=5.5),
                jchain.ChainFilterConfig(max_density_cell=0.3),
                jchain.ChainFilterConfig(min_dist=1.0, max_dist=6.0,
                                         max_density_cell=0.25)):
        want = np.asarray(jchain.apply_chain_filters(p, m, origin, cfg))
        got = tchain.apply_chain_filters(
            T(p), T(m), T(origin),
            tchain.ChainFilterConfig(**dataclasses.asdict(cfg))).numpy()
        np.testing.assert_array_equal(got, want)
        assert 0 < got.sum() < m.sum()
    prob = 0.3
    kept = tchain.random_sampling_filter(T(m), prob, seed=4).numpy()
    np.testing.assert_array_equal(
        kept, np.asarray(jchain.random_sampling_filter(m, prob, seed=4)))
    assert not kept[~m].any() and 0 < kept.sum() < m.sum()
    cfg = jchain.ChainFilterConfig(min_dist=1.0, random_sampling_prob=0.05)
    want = np.asarray(jchain.apply_chain_filters(p, m, origin, cfg, seed=7))
    got = tchain.apply_chain_filters(
        T(p), T(m), T(origin),
        tchain.ChainFilterConfig(**dataclasses.asdict(cfg)), seed=7).numpy()
    np.testing.assert_array_equal(got, want)


def test_load_icp_chain_yaml_matches_jax():
    from aicp_mapping_tpu_torch.pipeline.config import load_icp_chain_yaml

    for name in ("besl92_pt2point.yaml", "icp_3d_trimmed.yaml",
                 "icp_autotuned_default.yaml"):
        path = os.path.join(ROOT, "configs", "icp", name)
        got = load_icp_chain_yaml(path)
        want = jconfig.load_icp_chain_yaml(path)
        for g, w in zip(got, want):
            assert dataclasses.asdict(g) == dataclasses.asdict(w), name


def _risk_gated_items(package_corridor):
    """tests/test_golden.py::_run_risk_gated's frames."""
    items, _ = synthetic_sequence(n_frames=7, n_points=5000, seed=11)
    bad = package_corridor(n=5000, seed=3, noise=0.01) + np.array(
        [60.0, 60.0, 0.0], np.float32)
    items[4] = (items[4][0], bad.astype(np.float32), items[4][2])
    return items


def _risk_cfg(cls):
    return cls(raw_capacity=8192, downsample_capacity=4096,
               filtered_capacity=2048, min_cluster_size=20,
               failure_prediction_mode=True, align_ds_capacity=1024,
               align_max_clusters=8)


def test_risk_stage_matches_jax_on_the_risk_gated_scenario():
    """The JAX App runs tests/test_golden.py's risk_gated scenario; at every
    frame the port's risk stage (FOV overlap -> alignability ->
    classifier -> risk gate) on that frame's reference and filtered reading
    gives JAX's fov (1e-4), alignability (5.0), risk (0.1) and gate."""
    from aicp_mapping_tpu_torch.pipeline.fused import risk_stage

    jclf = JaxClassifier(threshold=0.5)
    jclf.load(CLF_PATH)
    cfg = _risk_cfg(jconfig.PipelineConfig)
    japp = JaxApp(cfg, classifier=jclf)
    seen = []
    step = japp._app_step

    def recording(*args):
        out = step(*args)
        seen.append((args, out))
        return out

    japp._app_step = recording
    for u, p, pose in _risk_gated_items(jax_corridor):
        japp.process_cloud(JAC.create(u, JCloud.from_numpy(
            p, capacity=cfg.raw_capacity), pose))
    assert len(seen) == 6
    tcfg = convert.config_from_dict(dataclasses.asdict(cfg))
    clf = convert.classifier_from_numpy(**convert.classifier_to_numpy(jclf))
    gates = []
    for args, want in seen:
        _, _, odom, _, rp, _, rm, rpose = args[:8]
        fov, align, risk, ok = risk_stage(
            tcfg, T(rp), T(rm), T(rpose), T(want.filtered_points),
            T(want.filtered_mask), T(odom), T(want.overlap_percent),
            clf.model)
        assert abs(float(fov) - float(want.fov_overlap)) <= 1e-4
        assert abs(float(align) - float(want.alignability)) \
            <= TOLERANCES["alignability"]
        assert abs(float(risk) - float(want.risk)) <= TOLERANCES["risk"]
        assert bool(ok) == bool(want.risk_ok)
        gates.append(bool(ok))
    assert gates == [False, True, False, False, False, True]


def test_app_risk_gated_scenario():
    """The port's App on the risk_gated scenario: the degenerate corridor
    frame and every frame the golden file gates are risk-gated (accepted,
    identity correction, not registered), the gated frame becomes the next
    frame's reference, and fov / octree overlap stay within the golden
    tolerances where the reference is the golden one. The room frames 2
    and 6, which JAX registers with an alignability of 9.6 and 12.2, are
    gated here too: the port's prefilter keeps another 2,048 of the ~3,000
    plane points (ROADMAP Q3), and JAX's own alignability of the port's
    filtered reading of frame 2 is 0.14 as well."""
    golden = _load_golden()["risk_gated"]
    clf = tclf.RiskClassifier(threshold=0.5)
    clf.load(CLF_PATH)
    cfg = _risk_cfg(PipelineConfig)
    app = App(cfg, device="cpu", classifier=clf)
    frames = [app.process_cloud(AlignedCloud.create(u, Cloud.from_numpy(
        p, capacity=cfg.raw_capacity), pose))
        for u, p, pose in _risk_gated_items(corridor_cloud)]
    got = _result_lines(frames)
    for i, (g, w) in enumerate(zip(got, golden)):
        assert g["accepted"] and g["reading_id"] == w["reading_id"]
        if not w["registered"]:
            assert not g["registered"], i
        if not g["registered"]:
            np.testing.assert_array_equal(g["correction_t"], 0.0)
            if i + 1 < len(got):
                assert got[i + 1]["reference_id"] == i
        for key in ("fov_overlap", "octree_overlap"):
            if w[key] < 0:
                assert g[key] < 0
            elif g["reference_id"] == w["reference_id"]:
                assert abs(g[key] - w[key]) <= TOLERANCES[key], (i, key)
    assert got[4]["octree_overlap"] == 0.0 and got[4]["risk"] > 0.99


def _planar_lift(name):
    """tests/test_golden_real_scans.py::_load_scan on the repo's scans."""
    from aicp_mapping_tpu.io.planar import read_planar_csv

    pts2 = read_planar_csv(os.path.join(ROOT, "data", name))
    levels = np.linspace(-0.3, 0.3, 9, dtype=np.float32)
    out = np.empty((len(pts2) * len(levels), 3), np.float32)
    for i, z in enumerate(levels):
        out[i * len(pts2):(i + 1) * len(pts2), :2] = pts2
        out[i * len(pts2):(i + 1) * len(pts2), 2] = z
    return out


def test_real_scan_risk_gate_fires_in_both_packages():
    """The gated real-scan flow of tests/test_golden_real_scans.py on the
    repo's data/scan_00.csv / scan_01.csv at the deployed threshold 0.5:
    both packages gate the same frames (odometry passthrough, forced
    reference update) and agree on overlap, fov, alignability and risk."""
    from aicp_mapping_tpu.geometry import se3 as jse3

    pert = np.asarray(jse3.make_transform(
        jse3.so3_exp(jnp.array([0.0, 0.0, np.deg2rad(4.0)])),
        jnp.array([0.08, -0.05, 0.0])), np.float32)
    s0, s1 = _planar_lift("scan_00.csv"), _planar_lift("scan_01.csv")
    eye = np.eye(4, dtype=np.float32)
    items = [(0, s0, eye),
             (1_000_000, (s0 @ pert[:3, :3].T + pert[:3, 3]).astype(
                 np.float32), pert),
             (2_000_000, s1, eye)]
    kw = dict(raw_capacity=32768, downsample_capacity=8192,
              filtered_capacity=4096, min_cluster_size=20,
              failure_prediction_mode=True, align_ds_capacity=1024,
              align_max_clusters=16, max_correction_magnitude=1.0,
              sensor_range=30.0, risk_threshold=0.5,
              reference_update_frequency=100)
    jcfg = jconfig.PipelineConfig(**kw)
    jcfg.icp = dataclasses.replace(jcfg.icp, degeneracy_threshold=30.0)
    jclf = JaxClassifier(threshold=0.5)
    jclf.load(CLF_PATH)
    japp = JaxApp(jcfg, classifier=jclf)
    app = App(convert.config_from_dict(dataclasses.asdict(jcfg)),
              device="cpu", classifier=convert.classifier_from_numpy(
                  **convert.classifier_to_numpy(jclf)))
    want = [japp.process_cloud(JAC.create(u, JCloud.from_numpy(
        p, capacity=jcfg.raw_capacity), pose)) for u, p, pose in items]
    got = [app.process_cloud(AlignedCloud.create(u, Cloud.from_numpy(
        p, capacity=jcfg.raw_capacity), pose)) for u, p, pose in items]
    assert [g.registered for g in got] == [w.registered for w in want]
    assert not got[1].registered and got[1].risk > 0.5
    np.testing.assert_allclose(got[1].corrected_pose, pert, atol=1e-5)
    assert app.graph.current_reference_id == \
        japp.graph.current_reference_id
    for g, w in zip(got[1:], want[1:]):
        assert g.reference_id == w.reference_id
        for key in ("octree_overlap", "fov_overlap", "alignability",
                    "risk"):
            assert abs(getattr(g, key) - getattr(w, key)) \
                <= TOLERANCES[key], key
