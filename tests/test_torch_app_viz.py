"""The port's App with visualizer sinks against the JAX App on the CPU:
the same publishes per hook (utimes, metric names, poses, map sizes) as
JAX's App with the same sink; results with a sink bit for bit the App's
without one, synchronous and pipelined with async finalize, publishes in
frame order; no device read per frame with the default sink; `timing`'s
sections (JAX's, renamed); `FileVisualizer` through the App; a checkpoint
loaded with a sink."""
import os

import numpy as np
import pytest
import torch

from aicp_mapping_tpu.pipeline import App as JaxApp
from aicp_mapping_tpu.pipeline import PipelineConfig as JaxConfig
from aicp_mapping_tpu.pipeline import SequenceRunner as JaxRunner
from aicp_mapping_tpu.pipeline.sequence import \
    synthetic_sequence as jax_sequence
from aicp_mapping_tpu.utils.visualizer import \
    RecordingVisualizer as JaxRecording
from aicp_mapping_tpu_torch import App, Cloud, PipelineConfig
from aicp_mapping_tpu_torch.pipeline import SequenceRunner
from aicp_mapping_tpu_torch.utils.visualizer import (FileVisualizer,
                                                     RecordingVisualizer)
from test_golden import TOLERANCES

torch.set_num_threads(1)

TOL_POSE_M = 0.05      # tests/test_golden.py's corrected_t
TOL_MAP_SHARE = 0.01   # the hough order is chaotic under rounding
POSE_HOOKS = ("poses", "prior_poses", "odom_poses", "odom_to_map")
METRIC_TOL = {"octree_overlap": TOLERANCES["octree_overlap"],
              "fov_overlap": TOLERANCES["fov_overlap"],
              "alignability": TOLERANCES["alignability"],
              "alignment_risk": TOLERANCES["risk"]}

# tests/test_pipeline.py's small_config and sequence, and the golden
# scenario's (tests/test_golden.py), each with failure prediction on (no
# classifier: the risk stays -1 and gates nothing)
SCENES = {
    "pipeline": (dict(working_mode="debug", raw_capacity=8192,
                      downsample_capacity=4096, filtered_capacity=2048,
                      map_capacity=16384, align_ds_capacity=1024,
                      align_max_clusters=8, min_cluster_size=30),
                 dict(n_frames=8, n_points=6000, seed=0)),
    "golden": (dict(raw_capacity=8192, downsample_capacity=4096,
                    filtered_capacity=2048, min_cluster_size=20,
                    align_ds_capacity=1024, align_max_clusters=8),
               dict(n_frames=8, n_points=5000, seed=11)),
}


def _items(scene):
    return jax_sequence(**SCENES[scene][1])[0]


def _cfg(cls, scene, **kw):
    return cls(**SCENES[scene][0], failure_prediction_mode=True, **kw)


def _run_port(scene, vis=None, pipelined=False, **kw):
    app = App(_cfg(PipelineConfig, scene, **kw), device="cpu",
              visualizer=vis)
    frames = SequenceRunner(app, pipelined=pipelined).run_clouds(
        _items(scene))
    app.close()
    return app, frames


@pytest.fixture(scope="module", params=sorted(SCENES))
def both(request):
    scene = request.param
    jvis, vis = JaxRecording(), RecordingVisualizer()
    JaxRunner(JaxApp(_cfg(JaxConfig, scene), visualizer=jvis)).run_clouds(
        _items(scene))
    app, frames = _run_port(scene, vis)
    return scene, jvis, vis, frames


def test_publishes_match_jax(both):
    scene, jvis, vis, frames = both
    for hook in ("clouds", "maps") + POSE_HOOKS:
        got, want = getattr(vis, hook), getattr(jvis, hook)
        assert [u for u, _ in got] == [u for u, _ in want], hook
    assert sorted(vis.metrics) == sorted(jvis.metrics) == sorted(METRIC_TOL)
    for name, series in vis.metrics.items():
        assert [u for u, _ in series] == [u for u, _ in jvis.metrics[name]]
    for hook in POSE_HOOKS:
        for (_, a), (_, b) in zip(getattr(vis, hook), getattr(jvis, hook)):
            assert a.shape == b.shape == (4, 4)
            assert np.abs(a[:3, 3] - b[:3, 3]).max() <= TOL_POSE_M, hook
    for hook in ("clouds", "maps"):
        for (_, a), (_, b) in zip(getattr(vis, hook), getattr(jvis, hook)):
            assert a.dtype == np.float32 and a.shape[1] == 3
            assert abs(len(a) - len(b)) <= TOL_MAP_SHARE * len(b), hook
    assert len(vis.maps) >= 2 and len(vis.poses) >= 1   # JAX's own test


def test_metric_values(both):
    """Each published metric is the frame's result, bit for bit, and the
    risk stays -1 without a classifier in both packages. The overlaps hold
    to JAX's within the golden tolerance on the golden scenario. Not held
    to JAX here (ROADMAP Q3, the packages' kept plane subsets part under
    the hough order): the overlap on tests/test_pipeline.py's sequence
    (2.07 apart at frame 4), and alignability on both (10.1 and 13.1
    apart), a function of 2 % box overlaps between those subsets; the
    risk stage is held to JAX's on identical inputs in
    tests/test_torch_risk.py instead."""
    scene, jvis, vis, frames = both
    fields = {"octree_overlap": "octree_overlap",
              "fov_overlap": "fov_overlap", "alignability": "alignability",
              "alignment_risk": "risk"}
    for name, field in fields.items():
        got = [(u, v) for u, v in vis.metrics[name]]
        want = [(f.utime, float(getattr(f, field))) for f in frames[1:]]
        assert got == want, name
    assert {v for _, v in vis.metrics["alignment_risk"]} == \
        {v for _, v in jvis.metrics["alignment_risk"]} == {-1.0}
    if scene == "golden":
        for name in ("octree_overlap", "fov_overlap"):
            for (_, a), (_, b) in zip(vis.metrics[name], jvis.metrics[name]):
                assert abs(a - b) <= METRIC_TOL[name], (name, a, b)


def _same_results(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        for k, v in vars(x).items():
            w = getattr(y, k)
            if isinstance(v, np.ndarray):
                np.testing.assert_array_equal(v, w, err_msg=k)
            else:
                assert v == w, (k, v, w)


@pytest.mark.parametrize("mode", ["sync", "pipelined"])
def test_sink_changes_no_result(mode):
    """With a sink the App's results are its results without one, bit for
    bit; pipelined (depth 4, async finalize) the publishes come in frame
    order."""
    kw = {} if mode == "sync" else dict(pipeline_depth=4,
                                        async_finalize=True)
    pipelined = mode == "pipelined"
    vis = RecordingVisualizer()
    _, with_sink = _run_port("golden", vis, pipelined=pipelined, **kw)
    _, without = _run_port("golden", pipelined=pipelined, **kw)
    _same_results(with_sink, without)
    for series in [vis.clouds, vis.maps, vis.poses,
                   *vis.metrics.values()]:
        utimes = [u for u, *_ in series]
        assert utimes == sorted(utimes)
    assert [u for u, _ in vis.metrics["octree_overlap"]] == \
        [f.utime for f in with_sink[1:]]


def test_no_read_without_a_sink(monkeypatch):
    """After the bootstrap, the default sink costs no Cloud.to_numpy and no
    map materialization per frame; a RecordingVisualizer's reads are
    counted by the same counters."""
    reads = {"to_numpy": 0, "finalized": 0}
    to_numpy, finalized = Cloud.to_numpy, App._finalized_np

    def counting_to_numpy(self):
        reads["to_numpy"] += 1
        return to_numpy(self)

    def counting_finalized(self, cloud):
        reads["finalized"] += 1
        return finalized(self, cloud)

    monkeypatch.setattr(Cloud, "to_numpy", counting_to_numpy)
    monkeypatch.setattr(App, "_finalized_np", counting_finalized)
    items = _items("golden")
    counts = {}
    for name, vis in (("default", None), ("recording",
                                          RecordingVisualizer())):
        app = App(_cfg(PipelineConfig, "golden"), device="cpu",
                  visualizer=vis)
        app.process_cloud(_frame(app, items[0]))
        reads.update(to_numpy=0, finalized=0)
        for item in items[1:]:
            app.process_cloud(_frame(app, item))
        counts[name] = dict(reads)
    assert counts["default"] == {"to_numpy": 0, "finalized": 0}, counts
    assert counts["recording"]["finalized"] > 0, counts


def _frame(app, item):
    from aicp_mapping_tpu_torch import AlignedCloud

    utime, pts, pose = item
    return AlignedCloud.create(utime, Cloud.from_numpy(
        pts, capacity=app.cfg.raw_capacity), pose)


# JAX's section names -> the port's (PARITY.md 2.11)
SECTIONS = {"frameStep": "aicp.app.finalize_wait",
            "fullLoop": "aicp.app.finalize"}


def test_timing_sections_match_jax():
    """`timing` records the scalar wait (JAX's "frameStep", the port's
    "aicp.app.finalize_wait") of each finalized batch and the host tail
    ("fullLoop", "aicp.app.finalize") of each finalized frame, as JAX's
    App does; the port records both on the async finalizer's path too."""
    items = _items("golden")[:4]
    japp = JaxApp(_cfg(JaxConfig, "golden"))
    JaxRunner(japp).run_clouds(items)
    want = {SECTIONS[k]: v["count"] for k, v in japp.timing.summary().items()}
    app = App(_cfg(PipelineConfig, "golden"), device="cpu")
    SequenceRunner(app).run_clouds(items)
    got = {k: v["count"] for k, v in app.timing.summary().items()}
    assert got == want == {"aicp.app.finalize_wait": 3,
                           "aicp.app.finalize": 3}
    app = App(_cfg(PipelineConfig, "golden", pipeline_depth=2,
                   async_finalize=True), device="cpu")
    SequenceRunner(app, pipelined=True).run_clouds(items)
    app.close()
    got = {k: v["count"] for k, v in app.timing.summary().items()}
    # the 3 frames after the bootstrap, in batches of depth // 2 = 1
    assert got == {"aicp.app.finalize_wait": 3, "aicp.app.finalize": 3}


def test_file_visualizer_through_the_app(tmp_path):
    vis = FileVisualizer(str(tmp_path / "viz"))
    app, _ = _run_port("golden", vis)
    from aicp_mapping_tpu_torch.io.pcd import read_pcd

    names = sorted(os.listdir(tmp_path / "viz"))
    assert "aligned_map.pcd" in names
    assert len([n for n in names if n.startswith("cloud_0_")]) == \
        len(vis.clouds)
    utime, pts = vis.clouds[-1]
    got, _ = read_pcd(str(tmp_path / "viz" / f"cloud_0_{utime}.pcd"))
    np.testing.assert_array_equal(got, pts)
    got, _ = read_pcd(str(tmp_path / "viz" / "aligned_map.pcd"))
    np.testing.assert_array_equal(got, app.aligned_map_np)


def test_checkpoint_loads_with_a_sink(tmp_path):
    from aicp_mapping_tpu_torch.io.checkpoint import (load_checkpoint,
                                                      save_checkpoint)

    items = _items("golden")
    app = App(_cfg(PipelineConfig, "golden"), device="cpu")
    for item in items[:3]:
        app.process_cloud(_frame(app, item))
    path = str(tmp_path / "ckpt")
    save_checkpoint(app, path)
    vis = RecordingVisualizer()
    loaded = load_checkpoint(path, device="cpu", visualizer=vis)
    assert loaded.vis is vis
    res = loaded.process_cloud(_frame(loaded, items[3]))
    np.testing.assert_array_equal(
        res.corrected_pose, app.process_cloud(_frame(app, items[3]))
        .corrected_pose)
    assert [u for u, _ in vis.metrics["octree_overlap"]] == [items[3][0]]
