"""The port's App and mapper checkpoints (`io.checkpoint`) against the JAX
package's (CPU): one format, loaded by either package."""
import numpy as np
import pytest
import torch

from aicp_mapping_tpu.io import checkpoint as jcheckpoint
from aicp_mapping_tpu.pipeline.app import App as JApp
from aicp_mapping_tpu.pipeline.config import PipelineConfig as JConfig
from aicp_mapping_tpu.pipeline.sequence import SequenceRunner as JRunner
from aicp_mapping_tpu.pipeline.sequence import synthetic_sequence
from aicp_mapping_tpu_torch import AlignedCloud, App, Cloud
from aicp_mapping_tpu_torch.io import checkpoint
from aicp_mapping_tpu_torch.pipeline.config import PipelineConfig
from aicp_mapping_tpu_torch.pipeline.mapper import PoseGraphMapper
from aicp_mapping_tpu_torch.pipeline.sequence import SequenceRunner
from aicp_mapping_tpu_torch.tools.synthetic import room_cloud

torch.set_num_threads(1)
# the golden file's tolerances (tests/test_golden.py): %, m, m
TOL_OVERLAP, TOL_CORRECTION_T, TOL_CORRECTED_T = 2.0, 0.02, 0.05
CFG = dict(raw_capacity=8192, downsample_capacity=4096,
           filtered_capacity=2048, min_cluster_size=20)


@pytest.fixture(scope="module")
def items():
    return synthetic_sequence(n_frames=6, n_points=4000, seed=5)[0]


def _agree(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.accepted, g.registered) == (w.accepted, w.registered)
        assert abs(g.octree_overlap - w.octree_overlap) <= TOL_OVERLAP
        np.testing.assert_allclose(np.asarray(g.correction)[:3, 3],
                                   np.asarray(w.correction)[:3, 3],
                                   atol=TOL_CORRECTION_T)
        np.testing.assert_allclose(np.asarray(g.corrected_pose)[:3, 3],
                                   np.asarray(w.corrected_pose)[:3, 3],
                                   atol=TOL_CORRECTED_T)


def _same_state(a, b):
    assert a.graph.n_clouds == b.graph.n_clouds
    assert a.graph.current_reference_id == b.graph.current_reference_id
    np.testing.assert_array_equal(np.asarray(a.total_correction),
                                  np.asarray(b.total_correction))
    assert len(a.frames) == len(b.frames)
    assert a._since_ref_disp == b._since_ref_disp
    assert a._registered_any == b._registered_any
    for x, y in zip(a._ref_device, b._ref_device):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y.cpu()
                                      if hasattr(y, "cpu") else y))


def test_resume_is_bit_identical(items, tmp_path):
    """3 frames, a checkpoint, a new App from it, 3 more frames: the same
    bits as the uninterrupted run."""
    full = SequenceRunner(App(PipelineConfig(**CFG), device="cpu")
                          ).run_clouds(items)
    app = App(PipelineConfig(**CFG), device="cpu")
    SequenceRunner(app).run_clouds(items[:3])
    path = str(tmp_path / "state")
    checkpoint.save_checkpoint(app, path)
    back = checkpoint.load_checkpoint(path, device="cpu")
    _same_state(back, app)
    for a, b in zip(back.graph.clouds, app.graph.clouds):
        assert torch.equal(a.cloud.points, b.cloud.points)
        np.testing.assert_array_equal(a.corrected_pose, b.corrected_pose)
        assert (a.is_reference, a.its_reference_id) == (
            b.is_reference, b.its_reference_id)
    resumed = SequenceRunner(back).run_clouds(items[3:])
    for r, t in zip(resumed, full[3:]):
        assert (r.accepted, r.registered) == (t.accepted, t.registered)
        np.testing.assert_array_equal(r.correction, t.correction)
        np.testing.assert_array_equal(r.corrected_pose, t.corrected_pose)
    assert [f.utime for f in back.frames] == [f.utime for f in full]


def test_jax_checkpoint_resumes_on_the_port(items, tmp_path):
    """A checkpoint the JAX package wrote, resumed by the port's App: the
    next frames JAX's uninterrupted run's, within the golden tolerances."""
    want = JRunner(JApp(JConfig(**CFG))).run_clouds(items)
    japp = JApp(JConfig(**CFG))
    JRunner(japp).run_clouds(items[:3])
    path = str(tmp_path / "jax_state")
    jcheckpoint.save_checkpoint(japp, path)
    app = checkpoint.load_checkpoint(path, device="cpu")
    _same_state(app, japp)
    _agree(SequenceRunner(app).run_clouds(items[3:]), want[3:])


def test_port_checkpoint_loads_in_jax(items, tmp_path):
    """The JAX package resumes the port's checkpoint; its next frames are
    the port's uninterrupted run's, within the golden tolerances."""
    want = SequenceRunner(App(PipelineConfig(**CFG), device="cpu")
                          ).run_clouds(items)
    app = App(PipelineConfig(**CFG), device="cpu")
    SequenceRunner(app).run_clouds(items[:3])
    path = str(tmp_path / "port_state")
    checkpoint.save_checkpoint(app, path)
    japp = jcheckpoint.load_checkpoint(path)
    _same_state(app, japp)
    _agree(JRunner(japp).run_clouds(items[3:]), want[3:])


def test_prior_map_and_inflight_frames(items, tmp_path):
    """The prior map survives; a checkpoint taken mid-pipeline finalizes
    the frames in flight first (tests/test_checkpoint.py)."""
    app = App(PipelineConfig(**CFG), device="cpu")
    app.set_prior_map(Cloud.from_numpy(room_cloud(n=2000, seed=1),
                                       capacity=4096))
    checkpoint.save_checkpoint(app, str(tmp_path / "prior"))
    back = checkpoint.load_checkpoint(str(tmp_path / "prior"), device="cpu")
    assert torch.equal(back.prior_map.points, app.prior_map.points)
    jback = jcheckpoint.load_checkpoint(str(tmp_path / "prior"))
    np.testing.assert_array_equal(np.asarray(jback.prior_map.points),
                                  app.prior_map.points.numpy())

    cfg = PipelineConfig(**CFG, pipeline_depth=8)
    app = App(cfg, device="cpu")
    for u, pts, pose in items[:5]:
        app.submit_cloud(AlignedCloud.create(
            u, Cloud.from_numpy(pts, capacity=cfg.raw_capacity), pose))
    assert app._pending
    checkpoint.save_checkpoint(app, str(tmp_path / "mid"))
    assert not app._pending
    back = checkpoint.load_checkpoint(str(tmp_path / "mid"), device="cpu")
    assert len(back.frames) == 5 and back.cfg.pipeline_depth == 8
    _same_state(back, app)


def test_no_card_raises(tmp_path):
    app = App(PipelineConfig(**CFG), device="cpu")
    checkpoint.save_checkpoint(app, str(tmp_path / "empty"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            checkpoint.load_checkpoint(str(tmp_path / "empty"))
    back = checkpoint.load_checkpoint(str(tmp_path / "empty"), device="cpu")
    assert back.graph.is_empty() and back._ref_device is None


@pytest.fixture(scope="module")
def mapped(tmp_path_factory):
    """tests/test_checkpoint.py's mapping session on the port: 8 frames of
    a loop, closures proposed, then saved."""
    items, _ = synthetic_sequence(n_frames=8, n_points=6000, seed=2,
                                  yaw_rate_deg=45.0, step=1.2)
    cfg = PipelineConfig(**dict(CFG, min_cluster_size=30),
                         working_mode="debug", reference_update_frequency=2)
    app = App(cfg, device="cpu")
    SequenceRunner(app).run_clouds(items)
    mapper = PoseGraphMapper(app, min_keyframe_gap=1, min_loop_overlap=10.0,
                             max_loop_distance=30.0)
    assert len(mapper.propose_loop_closures()) >= 1
    path = str(tmp_path_factory.mktemp("slam") / "slam_ckpt")
    checkpoint.save_mapper_checkpoint(mapper, path)
    return mapper, path


def test_mapper_checkpoint_round_trip(mapped):
    mapper, path = mapped
    back = checkpoint.load_mapper_checkpoint(path, device="cpu")
    assert [k.index for k in back.keyframes()] == \
        [k.index for k in mapper.keyframes()]
    for a, b in zip(mapper.keyframes(), back.keyframes()):
        np.testing.assert_array_equal(a.pose, b.pose)
    assert len(back.loop_closures) == len(mapper.loop_closures)
    for a, b in zip(mapper.loop_closures, back.loop_closures):
        assert (a.i, a.j, a.overlap, a.inlier_rms) == (b.i, b.j, b.overlap,
                                                       b.inlier_rms)
        np.testing.assert_array_equal(a.measurement, b.measurement)
        np.testing.assert_array_equal(a.info, b.info)
    for k in ("min_loop_overlap", "min_keyframe_gap", "max_loop_distance",
              "odom_weight_t", "odom_weight_r"):
        assert getattr(back, k) == getattr(mapper, k)
    # the resumed back-end optimizes to the same bits
    np.testing.assert_array_equal(
        np.stack([k.pose for k in mapper.optimize()]),
        np.stack([k.pose for k in back.optimize()]))


def test_mapper_checkpoint_loads_in_jax(mapped):
    """The JAX package reads the port's mapper checkpoint (the saved state:
    the fixture's mapper may have optimized since)."""
    _, path = mapped
    port = checkpoint.load_mapper_checkpoint(path, device="cpu")
    jm = jcheckpoint.load_mapper_checkpoint(path)
    assert [(lc.i, lc.j) for lc in jm.loop_closures] == \
        [(lc.i, lc.j) for lc in port.loop_closures]
    np.testing.assert_array_equal(
        np.stack([np.asarray(k.pose) for k in jm.keyframes()]),
        np.stack([k.pose for k in port.keyframes()]))
