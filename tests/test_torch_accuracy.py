"""The port's trajectory-accuracy regression (`eval.accuracy.run_accuracy`)
against the JAX package's (CPU).

JAX's region-growing App takes ~20 s a frame on the CPU at the reduced
drive's 16,384 / 8,192 / 4,096 points, so the two packages' regressions
are compared through a fixed trajectory standing in for the App (the same
drive, odometry, metrics and summary), and the port's App runs the reduced
drive itself: 8 frames of a 64 x 512 scanner."""
import numpy as np
import pytest
import torch

from aicp_mapping_tpu.eval import accuracy as jaccuracy
from aicp_mapping_tpu.eval import kitti as jkitti
from aicp_mapping_tpu.pipeline import sequence as jsequence
from aicp_mapping_tpu.tools.urban import urban_sequence as j_urban_sequence
from aicp_mapping_tpu_torch.eval import accuracy
from aicp_mapping_tpu_torch.pipeline import sequence
from aicp_mapping_tpu_torch.pipeline.app import FrameResult
from aicp_mapping_tpu_torch.pipeline.config import PipelineConfig

torch.set_num_threads(1)
N_FRAMES = 8
SEQ = dict(n_azimuth=512, n_points_cap=16000, drift_per_m=0.025,
           drift_yaw_deg_per_m=0.2)
CFG = dict(working_mode="debug", segmentation_method="region_growing",
           raw_capacity=16384, downsample_capacity=8192,
           filtered_capacity=4096)
# a drive long enough for every metric: KITTI segments of 50-200 m and
# RPE over 10 frames (1 m a frame), scanned coarsely
LONG = 230
LONG_SEQ = dict(n_azimuth=64, n_beams=16, n_points_cap=2000)


def _stand_in_frames(items, dropped=(7, 100)):
    """Frame results whose corrected poses are the odometry scaled about
    its start by 0.999, some frames not accepted."""
    out = []
    start = np.asarray(items[0][2], np.float64)[:3, 3]
    for i, (utime, _pts, odom) in enumerate(items):
        pose = np.asarray(odom, np.float64).copy()
        pose[:3, 3] = start + (pose[:3, 3] - start) * 0.999
        out.append(FrameResult(
            utime=utime, reference_id=0, reading_id=i, octree_overlap=50.0,
            fov_overlap=-1.0, alignability=-1.0, risk=-1.0,
            correction=np.eye(4, dtype=np.float32),
            accepted=i not in dropped, registered=True, n_iterations=3,
            inlier_rms=0.01, corrected_pose=pose.astype(np.float32),
            filtered_size=100))
    return out


def test_regression_summary_equals_jax(monkeypatch):
    """Both packages' run_accuracy on the same drive and the same
    trajectory: every number of the summary equal."""
    monkeypatch.setattr(jsequence.SequenceRunner, "run_clouds",
                        lambda self, items: _stand_in_frames(items))
    monkeypatch.setattr(sequence.SequenceRunner, "run_clouds",
                        lambda self, items: _stand_in_frames(items))
    small = dict(raw_capacity=1024, downsample_capacity=512,
                 filtered_capacity=256)
    from aicp_mapping_tpu.pipeline.config import PipelineConfig as JConfig
    want = jaccuracy.run_accuracy(n_frames=LONG, seed=2, cfg=JConfig(**small),
                                  seq_kwargs=LONG_SEQ)
    got = accuracy.run_accuracy(n_frames=LONG, seed=2,
                                cfg=PipelineConfig(**small),
                                seq_kwargs=LONG_SEQ, device="cpu")
    assert got.keys() == want.keys()
    for k in ("n_frames", "track_length_m", "dropped_frames"):
        assert got[k] == want[k], k
    assert got["dropped_frames"] == 2
    for part in ("pipeline", "odometry_only"):
        assert got[part].keys() == want[part].keys()
        assert got[part]["n_segments"] > 0
        for k in want[part]:
            assert got[part][k] == pytest.approx(want[part][k],
                                                 abs=1e-12), (part, k)


@pytest.fixture(scope="module")
def port_run():
    return accuracy.run_accuracy(n_frames=N_FRAMES, seed=0,
                                 cfg=PipelineConfig(**CFG), seq_kwargs=SEQ,
                                 device="cpu")


def test_reduced_drive_on_the_port(port_run):
    """The port's App on the reduced drive: every frame kept, and the
    odometry metrics JAX's metrics of JAX's own drive."""
    items, gt = j_urban_sequence(n_frames=N_FRAMES, seed=0, **SEQ)
    odom = np.stack([it[2] for it in items])
    assert port_run["n_frames"] == N_FRAMES
    assert port_run["dropped_frames"] == 0
    want = {"ate_rmse_m": jkitti.ate_rmse(gt, odom),
            "ate_rmse_noalign_m": jkitti.ate_rmse(gt, odom, align=False)}
    for k, v in want.items():
        assert port_run["odometry_only"][k] == pytest.approx(v, abs=1e-12)
    assert np.isfinite(port_run["pipeline"]["ate_rmse_m"])


def test_default_config_is_the_outdoor_operating_point():
    cfg = accuracy.accuracy_config()
    assert (cfg.working_mode, cfg.segmentation_method) == (
        "debug", "region_growing")
    assert (cfg.raw_capacity, cfg.downsample_capacity,
            cfg.filtered_capacity) == (65536, 16384, 8192)
    assert cfg.icp.trim_normal_space
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            accuracy.run_accuracy(n_frames=2)
