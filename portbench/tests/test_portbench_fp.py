"""The cell with failure prediction on, `anymal_fp.online`, at a tiny size
on the CPU: loaded by name and run through the harness, a sound run is
`correct` (untraced, and traced with its six per-layer metrics); a
program whose risk stage calls every frame risky fails on
`risk_gate_mismatch`; the judge's band round the threshold is the cell's
`risk_gap` limit; the readers of the risk stage's spans read nothing
where the program has none."""
from __future__ import annotations

import dataclasses
import os

import pytest

from conftest import REPO, _edit, make_tiny
from portbench import check_fp, control_fp, harness, spec

CELL = "anymal_fp.online"
METRICS = ("step_risk_ms.fp", "risk_align_ms.fp", "propagation_reads.fp",
           "dispatch_ms.fp", "host_reads.fp", "device_idle.fp")
SEED_ACROSS = 17     # starts 3 frames before the corridor fills the view
SEED_HALL = 10       # starts in the hall


@pytest.fixture(scope="module")
def tiny_fp(tmp_path_factory) -> str:
    root = make_tiny(str(tmp_path_factory.mktemp("tiny_fp")))
    pb = os.path.join(root, "portbench")

    def config(d):
        d["pipeline"].update(
            raw_capacity=8192, downsample_capacity=4096,
            filtered_capacity=2048, pipeline_depth=8, align_ds_capacity=1024,
            classifier_path=os.path.join(REPO, d["pipeline"][
                "classifier_path"]))
        d["icp"].update(coarse_decimation=4)
        d["scene"].update(room_points=6000, room_size=10.0,
                          corridor_points=6000, corridor_length=20.0,
                          sensor_range=7.0, start_x=-2.0, leg_frames=40)

    _edit(os.path.join(pb, "configs", "anymal_fp.json"), config)
    _edit(os.path.join(pb, "traffic", "online_fp.json"), lambda d: d.update(
        warmup_frames=2, staged_frames=3, traced_frames=3, max_rate=100))
    return root


def _run(root, seed, traced=False, seconds=1.5):
    c = spec.load_cell(root, CELL, os.path.join(root, "portbench"))
    return harness.run_cell(c, seed, seconds, traced, device="cpu",
                            log=lambda m: None)


def test_a_sound_run_is_correct(tiny_fp):
    out = _run(tiny_fp, SEED_ACROSS)
    assert out["correct"], out["check"]
    assert set(out["metrics"]) == {"frame_ms", "setup_s"}
    for name in check_fp.RISK_NUMBERS:
        assert name in out["check"], name


def test_a_traced_run_reads_the_risk_stage(tiny_fp):
    out = _run(tiny_fp, SEED_ACROSS, traced=True)
    assert out["correct"], out["check"]
    assert set(out["metrics"]) == set(METRICS)
    assert out["metrics"]["propagation_reads.fp"]["value"] > 0
    assert 0 < out["metrics"]["step_risk_ms.fp"]["value"] \
        < out["metrics"]["dispatch_ms.fp"]["value"]


def test_every_frame_called_risky_in_the_program_only(tiny_fp, monkeypatch):
    from aicp_mapping_tpu_torch.pipeline import fused

    monkeypatch.setattr(fused, "risk_stage",
                        control_fp.every_frame_risky(fused.risk_stage))
    out = _run(tiny_fp, SEED_HALL)
    assert not out["correct"]
    assert out["check"]["risk_gate_mismatch"]["value"] > 0


def test_the_near_threshold_band_is_the_cells_risk_gap_limit():
    cell = spec.load_cell(REPO, CELL)
    assert cell.traffic["entry"] == "process_cloud_fp"
    assert cell.workload["limits"]["risk_gap"] == check_fp.NEAR_THRESHOLD


def test_the_risk_readers_read_nothing_without_the_spans(tiny_fp,
                                                         monkeypatch):
    """A port older than the risk stage's spans: the three readers of
    those spans give None."""
    from aicp_mapping_tpu_torch.utils import timing

    real = timing.spans
    gone = {"aicp.step.risk", "aicp.risk.fov", "aicp.risk.align",
            "aicp.risk.classify", "aicp.seg.propagation_read"}
    monkeypatch.setattr(timing, "spans", lambda: [
        s for s in real() if s.name not in gone])
    out = _run(tiny_fp, SEED_ACROSS, traced=True)
    assert set(out["metrics"]) == {"dispatch_ms.fp", "host_reads.fp",
                                   "device_idle.fp"}


def test_a_gated_frame_keeps_its_prior():
    """A gated frame's correction is the identity and its pose its prior's,
    re-pinned as the App records it."""
    import numpy as np

    from portbench.reference import plain
    from portbench.reference.risk import Risk

    prior = np.eye(4, dtype=np.float32)
    prior[:3, 3] = [1.0, 2.0, 0.5]
    frame = dataclasses.make_dataclass(
        "F", ["correction", "accepted", "corrected_pose", "filtered",
              "aligned_points"])(np.full((4, 4), 7.0, np.float32), True,
                                 None, None, None)
    out = check_fp.Outcome(frame, Risk(90.0, 0.0, 0.9, True), True, False,
                           prior)
    assert out.accepted
    np.testing.assert_array_equal(out.applied, np.eye(4))
    np.testing.assert_array_equal(out.corrected_pose,
                                  plain.repin_roll_pitch_np(prior, prior))
