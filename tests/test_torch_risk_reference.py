"""Failure prediction in the port against the benchmark's plain reference
(`portbench/reference/risk.py`, plain PyTorch, nothing of the port), on
the CPU at a small size of the ANYmal walk (`portbench/scenes/
anymal_walk.py`) with the shipped classifier: the port's `risk_stage`
and an App frame with failure prediction on give the reference's FOV
overlap, alignability and P(failure) within the `anymal_fp.online`
cell's limits, and its gates; the judge's schedule of references follows
risk-gated frames; the risk stage's spans and label propagation's reads
are in the port's tracer."""
import json
import os

import numpy as np
import pytest
import torch

from aicp_mapping_tpu_torch.classification.classifier import RiskClassifier
from aicp_mapping_tpu_torch.cloud import AlignedCloud
from aicp_mapping_tpu_torch.ops import segmentation
from aicp_mapping_tpu_torch.pipeline import fused
from aicp_mapping_tpu_torch.pipeline.app import App
from aicp_mapping_tpu_torch.pipeline.sequence import wire_cloud
from aicp_mapping_tpu_torch.utils import timing
from portbench import check_fp, drivers
from portbench.reference.frame import FramePath
from portbench.reference.risk import RiskPath

torch.set_num_threads(1)
ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
CLF = os.path.join(ROOT, "data", "classification", "risk_classifier.npz")
RISK_SPANS = ("aicp.step.risk", "aicp.risk.fov", "aicp.risk.align",
              "aicp.risk.classify", "aicp.seg.propagation_read")
# frames of the small walk's lap (92 frames; the hall is x < 5 m, the
# corridor's walls and floor alone fill the view from x > 7.5 m)
HALL, CORRIDOR = 1, 30


def _limits():
    with open(os.path.join(ROOT, "portbench", "workloads",
                           "anymal_fp.online.json")) as f:
        return json.load(f)["limits"]


@pytest.fixture(scope="module")
def small():
    """The cell's configuration at a small size and its scene."""
    with open(os.path.join(ROOT, "portbench", "configs",
                           "anymal_fp.json")) as f:
        config = json.load(f)
    config["pipeline"].update(
        raw_capacity=8192, downsample_capacity=4096, filtered_capacity=2048,
        align_ds_capacity=1024, pipeline_depth=8, async_finalize=False,
        classifier_path=CLF)
    config["icp"].update(coarse_decimation=4)
    config["scene"].update(room_points=6000, room_size=10.0,
                           corridor_points=6000, corridor_length=20.0,
                           sensor_range=7.0, start_x=-2.0, leg_frames=40)
    scene = drivers.make_scene(config, 0, "cpu")
    return config, scene


def _frame(scene, i):
    scene.offset = 0
    return scene.frame(i)


@pytest.mark.parametrize("start,gated", [(HALL, False), (CORRIDOR, True)],
                         ids=["hall", "corridor"])
def test_risk_stage_matches_the_plain_reference(small, start, gated):
    """The port's `risk_stage` on two prefiltered frames a step apart, and
    the reference's on the same inputs."""
    config, scene = small
    cfg = drivers.pipeline_config(config)
    path, risk = FramePath(config, "cpu"), RiskPath(config, "cpu")
    _, ref_pts, ref_pose = _frame(scene, start)
    _, pts, pose = _frame(scene, start + 1)
    ref, read = path.prefilter(ref_pts, ref_pose), path.prefilter(pts, pose)
    overlap = fused._overlap_percent(cfg, ref.points, ref.mask, read.points,
                                     read.mask)
    clf = RiskClassifier(device="cpu")
    clf.load(CLF)
    fov, align, p, ok = fused.risk_stage(
        cfg, ref.points, ref.mask, torch.as_tensor(ref_pose), read.points,
        read.mask, torch.as_tensor(pose), overlap, clf.model)
    want = risk.stage(ref.points, ref.mask, ref_pose, read.points, read.mask,
                      pose, float(overlap))
    lim = _limits()
    assert abs(float(fov) - want.fov) <= lim["fov_gap"]
    assert abs(float(align) - want.alignability) <= lim["align_gap"]
    assert abs(float(p) - want.risk) <= lim["risk_gap"]
    assert bool(ok) is not want.gated
    assert want.gated is gated


@pytest.mark.parametrize("start,gated", [(HALL, False), (CORRIDOR, True)],
                         ids=["hall", "corridor"])
def test_app_frame_with_failure_prediction_matches_the_reference(
        small, start, gated):
    """`App.process_cloud` on the int16 wire: the bootstrap, then one frame
    against it; the reference registers the frame against the bootstrap's
    filtered cloud at its pose, the risk stage and both gates included."""
    config, scene = small
    cfg = drivers.pipeline_config(config)
    app = App(cfg, device="cpu")
    frames = [_frame(scene, start + j) for j in range(2)]
    for u, pts, prior in frames:
        app.process_cloud(AlignedCloud.create(
            u, wire_cloud(cfg, pts, device="cpu"), prior))
    boot, got = app.frames
    path, risk = FramePath(config, "cpu"), RiskPath(config, "cpu")
    ref = path.prefilter(*frames[0][1:])
    read = path.prefilter(*frames[1][1:])
    out = path.register(read, frames[1][2], ref.points, ref.normals,
                        ref.mask)
    want = risk.stage(ref.points, ref.mask, boot.corrected_pose, read.points,
                      read.mask, frames[1][2], out.overlap)
    lim = _limits()
    assert abs(got.octree_overlap - out.overlap) <= lim["overlap_gap"]
    assert abs(got.fov_overlap - want.fov) <= lim["fov_gap"]
    assert abs(got.alignability - want.alignability) <= lim["align_gap"]
    assert abs(got.risk - want.risk) <= lim["risk_gap"]
    assert got.registered is not want.gated
    assert want.gated is gated
    assert got.accepted is (want.gated or out.accepted)
    if gated:
        np.testing.assert_array_equal(got.correction, np.eye(4))
        assert app.graph.current_reference_id == 1


def test_fp_reference_schedule_follows_risk_gated_frames():
    """Every 5th accepted frame since the last reference, a risk-gated
    frame at once (it restarts the count), a rejected frame not at all."""
    accepted = [True, True, False, True, True, True, True, True, True,
                True, True, True, True]
    gated = [False, False, False, False, False, False, True, False, False,
             False, False, False, False]
    refs = check_fp.reference_schedule(accepted, gated, 5)
    # frame 6 is reached on the count of 1, 3, 4, 5 (frame 2 rejected) and
    # is gated; 7-11 count 1-5 after it: 11 is the next reference
    assert refs == [None, 0, 0, 0, 0, 0, 0, 6, 6, 6, 6, 6, 11]
    assert check_fp.gated_flags([True, True, True, False],
                                [False, True, False, False]) == \
        [False, False, True, False]
    assert check_fp.frames_to_judge(accepted, gated, 5, [8, 12], 2) == \
        [1, 2, 6, 8, 11, 12]


def test_fp_reference_schedule_without_a_gate_is_the_windowed_one():
    from portbench.reference.frame import reference_schedule

    accepted = [True] * 4 + [False] + [True] * 12
    assert check_fp.reference_schedule(accepted, [False] * 17, 5) == \
        reference_schedule(accepted, 5, pipelined=False)


@pytest.mark.parametrize("async_finalize", [False, True],
                         ids=["synchronous", "async-finalize"])
def test_risk_spans_under_a_profiler(small, async_finalize):
    """Each frame's risk stage is a span inside its dispatch, with its three
    parts inside it and one span a label-propagation read inside the
    alignability, all with the frame's index; the reads' count is the
    rounds' counter."""
    config, scene = small
    cfg = drivers.pipeline_config(config)
    cfg.async_finalize = async_finalize
    app = App(cfg, device="cpu")
    timing.reset()
    segmentation.reset_propagation_rounds()
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            for i in range(3):
                u, pts, prior = _frame(scene, HALL + i)
                app.process_cloud(AlignedCloud.create(
                    u, wire_cloud(cfg, pts, device="cpu"), prior))
        spans = timing.spans()
    finally:
        app.close()
        timing.reset()
    ids = {s.id: s for s in spans}
    by = {name: [s for s in spans if s.name == name] for name in RISK_SPANS}
    assert [s.frame for s in by["aicp.step.risk"]] == [1, 2]
    assert all(ids[s.parent].name == "aicp.app.dispatch"
               for s in by["aicp.step.risk"])
    for name in ("aicp.risk.fov", "aicp.risk.align", "aicp.risk.classify"):
        assert [s.frame for s in by[name]] == [1, 2], name
        assert all(ids[s.parent].name == "aicp.step.risk"
                   for s in by[name]), name
    reads = by["aicp.seg.propagation_read"]
    assert len(reads) == segmentation.propagation_rounds()["rounds"] > 0
    assert all(ids[s.parent].name == "aicp.risk.align" and s.frame in (1, 2)
               for s in reads)
