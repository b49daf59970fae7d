"""The check fails a run whose timed path is broken underneath: the harness
runs a tiny cell on the CPU with the App's frame step broken in turn, and
`correct` must come out false; a sound run must come out true."""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import pytest
import torch

from portbench import check, harness, spec


def _run(tiny, cell="bench60k.online", seconds=1.5, seed=11):
    c = spec.load_cell(tiny, cell, os.path.join(tiny, "portbench"))
    return harness.run_cell(c, seed, seconds, False, device="cpu",
                            log=lambda m: None)


def _icp(monkeypatch, change):
    from aicp_mapping_tpu_torch.pipeline import fused
    real = fused.point_to_plane_icp

    def broken(*args, **kwargs):
        return change(real(*args, **kwargs), args)

    monkeypatch.setattr(fused, "point_to_plane_icp", broken)


@pytest.mark.parametrize("cell", ["bench60k.online", "bench60k.replay"])
def test_a_sound_run_is_correct(tiny, cell):
    out = _run(tiny, cell)
    assert out["correct"], out["check"]
    assert list(out["check"])[-1] in out["check"]
    assert list(out)[-1] == "check"


def test_a_step_that_returns_its_state_unchanged(tiny, monkeypatch):
    # ICP hands back the transform it started from: every frame keeps its
    # prior, which the truth check sees by itself
    _icp(monkeypatch, lambda res, args: dataclasses.replace(res, T=args[5]))
    out = _run(tiny)
    assert not out["correct"]
    for name in ("corr_gap_m", "truth_link_m"):
        assert out["check"][name]["value"] > out["check"][name]["limit"]


def test_half_the_cloud_left_out(tiny, monkeypatch):
    from aicp_mapping_tpu_torch.pipeline import fused
    real = fused._prefilter

    def half(*args, **kwargs):
        pts, mask, normals = real(*args, **kwargs)
        keep = torch.arange(mask.shape[0], device=mask.device) % 2 == 0
        return pts, mask & keep, normals

    monkeypatch.setattr(fused, "_prefilter", half)
    out = _run(tiny)
    assert not out["correct"]
    assert out["check"]["filtered_miss"]["value"] > 0.3


@pytest.mark.parametrize("cell", ["bench60k.online", "bench60k.replay"])
def test_an_answer_altered_where_it_is_produced(tiny, monkeypatch, cell):
    def nudge(res, args):
        T = res.T.clone()
        T[0, 3] += 0.05
        return dataclasses.replace(res, T=T)

    _icp(monkeypatch, nudge)
    out = _run(tiny, cell)
    assert not out["correct"]
    assert out["check"]["corr_gap_m"]["value"] >= 0.04


@pytest.mark.cuda
def test_the_control_is_not_correct(tiny):
    """The reference in the program's place with TF32 matmuls, judged at
    float32: on the card only (TF32 exists there)."""
    if not torch.cuda.is_available():
        pytest.skip("the control's TF32 matmuls need a CUDA card")
    from portbench.control import control_frames
    from portbench.entries import process_cloud

    c = spec.load_cell(tiny, "bench60k.online",
                       os.path.join(tiny, "portbench"))
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        collected = control_frames(c.config, False, 3, 24,
                                   list(range(1, 24)), 6, "cuda")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    got = process_cloud.judge(c.config, collected, "cuda")
    correct, _ = check.verdict(got["numbers"], c.workload["limits"])
    assert not correct, got["numbers"]


def test_a_borrowed_reference_is_judged(tiny):
    """A sampled frame registers against a reference cloud placed by the
    App's correction of an earlier frame. Both sides borrow that
    correction, so a wrong one passes the sampled frame; the check judges
    the reference frame itself."""
    from portbench.control import control_frames
    from portbench.entries import process_cloud
    from portbench.reference.frame import reference_schedule

    c = spec.load_cell(tiny, "bench60k.online",
                       os.path.join(tiny, "portbench"))
    sample, n = [13], 16
    collected = control_frames(c.config, False, 5, n, sample, 2, "cpu")
    accepted = [collected.results[k].accepted for k in range(n)]
    r = reference_schedule(accepted, 5, False)[13]
    assert r > 2 and r not in sample and r in collected.frames
    # the App moved frame r 5 cm off where it is produced; every later
    # frame registers onto it, so moves with it
    shift = np.eye(4, dtype=np.float32)
    shift[0, 3] = 0.05
    for k in range(r, n):
        got = collected.results[k]
        if got.accepted:
            collected.results[k] = dataclasses.replace(
                got, correction=shift @ got.correction,
                corrected_pose=shift @ got.corrected_pose,
                aligned=got.aligned + shift[:3, 3])
    out = process_cloud.judge(c.config, collected, "cpu")
    correct, table = check.verdict(out["numbers"], c.workload["limits"])
    assert not correct
    assert out["numbers"]["corr_gap_m"] >= 0.04
