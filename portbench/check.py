"""The comparison that decides `correct`: the App's frames against the
plain reference (`reference/`), worked out again from the same inputs,
and the App's trajectory against the scene's ground truth.

What the program hands over is only judged: its `FrameResult`s and the
aligned clouds it keeps in its graph. The reference computes each judged
frame from the frame's raw input (wire or upload, voxel grid, hough
prefilter with its radius moments, overlap, trim ratio, ICP, accept gate,
corrected pose) against a reference cloud it prefilters itself from that
cloud's raw input. Which frame is the reference, and the correction that
placed it, it takes from the App's earlier results: it follows the App's
state frame by frame instead of replaying every frame. What that skips is
checked on its own: the first `start` frames after the bootstrap are
worked out on the reference's own chain of references and corrections;
the reference frame of every sampled frame is judged too
(`frames_to_judge`); the judged frames' poses relative to their
references' are held to the truth, which nothing of the program's made;
and in a synchronous App
every frame's reference id is held to the schedule the reference derives
from the accept flags.

Numbers (each held to its limit in `workloads/<cell>.json`; a frame the
App rejected keeps no cloud, so the cloud numbers skip it):

- `corr_gap_m`: the largest distance between where the App's and the
  reference's applied corrections (the ICP solution, or the identity
  for a rejected frame) put a point of the frame's filtered cloud;
- `pose_gap_m`: the same for the corrected poses, over the scan's points;
- `aligned_gap_m`: the 99th percentile of the distance from each point of
  the App's aligned cloud to the nearest of the reference's;
- `filtered_miss`: the share of filtered points (either side's) with no
  point of the other side within 1 mm, both clouds in the frame's input
  frame;
- `overlap_gap`: the gap of the voxel overlaps, in percentage points;
- `truth_link_m`: the median, over the judged frames the App accepted, of
  the largest distance between where the App's pose of the frame relative
  to its reference frame's and the true relative pose put a point of the
  frame's scan. Rare frames settle in a wrong minimum on both sides (the
  largest reading is logged with its frame); a median that moves means
  the registration as a whole has left the truth;
- `gate_mismatch`: judged frames whose accept gate differs (limit 0);
- `ref_id_mismatch`: frames whose reference id is not the schedule's
  (synchronous Apps; limit 0).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .reference import plain
from .reference.frame import FramePath, graph_index, reference_schedule

MATCH_TOL = 1e-3       # m: a filtered point counts as the same point
NUMBERS = ("corr_gap_m", "pose_gap_m", "aligned_gap_m", "filtered_miss",
           "overlap_gap", "truth_link_m", "gate_mismatch", "ref_id_mismatch")


@dataclasses.dataclass
class Judged:
    """What the App produced for one frame, as judged."""
    correction: np.ndarray
    accepted: bool
    corrected_pose: np.ndarray
    overlap: float
    reference_id: int
    aligned: np.ndarray | None      # (n, 3) the graph's cloud, or None
    n_iterations: int = 0


@dataclasses.dataclass
class Collected:
    """A run's frames as the check takes them, off the device."""
    supply: list       # (utime, points, prior) of every frame handed in
    truth: list        # each frame's true pose
    results: dict      # frame -> Judged: every frame's
    frames: list       # the frames to judge (`frames_to_judge`)
    start: int         # frames 1..start judged on the reference's chain


def frames_to_judge(accepted: list, frequency: int, pipelined: bool,
                    sample: list, start: int) -> list:
    """The first `start` frames after the bootstrap, `sample`, and the
    reference frame of each sampled frame, so that the correction a
    sampled frame's reference is placed by is judged, not only borrowed."""
    schedule = reference_schedule(accepted, frequency, pipelined)
    out = set(range(1, start + 1)) | set(sample)
    out |= {schedule[k] for k in sample if schedule[k]}
    return sorted(out)


def judged_from_app(app, frames: list) -> dict:
    """The App's result of every frame, with the aligned clouds its graph
    holds for `frames` and the bootstrap, copied to the host."""
    results = app.frames
    gidx = graph_index([r.accepted for r in results])
    keep = set(frames) | {0}
    out = {}
    for k, r in enumerate(results):
        aligned = None
        if r.accepted and k in keep:
            aligned = app.graph.clouds[gidx[k]].cloud.to_numpy()
        out[k] = Judged(np.asarray(r.correction, np.float32),
                        bool(r.accepted),
                        np.asarray(r.corrected_pose, np.float32),
                        float(r.octree_overlap), int(r.reference_id), aligned,
                        int(r.n_iterations))
    return out


def _max_move(A: np.ndarray, B: np.ndarray, pts: np.ndarray) -> float:
    """max over `pts` of |A p - B p| (4x4 transforms), in float64."""
    if len(pts) == 0:
        return 0.0
    D = np.asarray(A, np.float64) - np.asarray(B, np.float64)
    return float(np.linalg.norm(pts @ D[:3, :3].T + D[:3, 3], axis=1).max())


def _nn_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Distance from each row of `a` to the nearest row of `b`."""
    if len(b) == 0:
        return torch.full((len(a),), float("inf"), device=a.device)
    ones = torch.ones(len(a), dtype=torch.bool, device=a.device)
    d2, _ = plain.nn_payload(a, ones, b, torch.ones(
        len(b), dtype=torch.bool, device=b.device),
        torch.zeros((len(b), 1), device=b.device))
    return torch.sqrt(d2.double())


def _scan(supply_k) -> np.ndarray:
    """A frame's scan in the sensor frame, float64: its points are handed
    in the frame of its prior."""
    _, pts, prior = supply_k
    P = np.asarray(prior, np.float64)
    return (np.asarray(pts, np.float64) - P[:3, 3]) @ P[:3, :3]


def judge(config: dict, collected: Collected, device,
          pipelined: bool) -> dict:
    """The numbers of the comparison over `collected.frames` (indices into
    its supply; 0 the bootstrap), the first `collected.start` on the
    reference's own chain."""
    path = FramePath(config, device)
    freq = int(config["pipeline"]["reference_update_frequency"])
    supply, results = collected.supply, collected.results
    accepted = [results[k].accepted for k in range(len(supply))]
    cache = {}

    def pre(k):
        if k not in cache:
            _, pts, prior = supply[k]
            cache[k] = path.prefilter(pts, prior)
        return cache[k]

    eye = np.eye(4, dtype=np.float32)
    outcomes = {}
    # the start, on the reference's own chain
    own_acc, own_corr = [True], {0: None}
    for k in range(1, collected.start + 1):
        r = reference_schedule(own_acc + [True], freq, pipelined)[k]
        ref = path.reference_cloud(pre(r), own_corr[r])
        out = path.register(pre(k), supply[k][2], *ref)
        outcomes[k] = out
        own_acc.append(out.accepted)
        own_corr[k] = out.correction if out.accepted else eye
    # the frames judged from the App's state
    schedule = reference_schedule(accepted, freq, pipelined)
    for k in collected.frames:
        if k in outcomes:
            continue
        r = schedule[k]
        corr = (None if r == 0 else
                results[r].correction if accepted[r] else eye)
        ref = path.reference_cloud(pre(r), corr)
        outcomes[k] = path.register(pre(k), supply[k][2], *ref)

    nums = dict.fromkeys(NUMBERS[:6], 0.0)
    nums["gate_mismatch"] = 0
    worst = {}

    for k, out in outcomes.items():
        got = results[k]
        valid = out.filtered.points[out.filtered.mask].double().cpu().numpy()
        # the correction the App applies: a rejected frame keeps its prior
        gap = _max_move(got.correction if got.accepted else eye,
                        out.correction if out.accepted else eye, valid)
        if gap > nums["corr_gap_m"]:
            nums["corr_gap_m"] = gap
            worst["corr_gap_m"] = dict(
                frame=k, iterations=[got.n_iterations, out.n_iterations],
                accepted=[got.accepted, out.accepted])
        prior = np.asarray(supply[k][2], np.float64)
        scan = (valid - prior[:3, 3]) @ prior[:3, :3]
        nums["pose_gap_m"] = max(nums["pose_gap_m"], _max_move(
            got.corrected_pose, out.corrected_pose, scan))
        nums["overlap_gap"] = max(nums["overlap_gap"],
                                  abs(got.overlap - out.overlap))
        nums["gate_mismatch"] += int(got.accepted != out.accepted)
    # the truth: each judged frame's pose relative to its reference's
    truth = [np.asarray(t, np.float64) for t in collected.truth]
    pose = [np.asarray(results[k].corrected_pose, np.float64)
            for k in range(len(supply))]
    links = []
    for k in sorted(outcomes):
        r = schedule[k]
        if accepted[k]:
            links.append((_max_move(np.linalg.inv(pose[r]) @ pose[k],
                                    np.linalg.inv(truth[r]) @ truth[k],
                                    _scan(supply[k])), k, r))
    if links:
        nums["truth_link_m"] = float(np.median([g for g, _, _ in links]))
        g, k, r = max(links)
        worst["truth_link_max"] = dict(value=g, frame=k, reference=r)
    for k in sorted(set(outcomes) | {0}):
        got = results[k]
        if got.aligned is None:
            continue
        f = pre(k)
        ref_f = f.points[f.mask]
        mine = torch.as_tensor(got.aligned, device=path.device)
        if k in outcomes and outcomes[k].accepted:
            ref_a = outcomes[k].aligned_points[f.mask]
            nums["aligned_gap_m"] = max(nums["aligned_gap_m"], float(
                torch.quantile(_nn_dist(mine, ref_a), 0.99).item())
                if len(mine) else 0.0)
        # back to the input frame by the App's own correction
        C = np.linalg.inv(got.correction.astype(np.float64)) if k else \
            np.eye(4)
        back = torch.as_tensor(
            got.aligned.astype(np.float64) @ C[:3, :3].T + C[:3, 3],
            dtype=torch.float32, device=path.device)
        miss_a = (_nn_dist(back, ref_f) > MATCH_TOL).double().mean() \
            if len(back) else torch.tensor(0.0)
        miss_b = (_nn_dist(ref_f, back) > MATCH_TOL).double().mean() \
            if len(ref_f) else torch.tensor(0.0)
        nums["filtered_miss"] = max(nums["filtered_miss"],
                                    float(miss_a), float(miss_b))
    if not pipelined:
        gidx = graph_index(accepted)
        nums["ref_id_mismatch"] = sum(
            1 for k in range(1, len(supply))
            if results[k].reference_id != gidx[schedule[k]])
    return dict(numbers=nums, frames=sorted(outcomes), worst=worst,
                schedule=schedule,
                neighbours={k: cache[k].moments_count for k in cache})


def verdict(numbers: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}) over the numbers that have a
    limit."""
    table = {k: {"value": numbers[k], "limit": limits[k]}
             for k in NUMBERS if k in limits and k in numbers}
    return all(v["value"] <= v["limit"] for v in table.values()), table
