"""The comparison that decides `correct` where failure prediction is on:
`check.judge`'s, with the risk stage and its gate in the reference frame
and in its schedule of references.

Each judged frame is worked out again as `check.py` says (the wire, the
voxel grid, the hough prefilter, the overlap, the trim ratio, ICP, the
accept gate), and besides by `reference.risk.RiskPath` against the same
reference cloud at the App's reference pose: the FOV overlap, the
alignability and P(failure), and the risk gate. A risk-gated frame keeps
its prior (its correction is the identity, its aligned cloud its filtered
cloud, and the App counts it accepted, not registered) and becomes the
reference of the next frame, as `pipeline/app.py` forces the update
(`reference_schedule`). The synchronous App only: each frame's reference
is fixed when it is dispatched.

Numbers, beside `check.NUMBERS` (each held to its limit in
`workloads/<cell>.json`):

- `risk_gap`: the widest gap between the App's and the reference's
  P(failure);
- `align_gap`: the same for alignability, in points;
- `fov_gap`: the same for the FOV overlap, in points of percent;
- `risk_gate_mismatch`: judged frames whose risk gate differs (limit 0).
  A frame whose reference P(failure) lies within `NEAR_THRESHOLD` of the
  threshold is not held to it: the reference takes the App's decision
  there and is held to everything else; such frames are counted
  (`risk_near_threshold`, not a limit) and logged with the widest.

`truth_link_m` is taken over the frames the App registered: a risk-gated
frame keeps its prior by design, and its link to its reference is the
odometry's error, not the registration's.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import check
from .reference import plain
from .reference.frame import FramePath, graph_index
from .reference.risk import RiskPath

RISK_NUMBERS = ("risk_gap", "align_gap", "fov_gap", "risk_gate_mismatch")
# the `risk_gap` limit of the cells this module judges
# (portbench/tests/test_portbench_fp.py holds them equal)
NEAR_THRESHOLD = 0.001

# `check.verdict` tables the numbers `check.NUMBERS` names
check.NUMBERS = check.NUMBERS + tuple(
    n for n in RISK_NUMBERS if n not in check.NUMBERS)


@dataclasses.dataclass
class Collected(check.Collected):
    """`check.Collected`, with each frame's (FOV overlap, alignability,
    P(failure), registered) as the App reported them."""
    risk: dict = dataclasses.field(default_factory=dict)


def gated_flags(accepted: list, registered: list) -> list:
    """A frame after the bootstrap that the App accepted and did not
    register was risk-gated."""
    return [k > 0 and a and not r
            for k, (a, r) in enumerate(zip(accepted, registered))]


def reference_schedule(accepted: list, gated: list, frequency: int) -> list:
    """For frames 0..n-1 (0 the bootstrap), their accept flags and their
    risk gates, the frame each registers against in a synchronous App: the
    bootstrap, then every `frequency`-th accepted frame since the last
    reference, or a risk-gated frame at once."""
    refs, ref, since = [None], 0, 0
    for k in range(1, len(accepted)):
        refs.append(ref)
        if gated[k]:
            ref, since = k, 0
        elif accepted[k]:
            since += 1
            if since % frequency == 0:
                ref, since = k, 0
    return refs


def frames_to_judge(accepted: list, gated: list, frequency: int,
                    sample: list, start: int) -> list:
    """`check.frames_to_judge` on this schedule."""
    schedule = reference_schedule(accepted, gated, frequency)
    out = set(range(1, start + 1)) | set(sample)
    out |= {schedule[k] for k in sample if schedule[k]}
    return sorted(out)


@dataclasses.dataclass
class Outcome:
    """`reference.frame.Outcome` (before the risk gate) with the risk
    stage, the gate the frame follows and whether its P(failure) lies
    within NEAR_THRESHOLD of the threshold."""
    frame: object        # reference.frame.Outcome
    risk: object         # reference.risk.Risk
    gated: bool
    near: bool
    prior: np.ndarray

    @property
    def accepted(self) -> bool:
        return self.gated or self.frame.accepted

    @property
    def applied(self) -> np.ndarray:
        """The correction the frame keeps."""
        if self.gated or not self.frame.accepted:
            return np.eye(4, dtype=np.float32)
        return self.frame.correction

    @property
    def corrected_pose(self) -> np.ndarray:
        if self.gated:
            prior = np.asarray(self.prior, np.float32)
            return plain.repin_roll_pitch_np(prior, prior)
        return self.frame.corrected_pose

    @property
    def aligned_points(self) -> torch.Tensor:
        if self.gated:
            return self.frame.filtered.points
        return self.frame.aligned_points


def judge(config: dict, collected: Collected, device) -> dict:
    """The numbers of the comparison over `collected.frames`, the first
    `collected.start` on the reference's own chain (`check.judge`)."""
    path = FramePath(config, device)
    risk_path = RiskPath(config, device)
    threshold = float(config["pipeline"]["risk_threshold"])
    freq = int(config["pipeline"]["reference_update_frequency"])
    supply, results = collected.supply, collected.results
    n = len(supply)
    accepted = [results[k].accepted for k in range(n)]
    gated = gated_flags(accepted, [collected.risk[k][3] for k in range(n)])
    cache = {}

    def pre(k):
        if k not in cache:
            _, pts, prior = supply[k]
            cache[k] = path.prefilter(pts, prior)
        return cache[k]

    def register(k, ref, ref_pose):
        """Frame k against `ref` (points, normals, mask) at `ref_pose`;
        near the threshold the App's gate decides."""
        prior = supply[k][2]
        out = path.register(pre(k), prior, *ref)
        f = pre(k)
        r = risk_path.stage(ref[0], ref[2], ref_pose, f.points, f.mask,
                            prior, out.overlap)
        near = abs(r.risk - threshold) <= NEAR_THRESHOLD
        return Outcome(out, r, gated[k] if near else r.gated, near, prior)

    eye = np.eye(4, dtype=np.float32)
    outcomes = {}
    # the start, on the reference's own chain
    prior0 = np.asarray(supply[0][2], np.float32)
    own_acc, own_gated = [True], [False]
    own_corr = {0: None}
    own_pose = {0: plain.repin_roll_pitch_np(prior0, prior0)}
    for k in range(1, collected.start + 1):
        r = reference_schedule(own_acc + [True], own_gated + [False],
                               freq)[k]
        out = register(k, path.reference_cloud(pre(r), own_corr[r]),
                       own_pose[r])
        outcomes[k] = out
        own_acc.append(out.accepted)
        own_gated.append(out.gated)
        own_corr[k] = out.applied
        own_pose[k] = out.corrected_pose
    # the frames judged from the App's state
    schedule = reference_schedule(accepted, gated, freq)
    for k in collected.frames:
        if k in outcomes:
            continue
        r = schedule[k]
        corr = (None if r == 0 else
                results[r].correction if accepted[r] else eye)
        outcomes[k] = register(k, path.reference_cloud(pre(r), corr),
                               results[r].corrected_pose)

    nums = dict.fromkeys(check.NUMBERS[:6] + RISK_NUMBERS[:3], 0.0)
    nums.update(gate_mismatch=0, risk_gate_mismatch=0)
    worst, near = {}, []
    for k, out in outcomes.items():
        got = results[k]
        fov, align, risk, _ = collected.risk[k]
        valid = out.frame.filtered.points[
            out.frame.filtered.mask].double().cpu().numpy()
        gap = check._max_move(got.correction if got.accepted else eye,
                              out.applied, valid)
        if gap > nums["corr_gap_m"]:
            nums["corr_gap_m"] = gap
            worst["corr_gap_m"] = dict(
                frame=k, iterations=[got.n_iterations,
                                     out.frame.n_iterations],
                accepted=[got.accepted, out.accepted],
                gated=[gated[k], out.gated])
        prior = np.asarray(supply[k][2], np.float64)
        scan = (valid - prior[:3, 3]) @ prior[:3, :3]
        nums["pose_gap_m"] = max(nums["pose_gap_m"], check._max_move(
            got.corrected_pose, out.corrected_pose, scan))
        nums["overlap_gap"] = max(nums["overlap_gap"],
                                  abs(got.overlap - out.frame.overlap))
        nums["gate_mismatch"] += int(got.accepted != out.accepted)
        for name, mine, theirs in (("risk_gap", risk, out.risk.risk),
                                   ("align_gap", align,
                                    out.risk.alignability),
                                   ("fov_gap", fov, out.risk.fov)):
            if abs(mine - theirs) > nums[name]:
                nums[name] = abs(mine - theirs)
                worst[name] = dict(frame=k, app=mine, reference=theirs)
        if out.near:
            near.append(dict(frame=k, app=risk, reference=out.risk.risk,
                             gated=gated[k]))
        else:
            nums["risk_gate_mismatch"] += int(gated[k] != out.risk.gated)
    nums["risk_near_threshold"] = len(near)
    if near:
        worst["risk_near_threshold"] = near
    # the truth: each judged registered frame's pose relative to its
    # reference's
    truth = [np.asarray(t, np.float64) for t in collected.truth]
    pose = [np.asarray(results[k].corrected_pose, np.float64)
            for k in range(n)]
    links = []
    for k in sorted(outcomes):
        r = schedule[k]
        if accepted[k] and not gated[k]:
            links.append((check._max_move(np.linalg.inv(pose[r]) @ pose[k],
                                          np.linalg.inv(truth[r]) @ truth[k],
                                          check._scan(supply[k])), k, r))
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
                torch.quantile(check._nn_dist(mine, ref_a), 0.99).item())
                if len(mine) else 0.0)
        C = np.linalg.inv(got.correction.astype(np.float64)) if k else \
            np.eye(4)
        back = torch.as_tensor(
            got.aligned.astype(np.float64) @ C[:3, :3].T + C[:3, 3],
            dtype=torch.float32, device=path.device)
        miss_a = (check._nn_dist(back, ref_f) > check.MATCH_TOL).double(
        ).mean() if len(back) else torch.tensor(0.0)
        miss_b = (check._nn_dist(ref_f, back) > check.MATCH_TOL).double(
        ).mean() if len(ref_f) else torch.tensor(0.0)
        nums["filtered_miss"] = max(nums["filtered_miss"],
                                    float(miss_a), float(miss_b))
    gidx = graph_index(accepted)
    nums["ref_id_mismatch"] = sum(
        1 for k in range(1, n) if results[k].reference_id != gidx[schedule[k]])
    return dict(numbers=nums, frames=sorted(outcomes), worst=worst,
                schedule=schedule,
                neighbours={k: cache[k].moments_count for k in cache})
