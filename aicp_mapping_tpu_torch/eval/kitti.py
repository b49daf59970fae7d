"""KITTI odometry evaluation + ATE/RPE metrics, a numpy copy of
`aicp_mapping_tpu.eval.kitti` (its results equal to 1e-12).

Re-implementation of the KITTI devkit evaluator semantics bundled with the
reference (aicp_lcm/src/tools/kitti_devkit/evaluate_odometry.cpp):
  - segment-based translational / rotational errors over lengths
    {100,...,800} m with start frames every 10 (evaluate_odometry.cpp:27-29,
    calcSequenceErrors :95-140)
  - rotationError = acos((trace(R)-1)/2), translationError = |t|
    of the relative-pose delta (:80-93)
plus absolute trajectory error (Umeyama-aligned RMSE) and relative pose
error, which the reference computes offline via its Python/Vicon scripts
(python/compute_transl_rot_errors.py).
"""
from __future__ import annotations

import dataclasses

import numpy as np

LENGTHS = (100.0, 200.0, 300.0, 400.0, 500.0, 600.0, 700.0, 800.0)


@dataclasses.dataclass
class SegmentError:
    first_frame: int
    r_err: float   # rad per meter
    t_err: float   # translation error fraction (m per m)
    length: float
    speed: float


def trajectory_distances(poses: np.ndarray) -> np.ndarray:
    """Cumulative driven distance per frame (evaluate_odometry.cpp:60-70)."""
    p = np.asarray(poses)[:, :3, 3]
    steps = np.linalg.norm(np.diff(p, axis=0), axis=1)
    return np.concatenate([[0.0], np.cumsum(steps)])


def _rotation_error(E: np.ndarray) -> float:
    a = np.clip(0.5 * (np.trace(E[:3, :3]) - 1.0), -1.0, 1.0)
    return float(np.arccos(a))


def _translation_error(E: np.ndarray) -> float:
    return float(np.linalg.norm(E[:3, 3]))


def calc_sequence_errors(poses_gt: np.ndarray, poses_result: np.ndarray,
                         lengths=LENGTHS, step_size: int = 10
                         ) -> list[SegmentError]:
    """Per-segment errors (calcSequenceErrors, evaluate_odometry.cpp:95-140)."""
    poses_gt = np.asarray(poses_gt)
    poses_result = np.asarray(poses_result)
    n = min(len(poses_gt), len(poses_result))
    dist = trajectory_distances(poses_gt[:n])
    errors = []
    for first in range(0, n, step_size):
        for length in lengths:
            target = dist[first] + length
            last = int(np.searchsorted(dist, target))
            if last >= n:
                continue
            pose_delta_gt = (np.linalg.inv(poses_gt[first]) @ poses_gt[last])
            pose_delta_res = (np.linalg.inv(poses_result[first])
                              @ poses_result[last])
            E = np.linalg.inv(pose_delta_res) @ pose_delta_gt
            r_err = _rotation_error(E) / length
            t_err = _translation_error(E) / length
            num_frames = last - first + 1
            speed = length / (0.1 * num_frames)  # 10 Hz assumption (devkit)
            errors.append(SegmentError(first, r_err, t_err, length, speed))
    return errors


def average_errors(errors: list[SegmentError]) -> dict:
    """Average t_err (%) and r_err (deg/m) — the devkit's stats output."""
    if not errors:
        return {"t_err_percent": float("nan"), "r_err_deg_per_m": float("nan"),
                "n_segments": 0}
    t = float(np.mean([e.t_err for e in errors])) * 100.0
    r = float(np.mean([e.r_err for e in errors])) * 180.0 / np.pi
    return {"t_err_percent": t, "r_err_deg_per_m": r,
            "n_segments": len(errors)}


def umeyama_alignment(src: np.ndarray, dst: np.ndarray):
    """Rigid SE(3) alignment (no scale) of src onto dst point sets (N, 3)."""
    mu_s = src.mean(0)
    mu_d = dst.mean(0)
    cov = (dst - mu_d).T @ (src - mu_s) / len(src)
    U, _, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    t = mu_d - R @ mu_s
    return R, t


def ate_rmse(poses_gt: np.ndarray, poses_result: np.ndarray,
             align: bool = True) -> float:
    """Absolute trajectory error (RMSE over positions, meters)."""
    gt = np.asarray(poses_gt)[:, :3, 3]
    res = np.asarray(poses_result)[:, :3, 3]
    n = min(len(gt), len(res))
    gt, res = gt[:n], res[:n]
    if align and n >= 3:
        R, t = umeyama_alignment(res, gt)
        res = res @ R.T + t
    return float(np.sqrt(np.mean(np.sum((gt - res) ** 2, axis=1))))


def rpe(poses_gt: np.ndarray, poses_result: np.ndarray, delta: int = 1):
    """Relative pose error over a fixed frame delta. Returns dict with
    translational RMSE (m) and rotational RMSE (deg)."""
    gt = np.asarray(poses_gt)
    res = np.asarray(poses_result)
    n = min(len(gt), len(res))
    t_errs, r_errs = [], []
    for i in range(n - delta):
        dgt = np.linalg.inv(gt[i]) @ gt[i + delta]
        dres = np.linalg.inv(res[i]) @ res[i + delta]
        E = np.linalg.inv(dres) @ dgt
        t_errs.append(_translation_error(E))
        r_errs.append(_rotation_error(E))
    return {
        "rpe_trans_rmse_m": float(np.sqrt(np.mean(np.square(t_errs)))),
        "rpe_rot_rmse_deg": float(
            np.sqrt(np.mean(np.square(r_errs))) * 180.0 / np.pi),
    }
