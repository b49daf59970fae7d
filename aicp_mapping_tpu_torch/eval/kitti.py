"""Trajectory metrics, a numpy copy of part of `aicp_mapping_tpu.eval.kitti`:
the Umeyama alignment and the absolute trajectory error. The KITTI
segment errors and RPE are ROADMAP Q1 #14.
"""
from __future__ import annotations

import numpy as np


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
    return R, mu_d - R @ mu_s


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
