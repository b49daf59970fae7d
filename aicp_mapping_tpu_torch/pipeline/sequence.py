"""Synthetic lidar sequence (numpy only), a copy of
`aicp_mapping_tpu.pipeline.sequence.synthetic_sequence` whose SO(3)
exponential runs in numpy float32 instead of jax.numpy. The sequence
runner, recorder and wire formats are not ported yet (ROADMAP Q1 #8).
"""
from __future__ import annotations

import numpy as np

from ..tools.synthetic import room_cloud


def _yaw_transform(yaw: float, t) -> np.ndarray:
    """make_transform(so3_exp([0, 0, yaw]), t) in float32, with the JAX
    package's Rodrigues formula (Taylor branch below theta^2 = 1e-8)."""
    w = np.asarray([0.0, 0.0, yaw], np.float32)
    theta2 = np.float32(np.sum(w * w))
    theta = np.float32(np.sqrt(max(theta2, np.float32(1e-18))))
    K = np.array([[0.0, -w[2], w[1]], [w[2], 0.0, -w[0]],
                  [-w[1], w[0], 0.0]], np.float32)
    if theta2 < 1e-8:
        A = np.float32(1.0 - theta2 / 6.0)
        B = np.float32(0.5 - theta2 / 24.0)
    else:
        A = np.float32(np.sin(theta) / theta)
        B = np.float32((1.0 - np.cos(theta)) / theta2)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = np.eye(3, dtype=np.float32) + A * K + B * (K @ K)
    T[:3, 3] = np.asarray(t, np.float32)
    return T


def synthetic_sequence(
    n_frames: int = 10,
    n_points: int = 8000,
    step: float = 0.8,
    yaw_rate_deg: float = 4.0,
    drift_per_frame: float = 0.03,
    drift_yaw_deg: float = 0.4,
    noise: float = 0.01,
    seed: int = 0,
    world_size: float = 18.0,
    sensor_range: float = 14.0,
):
    """Simulated lidar walk through a room world with odometry drift.

    Returns (items, gt_poses): items = (utime, points_in_odom_frame,
    odom_pose); gt_poses are the true world poses."""
    rng = np.random.default_rng(seed)
    world = room_cloud(n=60000, size=world_size, seed=seed, noise=noise)

    items = []
    gt_poses = []
    T_true = np.eye(4, dtype=np.float32)
    T_odom = np.eye(4, dtype=np.float32)
    for i in range(n_frames):
        delta = _yaw_transform(np.deg2rad(yaw_rate_deg), [step, 0.0, 0.0])
        T_true = T_true @ delta
        drift_t = rng.normal(0, drift_per_frame, 3).astype(np.float32)
        drift_t[2] *= 0.1
        dw = np.deg2rad(rng.normal(0, drift_yaw_deg))
        T_odom = T_odom @ delta @ _yaw_transform(dw, drift_t)

        d = np.linalg.norm(world - T_true[:3, 3], axis=1)
        visible = world[d < sensor_range]
        if len(visible) > n_points:
            visible = visible[rng.choice(len(visible), n_points,
                                         replace=False)]
        local = (visible - T_true[:3, 3]) @ T_true[:3, :3]
        in_odom = local @ T_odom[:3, :3].T + T_odom[:3, 3]
        items.append((i * 1_000_000, in_odom.astype(np.float32),
                      T_odom.copy()))
        gt_poses.append(T_true.copy())
    return items, np.stack(gt_poses)
