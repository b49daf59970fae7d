"""Offline sequence runner + recorder and the synthetic sequence, PyTorch
port of `aicp_mapping_tpu.pipeline.sequence`.

`SequenceRunner` feeds clouds through `App.process_cloud`: from memory
(`run_clouds`) or from a recorded directory (`run_directory`:
`aicp_input_poses.csv` + `cloud_<i>_<sec>_<nsec>.pcd`, read one by one with
`io.pcd.read_cloud`; the JAX package's native prefetcher is not ported).
It runs synchronously: pipelined submission, its threaded wire prep and
the wire formats are ROADMAP Q1 #8. `SequenceRecorder` writes that
layout.
`synthetic_sequence` is a copy of the JAX function whose SO(3) exponential
runs in numpy float32 instead of jax.numpy.
"""
from __future__ import annotations

import os
from typing import Iterable, Optional

import numpy as np

from ..cloud import AlignedCloud, Cloud
from ..io.pcd import read_cloud, write_pcd
from ..io.poses import PoseWithTime, read_pose_csv, write_pose_csv
from ..tools.synthetic import room_cloud
from .app import FrameResult


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


class SequenceRunner:
    """Drives `App.process_cloud` frame by frame; results come out in
    order. `pipelined=True` (the JAX package's depth-1 submission
    pipeline) is ROADMAP Q1 #8 and raises."""

    def __init__(self, app, raw_capacity: Optional[int] = None,
                 pipelined: bool = False):
        if pipelined:
            raise NotImplementedError(
                "SequenceRunner(pipelined=True): pipelined submission is "
                "ROADMAP Q1 #8")
        self.app = app
        self.raw_capacity = raw_capacity or app.cfg.raw_capacity

    def _process(self, utime: int, pts: np.ndarray, pose) -> FrameResult:
        cloud = Cloud.from_numpy(pts, capacity=self.raw_capacity,
                                 device=self.app.device)
        return self.app.process_cloud(AlignedCloud.create(
            utime, cloud, np.asarray(pose, np.float32)))

    def run_directory(self, directory: str) -> list[FrameResult]:
        """Replay a recorded sequence, reading each cloud when its frame
        comes. A cloud over the raw capacity is cut to it by an even
        stride, as the JAX package's loader does; unreadable files are
        skipped."""
        poses = read_pose_csv(os.path.join(directory,
                                           "aicp_input_poses.csv"))
        cap = self.raw_capacity
        results = []
        for p in poses:
            path = os.path.join(directory,
                                f"cloud_{p.counter}_{p.sec}_{p.nsec}.pcd")
            try:
                pts, _ = read_cloud(path)
            except IOError:
                continue
            if len(pts) > cap:
                pts = pts[(np.arange(cap) * (len(pts) / cap)).astype(
                    np.int64)]
            results.append(self._process(p.utime, pts, p.pose))
        return results

    def run_clouds(self, items: Iterable[tuple[int, np.ndarray, np.ndarray]]
                   ) -> list[FrameResult]:
        """items: (utime, points (N, 3), prior_pose (4, 4))."""
        return [self._process(*item) for item in items]


class SequenceRecorder:
    """Writes clouds + the pose CSV in the replayable layout."""

    def __init__(self, directory: str):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        self._poses: list[PoseWithTime] = []
        self._counter = 0

    def record(self, utime: int, points: np.ndarray, pose: np.ndarray) -> None:
        sec = utime // 1_000_000
        nsec = utime - sec * 1_000_000
        p = PoseWithTime(self._counter, int(sec), int(nsec),
                         np.asarray(pose, np.float32))
        self._poses.append(p)
        write_pcd(os.path.join(
            self.directory, f"cloud_{p.counter}_{p.sec}_{p.nsec}.pcd"),
            points)
        self._counter += 1
        write_pose_csv(os.path.join(self.directory, "aicp_input_poses.csv"),
                       self._poses)
