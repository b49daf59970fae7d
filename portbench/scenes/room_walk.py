"""The bench walk: a lidar walking a closed circle through a 60 m room
world, with a per-frame odometry error.

Copies, at commit d49b34b8df308b6b17527cfdc9cc292ea998a7ca, of
`aicp_mapping_tpu_torch/tools/synthetic.py:room_cloud` (floor, four walls
and a 45-degree ramp) and of `aicp_mapping_tpu_torch/pipeline/sequence.py:
_yaw_transform` and the scan model of `synthetic_sequence` there (the
world points within `sensor_range` of the true pose, in the sensor frame).

The truth is one closed circle of `lap` frames (`step` metres and
`yaw_rate_deg` degrees a frame: 90 frames at 4 degrees). The lap is made
once from `scene_seed`: the room's points, the scans, and each frame's
prior, its true pose moved by one frame's odometry error
(`synthetic_sequence`'s drift model): the pose a state estimator that
fuses each correction hands the registration, so the error does not
accumulate across frames. A run walks the lap over and over from the
position its seed draws: every seed offers the same frames, in another
order, and a run may go on for as many laps as its window needs.
"""
from __future__ import annotations

import numpy as np


def room_cloud(n: int, size: float, seed: int, noise: float) -> np.ndarray:
    """Floor + 4 walls + one 45-degree ramp; constrains all 6 DoF."""
    rng = np.random.default_rng(seed)
    h = size / 2.0
    parts = []
    m = n // 6

    def plane(origin, u, v, extent_u, extent_v):
        a = rng.uniform(0, extent_u, (m, 1))
        b = rng.uniform(0, extent_v, (m, 1))
        return origin + a * np.asarray(u) + b * np.asarray(v)

    parts.append(plane([-h, -h, 0], [1, 0, 0], [0, 1, 0], size, size))
    parts.append(plane([-h, -h, 0], [1, 0, 0], [0, 0, 1], size, 3.0))
    parts.append(plane([-h, h, 0], [1, 0, 0], [0, 0, 1], size, 3.0))
    parts.append(plane([-h, -h, 0], [0, 1, 0], [0, 0, 1], size, 3.0))
    parts.append(plane([h, -h, 0], [0, 1, 0], [0, 0, 1], size, 3.0))
    s2 = 1.0 / np.sqrt(2.0)
    parts.append(plane([0, -h, 0], [0, 1, 0], [s2, 0, s2], size, 3.0))
    cloud = np.concatenate(parts).astype(np.float32)
    if noise > 0:
        cloud = cloud + rng.normal(0, noise, cloud.shape).astype(np.float32)
    return cloud


def yaw_transform(yaw: float, t) -> np.ndarray:
    """A yaw rotation and a translation in float32 (Rodrigues, Taylor
    branch below theta^2 = 1e-8)."""
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


class RoomWalk:
    """Scans (sensor frame), truth and priors of the bench walk."""

    def __init__(self, seed: int, *, scene_seed: int, world_points: int,
                 world_size: float, sensor_range: float, step: float,
                 yaw_rate_deg: float, lap: int, drift_per_frame: float,
                 drift_yaw_deg: float, noise: float, start_stride: int,
                 device=None):
        self.lap = int(lap)
        world = room_cloud(world_points, world_size, scene_seed, noise)
        delta = yaw_transform(np.deg2rad(yaw_rate_deg), [step, 0.0, 0.0])
        rng = np.random.default_rng([scene_seed, 1])
        T = np.eye(4, dtype=np.float32)
        self.truth, self.scans, self.priors, self.points = [], [], [], []
        for _ in range(self.lap):
            T = T @ delta
            d = np.linalg.norm(world - T[:3, 3], axis=1)
            visible = world[d < sensor_range]
            self.truth.append(T.copy())
            self.scans.append(np.ascontiguousarray(
                ((visible - T[:3, 3]) @ T[:3, :3]).astype(np.float32)))
            t = rng.normal(0, drift_per_frame, 3).astype(np.float32)
            t[2] *= 0.1
            dw = np.deg2rad(rng.normal(0, drift_yaw_deg))
            P = (T @ yaw_transform(dw, t)).astype(np.float32)
            self.priors.append(P)
            self.points.append((self.scans[-1] @ P[:3, :3].T
                                + P[:3, 3]).astype(np.float32))
        # starts on a stride of the reference update frequency, so that
        # every seed meets the same schedule of reference clouds
        self.offset = start_stride * int(np.random.default_rng(
            [int(seed), 3]).integers(self.lap // start_stride))

    def true_pose(self, i: int) -> np.ndarray:
        return self.truth[(self.offset + i) % self.lap]

    def prior(self, i: int) -> np.ndarray:
        return self.priors[(self.offset + i) % self.lap]

    def frame(self, i: int):
        """(utime, points in the prior's frame (n, 3) f32, prior (4, 4))."""
        j = (self.offset + i) % self.lap
        return i * 100_000, self.points[j], self.priors[j]


def make(seed: int, device=None, **params) -> RoomWalk:
    return RoomWalk(seed, **params)
