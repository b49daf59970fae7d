"""ANYmal's walk: a legged robot's closed lap through a hall and a long
corridor, scanned by a VLP-16 to 15 m, with a per-frame odometry error.

The world is `room_walk.room_cloud`'s room (floor, four walls, a 45-degree
ramp) at `room_size`, with a door of the corridor's width cut into its
east wall (x = room_size / 2), and a corridor through that door: two
parallel 3 m walls `corridor_width` apart and `corridor_length` long, with
their floor, open at the far end. Its points are spread over the
corridor's surfaces by area. The world is shuffled once, so that a cut of
the host voxel grid at capacity (first-touch order) keeps a uniform share
of every surface, as a lidar's sweeps interleave them.

The truth is one closed lap at `sensor_height`: `leg_frames` steps of
`step` metres east along one lane of the corridor's axis, from
`start_x` in the hall to deep inside the corridor, a turn of
`turn_frames` steps of `step` metres and 180 / turn_frames degrees each,
and the same back along the other lane into the hall and round. The two
halves are one motion, turned by 180 degrees, so the lap closes; the
lanes lie `step * cot(90 / turn_frames degrees)` apart, symmetric about
the axis. Where the corridor's walls and floor are all the sensor sees
(more than `sensor_range` from the hall's east wall and from the
corridor's far end), translation along the axis is unconstrained.

Each frame's scan is the world's points within `sensor_range` of the true
pose, in the sensor frame; its prior is the true pose moved by one frame's
odometry error (`room_walk`'s drift model), and the frame is handed in the
prior's frame. A run's seed draws where in the lap, on a stride of
`start_stride` frames, the walk starts.
"""
from __future__ import annotations

import numpy as np

from portbench.scenes.room_walk import room_cloud, yaw_transform

WALL_HEIGHT = 3.0       # room_cloud's walls


def corridor_cloud(n: int, x0: float, length: float, width: float,
                   rng: np.random.Generator) -> np.ndarray:
    """A floor strip and two walls along +x from `x0`, `n` points by
    area, without noise."""
    area = np.array([width, WALL_HEIGHT, WALL_HEIGHT]) * length
    counts = np.floor(n * area / area.sum()).astype(int)
    counts[0] += n - counts.sum()
    x = [rng.uniform(x0, x0 + length, (c, 1)) for c in counts]
    h = width / 2.0
    floor = np.concatenate([x[0], rng.uniform(-h, h, (counts[0], 1)),
                            np.zeros((counts[0], 1))], axis=1)
    walls = [np.concatenate([x[k], np.full((counts[k], 1), side),
                             rng.uniform(0, WALL_HEIGHT, (counts[k], 1))],
                            axis=1)
             for k, side in ((1, -h), (2, h))]
    return np.concatenate([floor] + walls)


def world_cloud(scene_seed: int, room_points: int, room_size: float,
                corridor_points: int, corridor_length: float,
                corridor_width: float, noise: float) -> np.ndarray:
    """The hall with its door and the corridor, noisy, shuffled."""
    room = room_cloud(room_points, room_size, scene_seed, noise)
    m = room_points // 6
    h = room_size / 2.0
    east = np.zeros(len(room), bool)
    east[4 * m:5 * m] = True                 # room_cloud's fifth plane
    door = east & (np.abs(room[:, 1]) < corridor_width / 2.0)
    rng = np.random.default_rng([scene_seed, 2])
    corridor = corridor_cloud(corridor_points, h, corridor_length,
                              corridor_width, rng)
    if noise > 0:
        corridor = corridor + rng.normal(0, noise, corridor.shape)
    world = np.concatenate([room[~door], corridor.astype(np.float32)])
    return world[rng.permutation(len(world))].astype(np.float32)


class AnymalWalk:
    """Frames, truth and priors of the lap."""

    def __init__(self, seed: int, *, scene_seed: int, room_points: int,
                 room_size: float, corridor_points: int,
                 corridor_length: float, corridor_width: float,
                 sensor_range: float, sensor_height: float, step: float,
                 start_x: float, leg_frames: int, turn_frames: int,
                 drift_per_frame: float, drift_yaw_deg: float, noise: float,
                 start_stride: int, device=None):
        world = world_cloud(scene_seed, room_points, room_size,
                            corridor_points, corridor_length,
                            corridor_width, noise)
        lane = step / np.tan(np.pi / (2 * turn_frames)) / 2.0
        straight = yaw_transform(0.0, [step, 0.0, 0.0])
        turn = yaw_transform(np.pi / turn_frames, [step, 0.0, 0.0])
        motion = ([straight] * leg_frames + [turn] * turn_frames) * 2
        self.lap = len(motion)
        T = np.eye(4, dtype=np.float32)
        T[:3, 3] = [start_x, -lane, sensor_height]
        rng = np.random.default_rng([scene_seed, 1])
        self.truth, self.priors, self.points = [], [], []
        for delta in motion:
            T = (T @ delta).astype(np.float32)
            d = np.linalg.norm(world - T[:3, 3], axis=1)
            visible = world[d < sensor_range]
            scan = (visible - T[:3, 3]) @ T[:3, :3]
            self.truth.append(T.copy())
            t = rng.normal(0, drift_per_frame, 3).astype(np.float32)
            t[2] *= 0.1
            dw = np.deg2rad(rng.normal(0, drift_yaw_deg))
            P = (T @ yaw_transform(dw, t)).astype(np.float32)
            self.priors.append(P)
            self.points.append(np.ascontiguousarray(
                (scan @ P[:3, :3].T + P[:3, 3]).astype(np.float32)))
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


def make(seed: int, device=None, **params) -> AnymalWalk:
    return AnymalWalk(seed, **params)
