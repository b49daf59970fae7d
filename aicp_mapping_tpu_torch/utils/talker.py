"""Go-back-home path planning, numpy port of
`aicp_mapping_tpu.utils.talker` (the reference's ROSTalker without ROS):
the traversed path reversed, each pose turned so that its x-axis points
along the reversed trajectory, handed to any transport as a footstep plan
of 4x4 poses.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np


def angle_between_2d(v1: np.ndarray, v2: np.ndarray) -> float:
    """Signed angle (degrees) rotating v1 onto v2 about +z
    (talker_ros.cpp:73-80 semantics)."""
    a = np.arctan2(v2[1], v2[0]) - np.arctan2(v1[1], v1[0])
    return float(np.degrees(np.arctan2(np.sin(a), np.cos(a))))


def reverse_path(path: list[np.ndarray]) -> list[np.ndarray]:
    """Reverse the path and re-orient every pose along the new direction of
    travel; the final pose gets a 180-degree turn (talker_ros.cpp:43-71)."""
    out = [np.asarray(p, np.float64).copy() for p in reversed(path)]
    for i, p in enumerate(out):
        angle = 180.0
        if i != len(out) - 1:
            v1 = p[:2, 0]                                  # x-axis heading
            v2 = out[i + 1][:2, 3] - p[:2, 3]              # trajectory line
            if np.linalg.norm(v2) > 1e-9:
                angle = angle_between_2d(v1, v2)
        c, s = np.cos(np.deg2rad(angle)), np.sin(np.deg2rad(angle))
        rz = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
        p[:3, :3] = rz @ p[:3, :3]
    return [p.astype(np.float32) for p in out]


class Talker:
    """Publishes footstep plans through a plain callback."""

    def __init__(self, publish: Optional[Callable[[list[np.ndarray], int],
                                                  None]] = None):
        self.publish = publish
        self.last_plan: list[np.ndarray] = []

    def publish_footstep_plan(self, path: list[np.ndarray], utime: int,
                              reverse: bool = False) -> list[np.ndarray]:
        plan = reverse_path(path) if reverse else \
            [np.asarray(p, np.float32) for p in path]
        self.last_plan = plan
        if self.publish is not None:
            self.publish(plan, utime)
        return plan
