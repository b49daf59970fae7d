"""Padded, masked point-cloud containers, PyTorch port of
`aicp_mapping_tpu.cloud`. Points live in tensors on an explicit device;
poses stay host numpy. The int16 wire formats are not ported yet (ROADMAP
Q1 #8).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .geometry import se3


@dataclasses.dataclass(frozen=True)
class Cloud:
    """A fixed-capacity point cloud: points (N, 3) float32 (padding
    arbitrary, usually 0), mask (N,) bool."""

    points: torch.Tensor
    mask: torch.Tensor
    pre_voxelized: bool = False

    @property
    def capacity(self) -> int:
        return self.points.shape[0]

    def count(self) -> torch.Tensor:
        return self.mask.sum()

    def transform(self, T: torch.Tensor) -> "Cloud":
        return Cloud(se3.transform_points(T, self.points), self.mask,
                     self.pre_voxelized)

    @staticmethod
    def from_numpy(arr: np.ndarray, capacity: Optional[int] = None,
                   device=None) -> "Cloud":
        """Pad (or deterministically subsample) to `capacity`."""
        arr = np.asarray(arr, dtype=np.float32).reshape(-1, 3)
        n = arr.shape[0]
        cap = capacity if capacity is not None else n
        if n > cap:
            arr = arr[np.linspace(0, n - 1, cap).astype(np.int64)]
            n = cap
        pts = np.zeros((cap, 3), dtype=np.float32)
        pts[:n] = arr
        mask = np.zeros((cap,), dtype=bool)
        mask[:n] = True
        return Cloud.from_numpy_padded(pts, mask, device=device)

    @staticmethod
    def from_numpy_padded(points: np.ndarray, mask: np.ndarray,
                          device=None) -> "Cloud":
        """Wrap an already padded (capacity, 3) buffer and its mask."""
        return Cloud(torch.as_tensor(np.asarray(points, np.float32),
                                     device=device),
                     torch.as_tensor(np.asarray(mask, bool), device=device))

    def to_numpy(self) -> np.ndarray:
        pts = self.points.detach().cpu().numpy()
        return pts[self.mask.cpu().numpy()]


def repin_roll_pitch_np(corrected: np.ndarray,
                        odom: np.ndarray) -> np.ndarray:
    """Replace roll/pitch of `corrected` with odometry's, keeping yaw and
    translation (ZYX euler; removePitchRollCorrection semantics)."""
    R_o = np.asarray(odom, np.float64)[:3, :3]
    R_c = np.asarray(corrected, np.float64)[:3, :3]
    roll = np.arctan2(R_o[2, 1], R_o[2, 2])
    pitch = -np.arcsin(np.clip(R_o[2, 0], -1.0, 1.0))
    yaw = np.arctan2(R_c[1, 0], R_c[0, 0])
    cr, sr = np.cos(roll), np.sin(roll)
    cp, sp = np.cos(pitch), np.sin(pitch)
    cy, sy = np.cos(yaw), np.sin(yaw)
    R = np.array([
        [cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr],
        [sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr],
        [-sp, cp * sr, cp * cr],
    ])
    out = np.eye(4, dtype=np.float32)
    out[:3, :3] = R.astype(np.float32)
    out[:3, 3] = np.asarray(corrected, np.float32)[:3, 3]
    return out


@dataclasses.dataclass
class AlignedCloud:
    """Host record of one accumulated cloud and its poses: odom pose never
    changes; corrected = correction @ prior, roll/pitch re-pinned to
    odometry."""

    utime: int
    cloud: Cloud
    odom_pose: np.ndarray
    prior_pose: np.ndarray
    correction: np.ndarray
    corrected_pose: np.ndarray
    is_reference: bool = False
    its_reference_id: int = -1

    @staticmethod
    def create(utime: int, cloud: Cloud, prior_pose) -> "AlignedCloud":
        prior_pose = np.asarray(prior_pose, dtype=np.float32)
        return AlignedCloud(utime=utime, cloud=cloud, odom_pose=prior_pose,
                            prior_pose=prior_pose,
                            correction=np.eye(4, dtype=np.float32),
                            corrected_pose=prior_pose)

    def update(self, cloud: Cloud, correction=None,
               is_reference: bool = False,
               its_reference_id: Optional[int] = None) -> None:
        if correction is not None:
            self.correction = np.asarray(correction, dtype=np.float32)
        self.cloud = cloud
        corrected = np.asarray(self.correction) @ np.asarray(self.prior_pose)
        self.corrected_pose = repin_roll_pitch_np(corrected, self.odom_pose)
        self.is_reference = is_reference
        if its_reference_id is not None:
            self.its_reference_id = its_reference_id


class AlignedCloudsGraph:
    """Append-only list of aligned clouds + the current reference index."""

    def __init__(self) -> None:
        self.clouds: list = []
        self.current_reference_id: int = -1

    def is_empty(self) -> bool:
        return len(self.clouds) == 0

    def initialize(self, reference: AlignedCloud) -> None:
        reference.is_reference = True
        reference.its_reference_id = 0
        self.clouds = [reference]
        self.current_reference_id = 0

    def add(self, cloud: AlignedCloud) -> None:
        self.clouds.append(cloud)

    def update_reference(self, idx: int) -> None:
        self.clouds[idx].is_reference = True
        self.current_reference_id = idx

    @property
    def n_clouds(self) -> int:
        return len(self.clouds)

    def last(self) -> AlignedCloud:
        return self.clouds[-1]
