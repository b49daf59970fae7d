"""Padded, masked point-cloud containers, PyTorch port of
`aicp_mapping_tpu.cloud`. Points live in tensors on an explicit device;
poses stay host numpy.

The int16 wire format ships a cloud as fixed-point offsets `q` with a
per-axis `scale` and `center` and rebuilds the mask on the device from the
count. The device dequantizes `q * scale + center` rounded once, as a
fused multiply-add (`_dequantize`): the same bits on the CPU and the card.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .geometry import se3
from .native import quantize_q16


def _fma_f32(q: torch.Tensor, scale: torch.Tensor,
             center: torch.Tensor) -> torch.Tensor:
    """`q * scale + center` in f32, rounded once: the int16 x f32 product
    is exact in f64, the f64 sum is rounded to odd (its exact remainder by
    two-sum decides), and one rounding to f32 then gives the correctly
    rounded result on any device."""
    p = q.to(torch.float64) * scale.to(torch.float64)
    c = center.to(torch.float64).expand_as(p)
    s = p + c
    bp = s - c
    err = (p - bp) + (c - (s - bp))
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.full_like(s, float("inf")),
                         torch.full_like(s, float("-inf")))
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.to(torch.float32)


def _dequantize(q: torch.Tensor, scale: torch.Tensor, center: torch.Tensor,
                count) -> "Cloud":
    """The device side of the int16 wire format: points and the mask of the
    first `count` rows, on `q`'s device."""
    mask = torch.arange(q.shape[0], device=q.device) < int(count)
    return Cloud(_fma_f32(q, scale, center), mask)


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
                   device=None, quantize: bool = False) -> "Cloud":
        """Pad (or deterministically subsample) to `capacity`. With
        `quantize` the points cross to the device as int16 (6 bytes a
        point and no mask) and are dequantized there."""
        arr = np.asarray(arr, dtype=np.float32).reshape(-1, 3)
        n = arr.shape[0]
        cap = capacity if capacity is not None else n
        if n > cap:
            arr = arr[np.linspace(0, n - 1, cap).astype(np.int64)]
            n = cap
        if quantize and n > 0:
            q = np.zeros((cap, 3), dtype=np.int16)
            q[:n], scale, center = quantize_q16(arr)
            return Cloud.from_wire_q16(q, scale, center, n, device=device)
        pts = np.zeros((cap, 3), dtype=np.float32)
        pts[:n] = arr
        mask = np.zeros((cap,), dtype=bool)
        mask[:n] = True
        return Cloud.from_numpy_padded(pts, mask, device=device)

    @staticmethod
    def from_wire_q16(q: np.ndarray, scale: np.ndarray, center: np.ndarray,
                      count: int, device=None) -> "Cloud":
        """Ship a quantized payload (`native.voxel_downsample_q16`) to
        `device` and dequantize it there."""
        def put(a, dtype):
            return torch.as_tensor(np.asarray(a, dtype), device=device)

        return _dequantize(put(q, np.int16), put(scale, np.float32),
                           put(center, np.float32), count)

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


@dataclasses.dataclass(frozen=True)
class NormalCloud:
    """A cloud with per-point normals and curvature: points and normals
    (N, 3) float32, curvature (N,), mask (N,) bool."""

    points: torch.Tensor
    normals: torch.Tensor
    curvature: torch.Tensor
    mask: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.points.shape[0]

    def count(self) -> torch.Tensor:
        return self.mask.sum()

    def as_cloud(self) -> Cloud:
        return Cloud(self.points, self.mask)

    def transform(self, T: torch.Tensor) -> "NormalCloud":
        return NormalCloud(se3.transform_points(T, self.points),
                           se3.rotate_vectors(T, self.normals),
                           self.curvature, self.mask)


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

    def current_reference(self) -> AlignedCloud:
        return self.clouds[self.current_reference_id]

    def last(self) -> AlignedCloud:
        return self.clouds[-1]
