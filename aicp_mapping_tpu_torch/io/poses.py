"""Pose file IO for the offline record/replay harness, a numpy copy of
`aicp_mapping_tpu.io.poses` (the quaternion of `write_pose_csv` by the
port's `se3.matrix_to_quat`).

Pose CSV (the reference's poseFileReader / writeCloudToFile schema):

  counter, sec, nsec, x, y, z, qx, qy, qz, qw

and KITTI odometry poses: 12 floats per line, the row-major 3x4.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class PoseWithTime:
    counter: int
    sec: int
    nsec: int
    pose: np.ndarray  # (4, 4) float32

    @property
    def utime(self) -> int:
        return self.sec * 1_000_000 + self.nsec


def _quat_to_matrix_np(qw, qx, qy, qz):
    n = max(np.sqrt(qw * qw + qx * qx + qy * qy + qz * qz), 1e-12)
    qw, qx, qy, qz = qw / n, qx / n, qy / n, qz / n
    return np.array([
        [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qw * qz),
         2 * (qx * qz + qw * qy)],
        [2 * (qx * qy + qw * qz), 1 - 2 * (qx * qx + qz * qz),
         2 * (qy * qz - qw * qx)],
        [2 * (qx * qz - qw * qy), 2 * (qy * qz + qw * qx),
         1 - 2 * (qx * qx + qy * qy)],
    ])


def read_pose_csv(path: str) -> list[PoseWithTime]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            row = [float(x) for x in line.split(",")]
            T = np.eye(4, dtype=np.float32)
            T[:3, 3] = row[3:6]
            T[:3, :3] = _quat_to_matrix_np(row[9], row[6], row[7], row[8])
            out.append(PoseWithTime(int(row[0]), int(row[1]), int(row[2]), T))
    return out


def write_pose_csv(path: str, poses: list[PoseWithTime]) -> None:
    import torch

    from ..geometry import se3

    with open(path, "w") as f:
        f.write("# counter, sec, nsec, x, y, z, qx, qy, qz, qw\n")
        for p in poses:
            q = se3.matrix_to_quat(torch.as_tensor(
                np.asarray(p.pose[:3, :3], np.float32))).numpy()
            t = p.pose[:3, 3]
            f.write(
                f"{p.counter}, {p.sec}, {p.nsec}, "
                f"{t[0]}, {t[1]}, {t[2]}, {q[1]}, {q[2]}, {q[3]}, {q[0]}\n")


def read_kitti_poses(path: str) -> np.ndarray:
    """KITTI format: N lines of 12 floats (row-major 3x4). Returns (N,4,4)."""
    data = np.loadtxt(path).reshape(-1, 3, 4)
    out = np.tile(np.eye(4, dtype=np.float64), (data.shape[0], 1, 1))
    out[:, :3, :4] = data
    return out.astype(np.float32)


def write_kitti_poses(path: str, poses: np.ndarray) -> None:
    poses = np.asarray(poses).reshape(-1, 4, 4)
    with open(path, "w") as f:
        for T in poses:
            f.write(" ".join(f"{v:.9e}" for v in T[:3, :4].reshape(-1)) + "\n")
