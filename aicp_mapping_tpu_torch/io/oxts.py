"""KITTI raw OXTS (GPS/IMU) parsing and trajectory conversion, a numpy copy
of `aicp_mapping_tpu.io.oxts`.

Re-implements the pose math of the reference's KITTI trajectory publisher
(aicp_lcm/src/tools/kitti_trajectory_from_raw_gps.cpp:206-300): Mercator
projection scaled at the first latitude, roll/pitch/yaw to rotation, poses
rebased so the first frame is the identity. Each `oxts/data/*.txt` record
holds 30 values; the first six are lat, lon, alt, roll, pitch, yaw.
"""
from __future__ import annotations

import os

import numpy as np

EARTH_RADIUS = 6378137.0


def lat_to_scale(lat_deg: float) -> float:
    return float(np.cos(np.deg2rad(lat_deg)))


def latlon_to_mercator(lat_deg, lon_deg, scale):
    mx = scale * np.deg2rad(lon_deg) * EARTH_RADIUS
    my = scale * EARTH_RADIUS * np.log(
        np.tan(np.deg2rad(90.0 + lat_deg) / 2.0))
    return mx, my


def _rotation_rpy(roll, pitch, yaw) -> np.ndarray:
    cr, sr = np.cos(roll), np.sin(roll)
    cp, sp = np.cos(pitch), np.sin(pitch)
    cy, sy = np.cos(yaw), np.sin(yaw)
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    return Rz @ Ry @ Rx


def oxts_records_to_poses(records: np.ndarray) -> np.ndarray:
    """(N, >=6) [lat lon alt roll pitch yaw ...] -> (N, 4, 4) poses with
    pose[0] = identity (convertOxtsToPose semantics)."""
    records = np.atleast_2d(np.asarray(records, np.float64))
    scale = lat_to_scale(records[0, 0])
    poses = []
    T0_inv = None
    for rec in records:
        lat, lon, alt, roll, pitch, yaw = rec[:6]
        mx, my = latlon_to_mercator(lat, lon, scale)
        T = np.eye(4)
        T[:3, :3] = _rotation_rpy(roll, pitch, yaw)
        T[:3, 3] = [mx, my, alt]
        if T0_inv is None:
            T0_inv = np.linalg.inv(T)
        poses.append(T0_inv @ T)
    return np.stack(poses).astype(np.float32)


def read_oxts_directory(directory: str) -> np.ndarray:
    """Read a KITTI raw `oxts/data/` directory of per-frame txt records."""
    data_dir = os.path.join(directory, "data") \
        if os.path.isdir(os.path.join(directory, "data")) else directory
    names = sorted(f for f in os.listdir(data_dir) if f.endswith(".txt"))
    records = [np.loadtxt(os.path.join(data_dir, f)) for f in names]
    return oxts_records_to_poses(np.stack(records))
