"""Outdoor-scale synthetic world + spinning-lidar simulator, a numpy copy of
`aicp_mapping_tpu.tools.urban` (which cannot be imported here: its package
imports JAX). An urban block world (ground plane + buildings) scanned by a
raycast spinning lidar: occlusion, range-dependent density and ground
dominance, as the SLAM and trajectory-accuracy regressions drive it.
`drive_trajectory` and `urban_sequence` make the same rng calls as the
JAX package's, so the drive, its scans and its drifting odometry are
JAX's to the bit. `write_kitti_drive` (the port's own) writes such a drive
in the KITTI odometry layout.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class UrbanWorld:
    boxes: np.ndarray  # (B, 6) [xmin ymin zmin xmax ymax zmax]
    extent: float      # half-size of the world square
    pitch: float       # street-centerline spacing (street grid period)


def make_urban_world(seed: int = 0, extent: float = 120.0,
                     pitch: float = 44.0, street: float = 14.0,
                     presence: float = 0.85) -> UrbanWorld:
    """City blocks on a grid. Street centerlines run along the lines
    x = -extent + i*pitch and y = -extent + j*pitch; building lots fill the
    cells between them (inset street/2 from each centerline), with random
    footprint jitter and height. Some lots are empty so the skyline is
    irregular."""
    rng = np.random.default_rng(seed)
    boxes = []
    k = int(np.floor(2 * extent / pitch))
    lot = pitch - street
    for i in range(k):
        for j in range(k):
            if rng.uniform() > presence:
                continue
            cx = -extent + (i + 0.5) * pitch
            cy = -extent + (j + 0.5) * pitch
            w = rng.uniform(0.55, 1.0) * lot
            d = rng.uniform(0.55, 1.0) * lot
            x0 = cx - w / 2 + rng.uniform(-2, 2)
            y0 = cy - d / 2 + rng.uniform(-2, 2)
            h = rng.uniform(5.0, 25.0)
            boxes.append([x0, y0, 0.0, x0 + w, y0 + d, h])
    return UrbanWorld(np.asarray(boxes, np.float32), extent, pitch)


def _ray_box_t(origins: np.ndarray, dirs: np.ndarray,
               boxes: np.ndarray) -> np.ndarray:
    """Slab test: first-hit parameter t for each (ray, box), inf if missed.

    origins (N, 3), dirs (N, 3) unit, boxes (B, 6) -> (N, B) float32.
    """
    inv = 1.0 / np.where(np.abs(dirs) < 1e-9, 1e-9, dirs)  # (N, 3)
    lo = boxes[None, :, :3]   # (1, B, 3)
    hi = boxes[None, :, 3:]   # (1, B, 3)
    t1 = (lo - origins[:, None, :]) * inv[:, None, :]
    t2 = (hi - origins[:, None, :]) * inv[:, None, :]
    t_enter = np.max(np.minimum(t1, t2), axis=2)
    t_exit = np.min(np.maximum(t1, t2), axis=2)
    # require an outside->in hit (t_enter > 0): rays starting inside a box
    # (a mis-placed sensor) produce no surface return
    hit = (t_enter <= t_exit) & (t_enter > 1e-3)
    t = np.where(hit, t_enter, np.inf)
    return t.astype(np.float32)


def velodyne_scan(world: UrbanWorld, T_sensor: np.ndarray,
                  n_beams: int = 64, n_azimuth: int = 1024,
                  min_range: float = 2.5, max_range: float = 70.0,
                  elev_min_deg: float = -24.8, elev_max_deg: float = 2.0,
                  noise: float = 0.02, seed: int = 0,
                  sensor_height: float = 1.73) -> np.ndarray:
    """One full revolution of an HDL-64-style scanner at `T_sensor`
    (vehicle body pose; the sensor sits `sensor_height` above it, the KITTI
    mount height). Returns sensor-frame points (M, 3) float32."""
    rng = np.random.default_rng(seed)
    elev = np.deg2rad(np.linspace(elev_min_deg, elev_max_deg, n_beams))
    azim = np.linspace(-np.pi, np.pi, n_azimuth, endpoint=False)
    ce, se_ = np.cos(elev), np.sin(elev)
    ca, sa = np.cos(azim), np.sin(azim)
    # (beams, azimuth, 3) sensor-frame directions
    dirs = np.stack([
        np.outer(ce, ca), np.outer(ce, sa),
        np.broadcast_to(se_[:, None], (n_beams, n_azimuth)),
    ], axis=-1).reshape(-1, 3).astype(np.float32)

    T = np.asarray(T_sensor, np.float64)
    R, t = T[:3, :3], T[:3, 3].copy()
    t[2] += sensor_height
    dirs_w = dirs @ R.T
    origins = np.broadcast_to(t, dirs_w.shape).astype(np.float64)

    # ground plane z = 0
    dz = dirs_w[:, 2]
    t_ground = np.where(dz < -1e-6, -t[2] / np.where(dz < -1e-6, dz, 1.0),
                        np.inf)
    # buildings
    t_boxes = _ray_box_t(origins.astype(np.float32),
                         dirs_w.astype(np.float32), world.boxes)
    t_hit = np.minimum(t_ground.astype(np.float32), np.min(t_boxes, axis=1))

    ok = (t_hit >= min_range) & (t_hit <= max_range)
    pts_w = origins[ok] + t_hit[ok, None].astype(np.float64) * dirs_w[ok]
    if noise > 0:
        pts_w = pts_w + rng.normal(0, noise, pts_w.shape)
    # back to the vehicle body frame (not the raised sensor frame)
    body = (pts_w - T[:3, 3]) @ R
    return body.astype(np.float32)


def drive_trajectory(n_frames: int, world: UrbanWorld | None = None,
                     speed: float = 10.0, hz: float = 10.0,
                     turn_frames: int = 8, seed: int = 0) -> np.ndarray:
    """Vehicle poses at scan rate, snapped to the street grid: straight
    segments at `speed` along a street centerline, with a 90-deg turn (yaw
    rate spread over `turn_frames` frames — the regime that stresses a
    constant-velocity prior) executed at every second intersection.
    Returns (n, 4, 4) float32."""
    if world is None:
        world = make_urban_world(seed=seed)
    step = speed / hz
    pitch = world.pitch
    # straight run between turns = 2 blocks minus the arc length
    seg_frames = max(int(round(2 * pitch / step)) - turn_frames, 1)
    poses = []
    T = np.eye(4, dtype=np.float64)
    # start at an interior intersection heading +x
    k = int(np.floor(2 * world.extent / pitch))
    T[:2, 3] = [-world.extent + pitch, -world.extent + (k // 2) * pitch]
    turn_sign = 1.0
    rng = np.random.default_rng(seed)
    period = seg_frames + turn_frames
    for i in range(n_frames):
        poses.append(T.astype(np.float32).copy())
        yaw = 0.0
        phase = i % period
        if phase >= seg_frames:
            yaw = turn_sign * (np.pi / 2) / turn_frames
            if phase == period - 1:
                turn_sign = -turn_sign if rng.uniform() < 0.6 else turn_sign
        c, s = np.cos(yaw), np.sin(yaw)
        dR = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
        T[:3, :3] = T[:3, :3] @ dR
        T[:3, 3] += T[:3, :3] @ np.array([step, 0.0, 0.0])
    return np.stack(poses)


def urban_sequence(n_frames: int = 60, seed: int = 0,
                   n_points_cap: int = 60000,
                   speed: float = 10.0,
                   drift_per_m: float = 0.01, drift_yaw_deg_per_m: float = 0.06,
                   noise: float = 0.02,
                   n_beams: int = 64, n_azimuth: int = 1024,
                   max_range: float = 70.0):
    """KITTI-style drive with odometry drift.

    Returns (items, gt_poses): items = (utime, points_in_odom_frame,
    odom_pose) — the SequenceRunner.run_clouds format — where the odometry
    accumulates translation drift per meter travelled and yaw drift (the
    dominant real-odometry error modes), so the pipeline has realistic
    errors to correct at road speed.
    """
    rng = np.random.default_rng(seed + 1)
    world = make_urban_world(seed=seed)
    gt = drive_trajectory(n_frames, world, speed=speed,
                          seed=seed).astype(np.float64)

    items = []
    T_odom = gt[0].copy()
    for i in range(n_frames):
        scan = velodyne_scan(world, gt[i], n_beams=n_beams,
                             n_azimuth=n_azimuth, max_range=max_range,
                             noise=noise, seed=seed + 10 + i)
        if len(scan) > n_points_cap:
            sel = rng.choice(len(scan), n_points_cap, replace=False)
            scan = scan[sel]
        if i > 0:
            delta = np.linalg.inv(gt[i - 1]) @ gt[i]
            dist = float(np.linalg.norm(delta[:3, 3]))
            dt = rng.normal(0, drift_per_m * dist, 3)
            dt[2] *= 0.2
            dyaw = np.deg2rad(rng.normal(0, drift_yaw_deg_per_m) * dist
                              + np.deg2rad(0.02) * dist)  # small yaw bias
            c, s = np.cos(dyaw), np.sin(dyaw)
            drift = np.eye(4)
            drift[:3, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
            drift[:3, 3] = dt
            T_odom = T_odom @ delta @ drift
        in_odom = scan @ T_odom[:3, :3].T + T_odom[:3, 3]
        items.append((i * 100_000, in_odom.astype(np.float32),
                      T_odom.astype(np.float32).copy()))
    return items, gt.astype(np.float32)


def write_kitti_drive(directory: str, n_frames: int, n_azimuth: int = 2048,
                      cap: int | None = None, scan_seed: int | None = None):
    """A drive through `make_urban_world(seed=0)` at 10 m/s in the KITTI
    odometry layout: `directory/velodyne/NNNNNN.bin` (float32 x y z
    intensity, the 64-beam scanner at `n_azimuth` azimuths, scan i's noise
    from seed i or from `scan_seed` for every scan, cut to `cap` points by
    a seeded draw) and
    `directory/gt.txt` (the truth relative to the first frame, KITTI
    format). Returns (scan directory, ground-truth file, truth (n, 4, 4),
    GPS-grade priors: the truth with 0.2 m of noise in x and y,
    float64)."""
    import os

    from ..io.poses import write_kitti_poses

    world = make_urban_world(seed=0)
    gt = drive_trajectory(n_frames, world, speed=10.0)
    scan_dir = os.path.join(directory, "velodyne")
    os.makedirs(scan_dir, exist_ok=True)
    rng = np.random.default_rng(0)
    for i, T in enumerate(gt):
        scan = velodyne_scan(world, T, n_azimuth=n_azimuth,
                             seed=i if scan_seed is None else scan_seed)
        if cap is not None and len(scan) > cap:
            scan = scan[rng.choice(len(scan), cap, replace=False)]
        np.concatenate([scan, np.zeros((len(scan), 1), np.float32)],
                       axis=1).astype(np.float32).tofile(
            os.path.join(scan_dir, f"{i:06d}.bin"))
    gt_path = os.path.join(directory, "gt.txt")
    write_kitti_poses(gt_path, np.linalg.inv(gt[0])[None] @ gt)
    priors = gt.astype(np.float64).copy()
    priors[:, :2, 3] += rng.normal(0, 0.2, (n_frames, 2))
    return scan_dir, gt_path, gt, priors
