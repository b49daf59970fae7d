"""End-to-end KITTI odometry runner, PyTorch port of
`aicp_mapping_tpu.eval.kitti_runner`.

Velodyne `.bin` scans stream through `native.SequencePrefetcher`, take the
config's wire format (`pipeline.sequence.wire_cloud`) or go up as raw
clouds, optionally lose their ground points (`ops.ground.remove_ground`,
on the device), and run through the App; a constant-velocity motion model,
or the relative motion of a prior trajectory (GPS), gives each frame's
prior. The trajectory feeds `eval.kitti`'s metrics. Runs on the card
unless the caller asks for the CPU.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from ..cloud import AlignedCloud, Cloud
from ..native import SequencePrefetcher
from ..pipeline.app import App, FrameResult, check_device
from ..pipeline.config import PipelineConfig


def list_velodyne_scans(directory: str) -> list[str]:
    names = sorted(f for f in os.listdir(directory) if f.endswith(".bin"))
    return [os.path.join(directory, f) for f in names]


def kitti_config() -> PipelineConfig:
    """The KITTI default: HDL-64 widths (131,072 raw points, 32,768 voxels,
    16,384 filtered), an 80 m sensor range, and normal-space trimming —
    without ground removal, a horizontal prior error leaves ground matches
    at ~zero distance and a global trim quantile discards exactly the
    facade correspondences that constrain it."""
    cfg = PipelineConfig(
        raw_capacity=131072, downsample_capacity=32768,
        filtered_capacity=16384, sensor_range=80.0,
        max_correction_magnitude=2.0,
        # no odometry in the KITTI benchmark: a constant-velocity prior can
        # be badly off, so keep enough correspondences to recover from it
        trim_ratio_floor=0.50)
    cfg.icp = dataclasses.replace(cfg.icp, trim_normal_space=True)
    return cfg


def run_kitti_sequence(
    scan_dir: str,
    config: Optional[PipelineConfig] = None,
    max_frames: Optional[int] = None,
    remove_ground: bool = False,
    prefetch_threads: int = 4,
    frame_stride: int = 1,
    priors: Optional[np.ndarray] = None,
    device="cuda",
) -> tuple[np.ndarray, list[FrameResult], App]:
    """Returns (trajectory (F, 4, 4) KITTI-convention poses, frame results,
    the App).

    priors: optional (F, 4, 4) prior trajectory (GPS / wheel odometry):
    each frame's prior pose is the corrected chain composed with the prior
    trajectory's relative motion. Without priors a constant-velocity model
    is used (it cannot bootstrap forward motion in a corridor-degenerate
    street from a standstill)."""
    dev = check_device(device, "run_kitti_sequence")
    cfg = config or kitti_config()
    app = App(cfg, device=dev)

    paths = list_velodyne_scans(scan_dir)[::frame_stride]
    if max_frames is not None:
        paths = paths[:max_frames]

    gcfg = None
    if remove_ground:
        from ..ops.ground import GroundFilterConfig
        gcfg = GroundFilterConfig(cell_size=0.5, grid_dim=256)

    trajectory: list[np.ndarray] = []
    results: list[FrameResult] = []
    prior = np.eye(4, dtype=np.float32)
    velocity = np.eye(4, dtype=np.float32)   # constant-velocity motion model

    wire = cfg.quantized_upload or cfg.wire_voxel > 0.0
    with SequencePrefetcher(paths, capacity=cfg.raw_capacity,
                            n_threads=prefetch_threads) as pf:
        for idx, padded, count, _vp in pf:
            if wire:
                from ..pipeline.sequence import wire_cloud

                cloud = wire_cloud(cfg, padded[:count], device=dev)
            else:
                cloud = Cloud.from_numpy_padded(
                    padded, np.arange(cfg.raw_capacity) < count, device=dev)
            if gcfg is not None:
                from ..ops.ground import remove_ground as rg

                non_ground, _ = rg(cloud.points, cloud.mask, gcfg)
                cloud = dataclasses.replace(cloud, mask=non_ground)
            # scans are in the sensor frame; express in the world prior
            cloud = cloud.transform(torch.as_tensor(prior, device=dev))
            res = app.process_cloud(AlignedCloud.create(idx, cloud, prior))
            results.append(res)
            pose = (np.asarray(res.corrected_pose) if res is not None
                    else prior)
            if priors is not None and idx + 1 < len(priors):
                rel = (np.linalg.inv(np.asarray(priors[idx]))
                       @ np.asarray(priors[idx + 1]))
                velocity = rel.astype(np.float32)
            elif trajectory:
                velocity = np.linalg.inv(trajectory[-1]) @ pose
            trajectory.append(pose)
            prior = (pose @ velocity).astype(np.float32)
    return np.stack(trajectory), results, app


def drive_errors(traj: np.ndarray, gt: np.ndarray,
                 priors: np.ndarray) -> dict:
    """The KITTI runner's accuracy on a drive with GPS-grade priors (the
    runner starts at the identity, the drive mid-world, so both are taken
    relative to their first frames): the unaligned ATE of the trajectory
    and of the prior chain (the priors' relative motions integrated, what
    a robot would do without registration), their ratio, and the final
    yaw error in degrees."""
    from .kitti import ate_rmse

    gtp = np.asarray(gt, np.float32)
    rel_gt = np.linalg.inv(gtp[0])[None] @ gtp
    rel_est = np.linalg.inv(traj[0])[None] @ traj
    err = ate_rmse(rel_gt, rel_est, align=False)
    chain = [np.eye(4)]
    for i in range(len(priors) - 1):
        chain.append(chain[-1] @ (np.linalg.inv(priors[i]) @ priors[i + 1]))
    err_prior = ate_rmse(rel_gt, np.stack(chain).astype(np.float32),
                         align=False)
    c = (np.trace(rel_est[-1][:3, :3].T @ rel_gt[-1][:3, :3]) - 1) / 2
    return {"ate_m": err, "prior_chain_ate_m": err_prior,
            "ratio": err / err_prior,
            "final_yaw_deg": float(np.degrees(np.arccos(np.clip(c, -1,
                                                                1))))}
