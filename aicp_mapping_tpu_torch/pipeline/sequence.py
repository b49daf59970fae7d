"""Offline sequence runner + recorder, the wire preparation and the
synthetic sequence, PyTorch port of `aicp_mapping_tpu.pipeline.sequence`.

`SequenceRunner` feeds clouds through `App.process_cloud` or, with
`pipelined=True`, `App.submit_cloud`: from memory (`run_clouds`, with the
wire preparation on worker threads, in order) or from a recorded directory
(`run_directory`: `aicp_input_poses.csv` + `cloud_<i>_<sec>_<nsec>.pcd`,
read ahead by `native.SequencePrefetcher`). `wire_cloud` and `wire_batch`
prepare clouds per the config's wire format (host voxel grid, int16
upload; spans "aicp.wire.voxel" around the host grid and quantization and
"aicp.wire.upload" around the copy to the device and the dequantize, on
the thread that prepares the cloud); `SequenceRecorder` writes the
directory layout.
`synthetic_sequence` is a copy of the JAX function whose SO(3) exponential
runs in numpy float32 instead of jax.numpy.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, Optional

import numpy as np
import torch

from .. import native
from ..cloud import AlignedCloud, Cloud, _dequantize
from ..io.pcd import write_pcd
from ..io.poses import PoseWithTime, read_pose_csv, write_pose_csv
from ..tools.synthetic import room_cloud
from ..utils.timing import span
from .app import FrameResult, check_device
from .config import PipelineConfig


def wire_cloud(cfg: PipelineConfig, pts: np.ndarray,
               capacity: Optional[int] = None, device="cuda") -> Cloud:
    """One cloud prepared per the config's wire format and put on
    `device` (the card unless the caller asks for the CPU; without a card
    it raises): with `wire_voxel` the host voxel grid first (the cloud is
    then marked `pre_voxelized`, at `downsample_capacity`), with
    `quantized_upload` the int16 upload; else the raw f32 cloud at
    `capacity` (default `raw_capacity`)."""
    device = check_device(device, "wire_cloud")
    pts = np.asarray(pts, np.float32)
    if cfg.wire_voxel > 0.0:
        if cfg.quantized_upload:
            with span("aicp.wire.voxel"):
                q, scale, center, n = native.voxel_downsample_q16(
                    pts, cfg.wire_voxel, cfg.downsample_capacity)
            with span("aicp.wire.upload"):
                cloud = Cloud.from_wire_q16(q, scale, center, n,
                                            device=device)
        else:
            with span("aicp.wire.voxel"):
                pts = native.voxel_downsample(
                    pts, cfg.wire_voxel, capacity=cfg.downsample_capacity)
            with span("aicp.wire.upload"):
                cloud = Cloud.from_numpy(pts,
                                         capacity=cfg.downsample_capacity,
                                         device=device)
        return dataclasses.replace(cloud, pre_voxelized=True)
    cap = capacity if capacity is not None else cfg.raw_capacity
    with span("aicp.wire.upload"):
        return Cloud.from_numpy(pts, capacity=cap, device=device,
                                quantize=cfg.quantized_upload)


def wire_batch(cfg: PipelineConfig, pts_list: list,
               device="cuda") -> list[Cloud]:
    """The quantized wire format (`wire_voxel` > 0 and `quantized_upload`)
    for a batch of clouds: host voxel grid and int16 quantization per
    cloud into one (B, downsample_capacity, 3) buffer, pinned on a card,
    shipped by one host-to-device copy; each cloud is dequantized on the
    device from its view of the batch. On the card unless the caller asks
    for the CPU; without a card it raises."""
    if not (cfg.wire_voxel > 0.0 and cfg.quantized_upload):
        raise ValueError("wire_batch needs the quantized wire format "
                         "(wire_voxel > 0 and quantized_upload)")
    dev = check_device(device, "wire_batch")
    pin = dev.type == "cuda"
    B, cap = len(pts_list), cfg.downsample_capacity
    qs = torch.empty((B, cap, 3), dtype=torch.int16, pin_memory=pin)
    sc = torch.empty((2, B, 3), dtype=torch.float32, pin_memory=pin)
    counts = []
    for i, pts in enumerate(pts_list):
        with span("aicp.wire.voxel"):
            q, scale, center, n = native.voxel_downsample_q16(
                np.asarray(pts, np.float32), cfg.wire_voxel, cap)
        qs[i] = torch.from_numpy(q)
        sc[0, i] = torch.from_numpy(scale)
        sc[1, i] = torch.from_numpy(center)
        counts.append(n)
    # Non-blocking from pinned memory: the caching host allocator keeps
    # these buffers until the copies on the current stream have run.
    with span("aicp.wire.upload"):
        qd = qs.to(dev, non_blocking=pin)
        scd = sc.to(dev, non_blocking=pin)
        return [dataclasses.replace(
            _dequantize(qd[i], scd[0, i], scd[1, i], n), pre_voxelized=True)
            for i, n in enumerate(counts)]


def _on_stream(device: torch.device):
    """A context that makes a worker thread enqueue on the caller's current
    CUDA stream (each thread has its own), so the uploads it prepares are
    ordered before the frames that read them."""
    if device.type != "cuda":
        return contextlib.nullcontext
    stream = torch.cuda.current_stream(device)
    return lambda: torch.cuda.stream(stream)


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
    """Drives `App.process_cloud`, or with `pipelined=True`
    `App.submit_cloud` (frames in flight up to the config's
    `pipeline_depth`); results come out in order either way."""

    def __init__(self, app, raw_capacity: Optional[int] = None,
                 pipelined: bool = False):
        self.app = app
        self.raw_capacity = raw_capacity or app.cfg.raw_capacity
        self.pipelined = pipelined

    def _drive(self, ac: AlignedCloud) -> list[FrameResult]:
        if not self.pipelined:
            return [self.app.process_cloud(ac)]
        return self.app.submit_cloud(ac)

    def run_directory(self, directory: str,
                      prefetch_threads: int = 4) -> list[FrameResult]:
        """Replay a recorded sequence, the files read ahead in order by
        `native.SequencePrefetcher` (a cloud over the raw capacity cut by an
        even stride; unreadable files skipped) and prepared per the
        config's wire format."""
        poses = read_pose_csv(os.path.join(directory,
                                           "aicp_input_poses.csv"))
        paths = [os.path.join(directory,
                              f"cloud_{p.counter}_{p.sec}_{p.nsec}.pcd")
                 for p in poses]
        cfg, dev = self.app.cfg, self.app.device
        wire = cfg.quantized_upload or cfg.wire_voxel > 0.0
        results = []
        with native.SequencePrefetcher(paths, capacity=self.raw_capacity,
                                       n_threads=prefetch_threads) as pf:
            for idx, padded, count, _vp in pf:
                p = poses[idx]
                if wire:
                    cloud = wire_cloud(cfg, padded[:count],
                                       capacity=self.raw_capacity,
                                       device=dev)
                else:
                    cloud = Cloud.from_numpy_padded(
                        padded, np.arange(self.raw_capacity) < count,
                        device=dev)
                results.extend(self._drive(
                    AlignedCloud.create(p.utime, cloud, p.pose)))
        results.extend(self.app.flush())
        return results

    def run_clouds(self, items: Iterable[tuple[int, np.ndarray, np.ndarray]],
                   prep_workers: int = 1, prep_window: int = 2,
                   batch_h2d: int = 0, flush: bool = True
                   ) -> list[FrameResult]:
        """items: (utime, points (N, 3), prior_pose (4, 4)).

        The wire preparation (host voxel grid, quantization, upload) of up
        to `prep_window` frames ahead runs on `prep_workers` threads (named
        "aicp-wire_<k>") and is delivered in order; each wait on one is a
        span "aicp.runner.prep_wait". `batch_h2d` > 1 with the quantized
        wire format prepares that many frames per task and uploads them in
        one copy (`wire_batch`). `flush=False` leaves the submission
        pipeline full: its frames' results come with the next call or
        `App.flush`. A failed preparation raises here; nothing falls
        back."""
        items = list(items)
        cfg, dev = self.app.cfg, self.app.device
        stream = _on_stream(dev)
        results = []
        if batch_h2d > 1 and cfg.wire_voxel > 0.0 and cfg.quantized_upload:
            def prep(batch):
                with stream():
                    return wire_batch(cfg, [it[1] for it in batch], dev)

            batches = [items[i:i + batch_h2d]
                       for i in range(0, len(items), batch_h2d)]
            with ThreadPoolExecutor(max_workers=1,
                                    thread_name_prefix="aicp-wire") as ex:
                fut = ex.submit(prep, batches[0]) if batches else None
                for bi, batch in enumerate(batches):
                    with span("aicp.runner.prep_wait"):
                        clouds = fut.result()
                    if bi + 1 < len(batches):
                        fut = ex.submit(prep, batches[bi + 1])
                    for (utime, _pts, pose), cloud in zip(batch, clouds):
                        results.extend(self._drive(AlignedCloud.create(
                            utime, cloud, np.asarray(pose, np.float32))))
        else:
            def prep(pts):
                with stream():
                    return wire_cloud(cfg, pts, self.raw_capacity, dev)

            with ThreadPoolExecutor(max_workers=prep_workers,
                                    thread_name_prefix="aicp-wire") as ex:
                futs = {i: ex.submit(prep, items[i][1])
                        for i in range(min(prep_window, len(items)))}
                for i, (utime, _pts, pose) in enumerate(items):
                    with span("aicp.runner.prep_wait"):
                        cloud = futs.pop(i).result()
                    nxt = i + len(futs) + 1
                    if nxt < len(items):
                        futs[nxt] = ex.submit(prep, items[nxt][1])
                    results.extend(self._drive(AlignedCloud.create(
                        utime, cloud, np.asarray(pose, np.float32))))
        if flush:
            results.extend(self.app.flush())
        return results


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
