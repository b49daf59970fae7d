"""Frame-to-map localization against a large prior map, PyTorch port of
the single-device path of `aicp_mapping_tpu.parallel.localizer`.

The map is Morton-ordered and padded once on the host, its radius normals
are computed once at load on the device, and every frame registers against
a crop of it around the current pose estimate through the port's App in
prior-map mode — the reference's load-map + localization-only mode.

    loc = ShardedMapLocalizer(map_points_np, icp_config, device="cuda")
    for utime, pts, odom in stream:
        T = loc.localize(pts, odom)        # corrected world pose
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..cloud import AlignedCloud, Cloud
from ..ops.normals import radius_normals
from ..ops.voxel import crop_box
from ..pipeline.app import App, check_device
from ..pipeline.config import PipelineConfig
from ..registration.icp import ICPConfig


def morton_argsort_np(points: np.ndarray, cell: float = 1.0) -> np.ndarray:
    """Host-side Morton (Z-order) argsort, 21 bits per axis (stable)."""
    pts = np.asarray(points, np.float64)
    q = np.floor((pts - pts.min(axis=0)) / cell).astype(np.uint64)
    q = np.minimum(q, (1 << 21) - 1)

    def spread(x):
        x &= (1 << 21) - 1
        x = (x | (x << 32)) & 0x1F00000000FFFF
        x = (x | (x << 16)) & 0x1F0000FF0000FF
        x = (x | (x << 8)) & 0x100F00F00F00F00F
        x = (x | (x << 4)) & 0x10C30C30C30C30C3
        x = (x | (x << 2)) & 0x1249249249249249
        return x

    code = (spread(q[:, 0]) << 2) | (spread(q[:, 1]) << 1) | spread(q[:, 2])
    return np.argsort(code, kind="stable")


def _bitrev(v: torch.Tensor, bits: int) -> torch.Tensor:
    out = torch.zeros_like(v)
    for b in range(bits):
        out = out | (((v >> b) & 1) << (bits - 1 - b))
    return out


class ShardedMapLocalizer:
    """Frame-to-map localization through the App state machine.

    The JAX class shards the map over a device mesh; this one holds it as
    one block on `device`, i.e. the JAX class on a mesh of one device. The
    `mesh` argument and the sharded crop arrive with distribution (ROADMAP
    Q1 #13).

    At load: Morton order (`block_cell`), padding to a multiple of 1,024
    with masked rows, and `radius_normals` of the whole map (viewpoint-free:
    the point-to-plane residual is sign-invariant).
    `convert.localizer_from_state` builds one over another's prepared map
    instead, without the normals pass.

    Per frame, `provide_reference` crops the map around the pose estimate
    (`crop_radius`) and compacts the crop to `out_capacity` points on the
    device; `localize` runs the App's prior-map frame (overlap pinned at 50,
    debug working mode, trim floor and ceiling pinned to `trim_ratio`)."""

    def __init__(self, map_points: np.ndarray,
                 config: Optional[ICPConfig] = None, *, device="cuda",
                 normal_radius: float = 0.4, trim_ratio: float = 0.7,
                 max_correction_magnitude: float = 0.0,
                 block_cell: float = 1.0,
                 pipeline_config: Optional[PipelineConfig] = None,
                 crop_radius: float = 16.0, out_capacity: int = 8192):
        self._setup(config, device, trim_ratio=trim_ratio,
                    max_correction_magnitude=max_correction_magnitude,
                    pipeline_config=pipeline_config, crop_radius=crop_radius,
                    out_capacity=out_capacity)
        pts = np.asarray(map_points, np.float32).reshape(-1, 3)
        pts = pts[morton_argsort_np(pts, cell=block_cell)]
        cap = -(-max(len(pts), 1024) // 1024) * 1024
        padded = np.zeros((cap, 3), np.float32)
        padded[:len(pts)] = pts
        points = torch.as_tensor(padded, device=self.device)
        mask = torch.as_tensor(np.arange(cap) < len(pts), device=self.device)
        normals, _, _ = radius_normals(points, mask, normal_radius)
        self._set_map(points, mask, normals)

    def _setup(self, config: Optional[ICPConfig] = None, device="cuda", *,
               trim_ratio: float = 0.7, max_correction_magnitude: float = 0.0,
               pipeline_config: Optional[PipelineConfig] = None,
               crop_radius: float = 16.0, out_capacity: int = 8192) -> None:
        """Everything but the map: the App in prior-map mode and the crop."""
        self.device = check_device(device, "ShardedMapLocalizer")
        self.cfg = config or ICPConfig()
        self.out_capacity = int(out_capacity)
        self.crop_radius = float(crop_radius)
        self._frame_idx = 0
        pcfg = pipeline_config or PipelineConfig(
            raw_capacity=16384, downsample_capacity=8192,
            filtered_capacity=4096)
        # debug working mode: the localizer consumes raw odometry and the
        # App applies the accumulated correction itself
        pcfg = dataclasses.replace(pcfg, localize_against_prior_map=True,
                                   working_mode="debug")
        pcfg.icp = self.cfg
        if max_correction_magnitude > 0.0:
            pcfg.max_correction_magnitude = float(max_correction_magnitude)
        if trim_ratio:
            # prior-map mode pins the overlap at 50 (trim 0.5); honour an
            # explicit trim by narrowing the clamp window
            pcfg.trim_ratio_floor = float(trim_ratio)
            pcfg.trim_ratio_ceil = float(trim_ratio)
        self.app = App(pcfg, device=self.device, reference_provider=self)
        self.last_result = None

    def _set_map(self, points: torch.Tensor, mask: torch.Tensor,
                 normals: torch.Tensor) -> None:
        """Hold a prepared (Morton-ordered, padded) map and its normals."""
        cap = points.shape[0]
        self.map_points, self.map_mask, self.map_normals = (
            points, mask, normals)
        # bit-reversal width sized to the map capacity, so that a crop of
        # more than out_capacity points keeps a uniform sample of it
        self._rev_bits = max(17, int(np.ceil(np.log2(max(cap, 2)))))
        self._spread = _bitrev(torch.arange(cap, device=self.device),
                               self._rev_bits)

    def provide_reference(self, pose_est: np.ndarray):
        """App.reference_provider hook: the map's points in the box of
        half-width `crop_radius` around the pose, with their normals,
        compacted to `out_capacity` by one sort on (outside the box,
        bit-reversed row index). The crop stays on the device."""
        pose = torch.as_tensor(np.asarray(pose_est, np.float32),
                               device=self.device)
        r = self.crop_radius
        inbox = crop_box(self.map_points, self.map_mask, pose, -r, r)
        key = ((~inbox).to(torch.int64) << self._rev_bits) | self._spread
        perm = torch.sort(key).indices[:self.out_capacity]
        return self.map_points[perm], inbox[perm], self.map_normals[perm]

    @property
    def total_correction(self) -> np.ndarray:
        return self.app.total_correction

    def set_initial_guess(self, pose_in_map: np.ndarray,
                          world_to_body: np.ndarray) -> None:
        """Seed the correction chain with a pose in the map."""
        self.app.set_initial_guess(pose_in_map, world_to_body)

    def localize(self, points: np.ndarray, odom_pose: np.ndarray,
                 capacity: Optional[int] = None) -> np.ndarray:
        """Register one sensor-frame cloud (odometry pose `odom_pose`)
        against the map through the App; returns the corrected world pose.
        The first registration is exempt from the correction-magnitude
        gate. `last_result` holds the frame's FrameResult."""
        odom = np.asarray(odom_pose, np.float32)
        # sensor frame -> odom frame
        pts_odom = (np.asarray(points, np.float32) @ odom[:3, :3].T
                    + odom[:3, 3]).astype(np.float32)
        cap = capacity or -(-len(points) // 512) * 512
        cloud = Cloud.from_numpy(pts_odom, capacity=cap)
        res = self.app.process_cloud(
            AlignedCloud.create(self._frame_idx, cloud, odom))
        self._frame_idx += 1
        self.last_result = res
        return np.asarray(res.corrected_pose)
