"""Frame-to-map localization against a large prior map, PyTorch port of
`aicp_mapping_tpu.parallel.localizer`.

The map is Morton-ordered and padded once on the host and split into one
spatially coherent block per rank of a mesh axis (one block without a
mesh); each block's radius normals are computed once at load on its rank's
device, and every frame registers against a crop of the map around the
current pose estimate through the port's App in prior-map mode — the
reference's load-map + localization-only mode.

    loc = ShardedMapLocalizer(map_points_np, icp_config, device="cuda")
    for utime, pts, odom in stream:
        T = loc.localize(pts, odom)        # corrected world pose

Over a mesh (SPMD construction, single-controller frames):

    loc = ShardedMapLocalizer(map_points_np, icp_config, mesh=mesh)
    if mesh.rank == 0:
        poses = [loc.localize(pts, odom) for _, pts, odom in stream]
        loc.stop_serving()
    else:
        loc.serve()                        # crops until rank 0 stops
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

    At load: Morton order (`block_cell`); blocks of max(1024, ceil(N / D))
    rows rounded up to 1,024, one per rank of `mesh`'s `axis` (D ranks;
    one block on `device` without a mesh), padded with masked rows; and
    `radius_normals` of each block on its own rank (viewpoint-free: the
    point-to-plane residual is sign-invariant; the Z-order seams between
    blocks see only their own block's neighbours, as in JAX).
    `convert.localizer_from_state` builds one over another's prepared
    blocks instead, without the normals pass.

    Per frame, `provide_reference` crops the map around the pose estimate
    (`crop_radius`) and compacts the crop to `out_capacity` points on the
    device, keyed by (outside the box, bit-reversed global row); over a
    mesh each rank keys and cuts its own block and rank 0 merges the
    candidates by the same keys, which gives the rows of one global sort.
    `localize` runs the App's prior-map frame (overlap pinned at 50, debug
    working mode, trim floor and ceiling pinned to `trim_ratio`). Over a
    mesh the construction is SPMD, and rank 0 alone holds the App and
    localizes while the other ranks `serve` its crops."""

    def __init__(self, map_points: np.ndarray,
                 config: Optional[ICPConfig] = None, *, mesh=None,
                 axis: str = "points", device="cuda",
                 normal_radius: float = 0.4, trim_ratio: float = 0.7,
                 max_correction_magnitude: float = 0.0,
                 block_cell: float = 1.0,
                 pipeline_config: Optional[PipelineConfig] = None,
                 crop_radius: float = 16.0, out_capacity: int = 8192):
        self._setup(config, device, mesh=mesh, axis=axis,
                    trim_ratio=trim_ratio,
                    max_correction_magnitude=max_correction_magnitude,
                    pipeline_config=pipeline_config, crop_radius=crop_radius,
                    out_capacity=out_capacity)
        pts = np.asarray(map_points, np.float32).reshape(-1, 3)
        pts = pts[morton_argsort_np(pts, cell=block_cell)]
        n_blocks = 1 if mesh is None else mesh.shape[axis]
        block = max(1024, -(-len(pts) // n_blocks))
        block = -(-block // 1024) * 1024
        padded = np.zeros((block * n_blocks, 3), np.float32)
        padded[:len(pts)] = pts
        i = 0 if mesh is None else mesh.index(axis)
        rows = slice(i * block, (i + 1) * block)
        points = torch.as_tensor(padded[rows], device=self.device)
        mask = torch.as_tensor(np.arange(block * n_blocks)[rows] < len(pts),
                               device=self.device)
        normals, _, _ = radius_normals(points, mask, normal_radius)
        self._set_map(points, mask, normals, n_blocks)

    def _setup(self, config: Optional[ICPConfig] = None, device="cuda", *,
               mesh=None, axis: str = "points",
               trim_ratio: float = 0.7, max_correction_magnitude: float = 0.0,
               pipeline_config: Optional[PipelineConfig] = None,
               crop_radius: float = 16.0, out_capacity: int = 8192) -> None:
        """Everything but the map: the App in prior-map mode (on rank 0 of
        a mesh) and the crop."""
        self.mesh, self.axis = mesh, axis
        self.device = check_device(device if mesh is None else mesh.device,
                                   "ShardedMapLocalizer")
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
        self.app = (App(pcfg, device=self.device, reference_provider=self)
                    if mesh is None or mesh.rank == 0 else None)
        self.last_result = None

    def _set_map(self, points: torch.Tensor, mask: torch.Tensor,
                 normals: torch.Tensor, n_blocks: int = 1) -> None:
        """Hold this rank's block of a prepared (Morton-ordered, padded)
        map of `n_blocks` equal blocks, and its normals."""
        block = points.shape[0]
        self.map_points, self.map_mask, self.map_normals = (
            points, mask, normals)
        self.block_size, self.n_blocks = block, n_blocks
        # bit-reversal width sized to the whole map's capacity, so that a
        # crop of more than out_capacity points keeps a uniform sample of
        # it; keyed by the global row
        self._rev_bits = max(17, int(np.ceil(np.log2(max(block * n_blocks,
                                                         2)))))
        first = 0 if self.mesh is None else self.mesh.index(self.axis) * block
        self._spread = _bitrev(torch.arange(first, first + block,
                                            device=self.device),
                               self._rev_bits)

    def provide_reference(self, pose_est: np.ndarray):
        """App.reference_provider hook: the map's points in the box of
        half-width `crop_radius` around the pose, with their normals,
        compacted to `out_capacity` by one sort on (outside the box,
        bit-reversed global row index). The crop stays on the device; over
        a mesh every rank crops its block (`send` from rank 0)."""
        pose = torch.as_tensor(np.asarray(pose_est, np.float32),
                               device=self.device)
        if self.mesh is not None:
            self.mesh.send("crop", [pose])
        return self._crop(pose)

    def _crop(self, pose: torch.Tensor):
        r = self.crop_radius
        inbox = crop_box(self.map_points, self.map_mask, pose, -r, r)
        key = ((~inbox).to(torch.int64) << self._rev_bits) | self._spread
        perm = torch.sort(key).indices[:self.out_capacity]
        if self.mesh is None:
            return self.map_points[perm], inbox[perm], self.map_normals[perm]
        # each block's first out_capacity rows hold the global sort's first
        # out_capacity rows among its own; the keys are unique
        cand = torch.cat([self.map_points[perm], self.map_normals[perm],
                          inbox[perm][:, None].to(torch.float32)], 1)
        keys = self.mesh.all_gather(key[perm], self.axis).reshape(-1)
        cand = self.mesh.all_gather(cand, self.axis).reshape(-1, 7)
        rows = cand[torch.sort(keys).indices[:self.out_capacity]]
        return (rows[:, :3].contiguous(), rows[:, 6] > 0.5,
                rows[:, 3:6].contiguous())

    def map_blocks(self):
        """Every block's (points (D, B, 3), mask (D, B), normals (D, B, 3));
        over a mesh, gathered from the ranks (rank 0 `send`s)."""
        if self.mesh is None:
            return (self.map_points[None], self.map_mask[None],
                    self.map_normals[None])
        if self.mesh.rank == 0:
            self.mesh.send("blocks")
        return tuple(self.mesh.all_gather(t, self.axis) for t in (
            self.map_points, self.map_mask, self.map_normals))

    def serve(self) -> None:
        """Ranks >= 1 of a mesh: crop (or gather the blocks) for rank 0's
        frames until it calls `stop_serving`."""
        self.mesh.serve({"crop": lambda t, o: self._crop(t[0]),
                         "blocks": lambda t, o: self.map_blocks()})

    def stop_serving(self) -> None:
        """Rank 0 of a mesh: release the serving ranks."""
        if self.mesh is not None:
            self.mesh.stop_serving()

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
