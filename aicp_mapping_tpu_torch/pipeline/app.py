"""The AICP pipeline state machine, PyTorch port of
`aicp_mapping_tpu.pipeline.app`.

Host Python makes the per-frame decisions (bootstrap, reference policy,
gates' bookkeeping); the frame step (`pipeline.fused.make_app_frame_step`)
runs on `App(config, device=...)`'s device, and each frame reads its
scalars back to the host once.

Ported: bootstrap on the first cloud, the graph-reference policy (windowed
update every `reference_update_frequency` clouds), the `min_overlap_percent`
gate with its forced reference update, the accept gate with the
first-registration exemption, robot and debug working modes, total-correction
chaining, the synchronous `process_cloud`, and the map modes: a prior map
(`set_prior_map`, or an external `reference_provider` such as
`parallel.ShardedMapLocalizer`) with the overlap pinned at 50, the built map
and `go_back_to_map`, `load_map_from_file`'s first-frame reference, and
`merge_aligned_clouds_to_map`. The risk classifier, pipelined submission,
the wire formats and `debug_dir` dumps raise until their ROADMAP items land;
there is no visualizer.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..cloud import AlignedCloud, AlignedCloudsGraph, Cloud
from ..ops.normals import radius_normals
from ..ops.voxel import crop_box
from .config import PipelineConfig
from .fused import _pre_voxelized, _prefilter, make_app_frame_step


@dataclasses.dataclass
class FrameResult:
    """Per-frame diagnostics (the JAX `FrameResult` fields)."""

    utime: int
    reference_id: int
    reading_id: int
    octree_overlap: float
    fov_overlap: float
    alignability: float
    risk: float
    correction: np.ndarray      # (4, 4)
    accepted: bool
    registered: bool            # False when gated or first cloud
    n_iterations: int
    inlier_rms: float
    corrected_pose: np.ndarray  # (4, 4)
    filtered_size: int


def _unsupported(cfg: PipelineConfig) -> list:
    checks = (
        (cfg.failure_prediction_mode or bool(cfg.classifier_path),
         "failure prediction / risk classifier (ROADMAP Q1 #9)"),
        (cfg.async_finalize, "async finalize (ROADMAP Q1 #8)"),
        (cfg.quantized_upload or cfg.wire_voxel > 0.0,
         "wire formats: quantized_upload / wire_voxel (ROADMAP Q1 #8)"),
        (bool(cfg.debug_dir), "debug_dir PCD dumps (ROADMAP Q1 #14)"),
    )
    return [what for bad, what in checks if bad]


class App:
    def __init__(self, config: PipelineConfig, device="cpu",
                 reference_provider=None):
        missing = _unsupported(config)
        if missing:
            raise NotImplementedError("not ported yet: " + "; ".join(missing))
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"App(device={device!r}): CUDA is not "
                               "available")
        self.cfg = config
        # Optional external reference for prior-map localization: any
        # object with provide_reference(pose_est) -> (points, mask, normals)
        # tensors on this App's device (parallel.ShardedMapLocalizer).
        self.reference_provider = reference_provider
        self.graph = AlignedCloudsGraph()
        self.total_correction = np.eye(4, dtype=np.float32)
        self.frames: list[FrameResult] = []
        # Current graph reference on the device: (points, mask, normals),
        # its world pose, and clouds added since it was adopted.
        self._ref_device: Optional[tuple] = None
        self._ref_pose: Optional[np.ndarray] = None
        self._since_ref = 0
        # True once a registration frame has run: only the first
        # registration into an empty graph is exempt from the accept gate.
        self._registered_any = False
        # Prior map (a Cloud at map capacity) and the built map: reference
        # clouds appended as device clouds, materialized to numpy lazily.
        self.prior_map: Optional[Cloud] = None
        self._map_parts: list[np.ndarray] = []
        self._map_pending: list[Cloud] = []
        self._map_np: Optional[np.ndarray] = None
        self._app_step = make_app_frame_step(config)

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    # ------------------------------------------------------------------
    # maps
    # ------------------------------------------------------------------
    @property
    def aligned_map_np(self) -> np.ndarray:
        """The accumulated aligned map (the reference clouds), as numpy."""
        if self._map_pending:
            self._map_parts.extend(c.to_numpy() for c in self._map_pending)
            self._map_pending.clear()
            self._map_np = None
        if self._map_np is None:
            self._map_np = (np.concatenate(self._map_parts)
                            if self._map_parts
                            else np.zeros((0, 3), np.float32))
        return self._map_np

    @aligned_map_np.setter
    def aligned_map_np(self, value) -> None:
        value = np.asarray(value, np.float32).reshape(-1, 3)
        self._map_parts = [value] if len(value) else []
        self._map_pending = []
        self._map_np = None

    def _map_cloud(self, points: np.ndarray) -> Cloud:
        return Cloud.from_numpy(points, capacity=self.cfg.map_capacity,
                                device=self.device)

    def filter_cloud(self, cloud: Cloud, viewpoint) -> Cloud:
        """The frame path's voxel + planes-only prefilter of one cloud."""
        pts, mask, _ = _prefilter(self.cfg, cloud.points.to(self.device),
                                  cloud.mask.to(self.device),
                                  self._tensor(viewpoint))
        return Cloud(pts, mask)

    def set_prior_map(self, cloud: Cloud) -> None:
        """Load-map service: prefilter at the zero viewpoint and store at
        map capacity."""
        filtered = self.filter_cloud(cloud, np.zeros(3, np.float32))
        self.prior_map = self._map_cloud(filtered.to_numpy())

    def set_initial_guess(self, pose_in_map: np.ndarray,
                          world_to_body: np.ndarray) -> None:
        """Seed the total correction with pose_in_map @ odometry^-1, so
        corrected poses start in the map frame."""
        self.total_correction = (
            np.asarray(pose_in_map, np.float32)
            @ np.linalg.inv(np.asarray(world_to_body, np.float32))
        ).astype(np.float32)

    def go_back_to_map(self) -> None:
        """Go-back service: the built map becomes the prior map and the App
        turns to localization only."""
        self.prior_map = self._map_cloud(self.aligned_map_np)
        self.cfg.localize_against_prior_map = True

    def _crop_map(self, map_pts, map_mask, pose):
        """The map points in the box around `pose`, compacted to the front
        (stable, by index) and cut to `filtered_capacity`."""
        c = self.cfg.crop_map_around_base
        inside = crop_box(map_pts, map_mask, pose, -c, c)
        perm = torch.sort((~inside).to(torch.int8), stable=True).indices
        perm = perm[:self.cfg.filtered_capacity]
        return map_pts[perm], inside[perm]

    def _set_reference(self, pose_est: np.ndarray):
        """(points, mask, normals, pose, ref_id, fixed_overlap) of this
        frame's reference. In prior-map localization every frame registers
        against the cropped prior map with the overlap pinned at 50; with
        load_map_from_file only the first frame does; built-map mode crops
        the accumulated aligned map; otherwise the current graph reference
        (ref_id None: resolved after the frame)."""
        cfg = self.cfg
        use_map = (cfg.localize_against_prior_map
                   or (cfg.load_map_from_file and self.graph.is_empty()))
        fixed = 50.0 if cfg.localize_against_prior_map else -1.0
        pose = np.asarray(pose_est, np.float32)
        if use_map and self.reference_provider is not None:
            pts, mask, normals = self.reference_provider.provide_reference(
                pose)
            return pts, mask, normals, pose, -1, fixed
        if use_map or cfg.localize_against_built_map:
            if use_map:
                assert self.prior_map is not None, "prior map not loaded"
                src = self.prior_map
            else:
                src = self._map_cloud(self.aligned_map_np)
            pts, mask = self._crop_map(src.points, src.mask,
                                       self._tensor(pose))
            normals, _, _ = radius_normals(pts, mask, 0.4,
                                           self._tensor(pose[:3, 3]))
            return pts, mask, normals, pose, -1, fixed
        pts, mask, normals = self._ref_device
        return pts, mask, normals, self._ref_pose, None, -1.0

    # ------------------------------------------------------------------
    # frames
    # ------------------------------------------------------------------
    def submit_cloud(self, cloud: AlignedCloud):
        raise NotImplementedError(
            "pipelined submission: ROADMAP Q1 #8; use process_cloud")

    def process_cloud(self, cloud: AlignedCloud) -> FrameResult:
        """One frame: bootstrap on the first cloud (unless a map is the
        reference), else the frame step and its host bookkeeping, with one
        device-to-host read."""
        cfg = self.cfg
        if (_pre_voxelized(cfg, cloud.cloud.capacity)
                and not cloud.cloud.pre_voxelized):
            raise ValueError(
                "cloud at <= downsample_capacity would skip the device "
                "voxel stage but was not host-voxelized; submit it at raw "
                "capacity")
        points = cloud.cloud.points.to(self.device)
        mask = cloud.cloud.mask.to(self.device)
        if (not cfg.localize_against_prior_map and not cfg.load_map_from_file
                and self.graph.is_empty()):
            return self._bootstrap(cloud, points, mask)

        odom_pose = np.asarray(cloud.prior_pose, np.float32)
        debug = cfg.working_mode != "robot"
        pose_est = self.total_correction @ odom_pose if debug else odom_pose
        (ref_pts, ref_mask, ref_normals, ref_pose, ref_id,
         fixed_overlap) = self._set_reference(pose_est)
        # First-registration exemption from the accept gate: a
        # relocalization against a prior / loaded map legitimately starts
        # with a correction over max_correction_magnitude.
        allow_large = self.graph.is_empty() and not self._registered_any
        self._registered_any = True
        out = self._app_step(points, mask, self._tensor(odom_pose),
                             self._tensor(self.total_correction), ref_pts,
                             ref_normals, ref_mask, self._tensor(ref_pose),
                             fixed_overlap, allow_large)

        # Reference update in graph mode: adopt this frame's aligned outputs
        # (rolled back below if the frame is rejected) — the loaded map's
        # first frame, or the windowed update.
        saved_ref = (self._ref_device, self._ref_pose, self._since_ref)
        update = None
        if (not cfg.localize_against_prior_map
                and not cfg.localize_against_built_map):
            self._since_ref += 1
            if cfg.load_map_from_file and self._ref_device is None:
                update = "loadmap"
            elif self._since_ref % cfg.reference_update_frequency == 0:
                update = "window"
            if update:
                self._ref_device = (out.aligned_points, out.filtered_mask,
                                    out.aligned_normals)
                self._ref_pose = pose_est
                self._since_ref = 0

        # the frame's one device-to-host read
        host = torch.cat([
            out.correction.reshape(-1), out.correction_raw.reshape(-1),
            out.new_total.reshape(-1),
            torch.stack([out.risk_ok.float(), out.accepted.float(),
                         out.overlap_percent, out.fov_overlap,
                         out.alignability, out.risk, out.inlier_rms,
                         out.filtered_count.float()])]).cpu().numpy()
        correction = host[0:16].reshape(4, 4)
        correction_raw = host[16:32].reshape(4, 4)
        new_total = host[32:48].reshape(4, 4)
        (risk_ok, accepted, overlap, fov, align, risk, rms,
         fsize) = host[48:56].tolist()
        risk_ok, accepted = bool(risk_ok), bool(accepted)
        n_iter = out.n_iterations if risk_ok else 0
        rms = rms if risk_ok else 0.0
        fsize = int(fsize)
        if ref_id is None:
            ref_id = self.graph.current_reference_id

        if debug:
            # host mirror of the device-side pre-transform
            cloud.prior_pose = self.total_correction @ odom_pose
            cloud.corrected_pose = cloud.prior_pose

        if not accepted:
            # wrong alignment: frame dropped, speculative reference undone
            self._ref_device, self._ref_pose, self._since_ref = saved_ref
            return self._record(FrameResult(
                utime=cloud.utime, reference_id=ref_id,
                reading_id=self.graph.n_clouds, octree_overlap=overlap,
                fov_overlap=fov, alignability=align, risk=risk,
                correction=correction_raw, accepted=False,
                registered=risk_ok, n_iterations=n_iter, inlier_rms=rms,
                corrected_pose=np.asarray(cloud.corrected_pose),
                filtered_size=fsize))

        if risk_ok:
            cloud.update(Cloud(out.aligned_points, out.filtered_mask),
                         correction, is_reference=False,
                         its_reference_id=self.graph.current_reference_id)
            self.graph.add(cloud)
            if update:
                self.graph.update_reference(self.graph.n_clouds - 1)
                self._ref_pose = np.asarray(cloud.corrected_pose)
            elif (cfg.localize_against_built_map
                  and not cfg.localize_against_prior_map):
                # built-map mode registers against the cropped map; the
                # windowed graph bookkeeping still runs for reference ids
                since = (self.graph.n_clouds
                         - (self.graph.current_reference_id + 1))
                if since % cfg.reference_update_frequency == 0:
                    self.graph.update_reference(self.graph.n_clouds - 1)
        else:
            # gated: trust the prior for one step, force a reference update
            cloud.update(Cloud(out.filtered_points, out.filtered_mask),
                         is_reference=True,
                         its_reference_id=self.graph.current_reference_id)
            self.graph.add(cloud)
            self.graph.update_reference(self.graph.n_clouds - 1)
            self._ref_device = (out.filtered_points, out.filtered_mask,
                                out.filtered_normals)
            self._ref_pose = np.asarray(cloud.corrected_pose)
            self._since_ref = 0

        self.total_correction = new_total
        last = self.graph.last()
        if last.is_reference:
            self._map_pending.append(last.cloud)
            self._map_np = None
        elif (cfg.localize_against_prior_map and cfg.merge_aligned_clouds_to_map
              and self.prior_map is not None
              and (self.graph.n_clouds - 1)
              % cfg.reference_update_frequency == 0):
            self.prior_map = self._map_cloud(np.concatenate(
                [self.prior_map.to_numpy(), last.cloud.to_numpy()]))
        if (cfg.localize_against_prior_map and cfg.merge_aligned_clouds_to_map
                and self.prior_map is not None
                and (self.graph.n_clouds - 1) % 30 == 0):
            # amortized prior-map re-filter every 30 clouds
            self.prior_map = self._map_cloud(self.filter_cloud(
                self.prior_map, np.zeros(3, np.float32)).to_numpy())
        return self._record(FrameResult(
            utime=cloud.utime, reference_id=ref_id,
            reading_id=self.graph.n_clouds - 1, octree_overlap=overlap,
            fov_overlap=fov, alignability=align, risk=risk,
            correction=correction, accepted=True, registered=risk_ok,
            n_iterations=n_iter, inlier_rms=rms,
            corrected_pose=np.asarray(last.corrected_pose),
            filtered_size=fsize))

    def _bootstrap(self, cloud: AlignedCloud, points, mask) -> FrameResult:
        """First cloud: prefilter it and make it the graph's reference and
        the built map's first cloud."""
        viewpoint = self._tensor(np.asarray(cloud.prior_pose)[:3, 3])
        fpts, fmask, fnormals = _prefilter(self.cfg, points, mask, viewpoint)
        filtered = Cloud(fpts, fmask)
        cloud.update(filtered, is_reference=True, its_reference_id=0)
        self.graph.initialize(cloud)
        self._ref_device = (fpts, fmask, fnormals)
        self._ref_pose = np.asarray(cloud.corrected_pose)
        self._since_ref = 0
        self.aligned_map_np = filtered.to_numpy()
        return self._record(FrameResult(
            utime=cloud.utime, reference_id=0, reading_id=0,
            octree_overlap=-1.0, fov_overlap=-1.0, alignability=-1.0,
            risk=-1.0, correction=np.eye(4, dtype=np.float32),
            accepted=True, registered=False, n_iterations=0, inlier_rms=0.0,
            corrected_pose=np.asarray(cloud.corrected_pose),
            filtered_size=int(filtered.count())))

    def _record(self, res: FrameResult) -> FrameResult:
        self.frames.append(res)
        return res
