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
chaining, and the synchronous `process_cloud`. Prior / built maps, go-back,
the risk classifier, pipelined submission and the wire formats raise until
their ROADMAP items land; there is no visualizer.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..cloud import AlignedCloud, AlignedCloudsGraph, Cloud
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
        (cfg.localize_against_prior_map or cfg.load_map_from_file
         or cfg.localize_against_built_map or cfg.merge_aligned_clouds_to_map,
         "prior / loaded / built map localization (ROADMAP Q1 #8, #10)"),
        (cfg.failure_prediction_mode or bool(cfg.classifier_path),
         "failure prediction / risk classifier (ROADMAP Q1 #9)"),
        (cfg.async_finalize, "async finalize (ROADMAP Q1 #8)"),
        (cfg.quantized_upload or cfg.wire_voxel > 0.0,
         "wire formats: quantized_upload / wire_voxel (ROADMAP Q1 #8)"),
        (bool(cfg.debug_dir), "debug_dir PCD dumps (ROADMAP Q1 #14)"),
    )
    return [what for bad, what in checks if bad]


class App:
    def __init__(self, config: PipelineConfig, device="cpu"):
        missing = _unsupported(config)
        if missing:
            raise NotImplementedError("not ported yet: " + "; ".join(missing))
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"App(device={device!r}): CUDA is not "
                               "available")
        self.cfg = config
        self.graph = AlignedCloudsGraph()
        self.total_correction = np.eye(4, dtype=np.float32)
        self.frames: list[FrameResult] = []
        # Current graph reference on the device: (points, mask, normals),
        # its world pose, and clouds added since it was adopted.
        self._ref_device: Optional[tuple] = None
        self._ref_pose: Optional[np.ndarray] = None
        self._since_ref = 0
        self._app_step = make_app_frame_step(config)

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    def set_prior_map(self, cloud: Cloud) -> None:
        raise NotImplementedError("prior-map localization: ROADMAP Q1 #8")

    def go_back_to_map(self) -> None:
        raise NotImplementedError("go-back-to-map: ROADMAP Q1 #8")

    def submit_cloud(self, cloud: AlignedCloud):
        raise NotImplementedError(
            "pipelined submission: ROADMAP Q1 #8; use process_cloud")

    def process_cloud(self, cloud: AlignedCloud) -> FrameResult:
        """One frame: bootstrap on the first cloud, else the frame step and
        its host bookkeeping, with one device-to-host read."""
        cfg = self.cfg
        if (_pre_voxelized(cfg, cloud.cloud.capacity)
                and not cloud.cloud.pre_voxelized):
            raise ValueError(
                "cloud at <= downsample_capacity would skip the device "
                "voxel stage but was not host-voxelized; submit it at raw "
                "capacity")
        points = cloud.cloud.points.to(self.device)
        mask = cloud.cloud.mask.to(self.device)
        if self.graph.is_empty():
            return self._bootstrap(cloud, points, mask)

        odom_pose = np.asarray(cloud.prior_pose, np.float32)
        debug = cfg.working_mode != "robot"
        pose_est = self.total_correction @ odom_pose if debug else odom_pose
        ref_pts, ref_mask, ref_normals = self._ref_device
        # The accept gate exempts only a first registration into an empty
        # graph (prior / loaded maps, not ported); here the bootstrap cloud
        # is always in the graph, so no frame is exempt.
        out = self._app_step(points, mask, self._tensor(odom_pose),
                             self._tensor(self.total_correction), ref_pts,
                             ref_normals, ref_mask,
                             self._tensor(self._ref_pose), -1.0, False)

        # Windowed reference update: adopt this frame's aligned outputs as
        # the next reference (rolled back below if the frame is rejected).
        saved_ref = (self._ref_device, self._ref_pose, self._since_ref)
        self._since_ref += 1
        window = self._since_ref % cfg.reference_update_frequency == 0
        if window:
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
            if window:
                self.graph.update_reference(self.graph.n_clouds - 1)
                self._ref_pose = np.asarray(cloud.corrected_pose)
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
        return self._record(FrameResult(
            utime=cloud.utime, reference_id=ref_id,
            reading_id=self.graph.n_clouds - 1, octree_overlap=overlap,
            fov_overlap=fov, alignability=align, risk=risk,
            correction=correction, accepted=True, registered=risk_ok,
            n_iterations=n_iter, inlier_rms=rms,
            corrected_pose=np.asarray(last.corrected_pose),
            filtered_size=fsize))

    def _bootstrap(self, cloud: AlignedCloud, points, mask) -> FrameResult:
        """First cloud: prefilter it and make it the graph's reference."""
        viewpoint = self._tensor(np.asarray(cloud.prior_pose)[:3, 3])
        fpts, fmask, fnormals = _prefilter(self.cfg, points, mask, viewpoint)
        filtered = Cloud(fpts, fmask)
        cloud.update(filtered, is_reference=True, its_reference_id=0)
        self.graph.initialize(cloud)
        self._ref_device = (fpts, fmask, fnormals)
        self._ref_pose = np.asarray(cloud.corrected_pose)
        self._since_ref = 0
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
