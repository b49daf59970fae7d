"""The AICP frame step, PyTorch port of `aicp_mapping_tpu.pipeline.fused`.

Plain functions (PyTorch runs eagerly; there is nothing to jit): voxel
downsample -> hough prefilter -> voxel-set overlap -> auto-tuned trim ratio
-> trimmed point-to-plane ICP -> gates -> total-correction chaining, on the
device of the inputs. Only `with_risk=False` is ported; the risk stage
(FOV overlap, alignability, classifier) is ROADMAP Q1 #9.
"""
from __future__ import annotations

import dataclasses

import torch

from ..geometry import se3
from ..ops.segmentation import plane_segmentation_filter
from ..ops.voxel import voxel_downsample, voxel_set_overlap
from ..registration.icp import clamp_trim_ratio, point_to_plane_icp
from .config import PipelineConfig


@dataclasses.dataclass(frozen=True)
class FusedFrameOutput:
    correction: torch.Tensor       # (4, 4)
    overlap_percent: torch.Tensor  # 0-d
    trim_ratio: torch.Tensor
    n_iterations: int
    inlier_rms: torch.Tensor
    hessian: torch.Tensor          # (6, 6)
    filtered_points: torch.Tensor  # (F, 3) prefiltered reading
    filtered_mask: torch.Tensor    # (F,)


@dataclasses.dataclass(frozen=True)
class AppFrameOutput:
    """Everything App.process_cloud needs from one frame step."""

    correction: torch.Tensor       # (4, 4) GATED: identity when a gate fails
    correction_raw: torch.Tensor   # (4, 4) the ICP solution before gating
    risk_ok: torch.Tensor          # bool: risk / overlap gate passed
    accepted: torch.Tensor         # bool: accept gate passed
    new_total: torch.Tensor        # (4, 4) correction @ prev_total
    overlap_percent: torch.Tensor  # 0-d (or the fixed override)
    fov_overlap: torch.Tensor      # -1: risk stage off
    alignability: torch.Tensor     # -1: risk stage off
    risk: torch.Tensor             # -1: no classifier
    trim_ratio: torch.Tensor
    n_iterations: int
    inlier_rms: torch.Tensor
    hessian: torch.Tensor          # (6, 6)
    filtered_points: torch.Tensor  # (F, 3) prefiltered reading
    filtered_mask: torch.Tensor    # (F,)
    filtered_normals: torch.Tensor  # (F, 3) viewpoint-oriented normals
    filtered_count: torch.Tensor   # 0-d
    aligned_points: torch.Tensor   # (F, 3) gated correction @ filtered
    aligned_normals: torch.Tensor  # (F, 3) rotated normals


def _pre_voxelized(cfg: PipelineConfig, n_points: int) -> bool:
    """True when a cloud of `n_points` already went through the host wire
    voxel filter at a leaf >= the device voxel size, so the device voxel
    stage is skipped."""
    return (0.0 < cfg.voxel_size <= cfg.wire_voxel
            and n_points <= cfg.downsample_capacity)


def _prefilter(cfg: PipelineConfig, points, mask, viewpoint):
    """Voxel + planes-only prefilter -> (points, mask, normals)."""
    if _pre_voxelized(cfg, points.shape[0]):
        dpts, dmask = points, mask
    else:
        dpts, dmask = voxel_downsample(points, mask, cfg.voxel_size,
                                       cfg.downsample_capacity)
    fpts, fmask, fnormals, _, _ = plane_segmentation_filter(
        dpts, dmask, viewpoint=viewpoint,
        normal_k=cfg.prefilter_normal_k, graph_k=cfg.graph_k,
        smoothness_deg=cfg.smoothness_deg,
        min_cluster_size=cfg.min_cluster_size,
        out_capacity=cfg.filtered_capacity,
        method=cfg.segmentation_method,
        normal_radius=cfg.normal_radius)
    return fpts, fmask, fnormals


def _overlap_percent(cfg, ref_points, ref_mask, fpts, fmask):
    """Occupancy overlap at the octree resolution, in percent."""
    n_common, n_ref, n_read = voxel_set_overlap(
        ref_points, ref_mask, fpts, fmask, cfg.octree_resolution)
    ra = n_common / torch.clamp(n_ref, min=1)
    rb = n_common / torch.clamp(n_read, min=1)
    return torch.minimum(ra, rb) * 100.0


def make_frame_step(cfg: PipelineConfig):
    """(reading_points, reading_mask, reading_viewpoint, ref_points,
    ref_normals, ref_mask, init_T) -> FusedFrameOutput."""

    def frame_step(reading_points, reading_mask, reading_viewpoint,
                   ref_points, ref_normals, ref_mask, init_T):
        fpts, fmask, _ = _prefilter(cfg, reading_points, reading_mask,
                                    reading_viewpoint)
        overlap = _overlap_percent(cfg, ref_points, ref_mask, fpts, fmask)
        ratio = clamp_trim_ratio(overlap, cfg.trim_ratio_floor,
                                 cfg.trim_ratio_ceil)
        res = point_to_plane_icp(fpts, fmask, ref_points, ref_normals,
                                 ref_mask, init_T, ratio, cfg.icp)
        return FusedFrameOutput(
            correction=res.T, overlap_percent=overlap, trim_ratio=ratio,
            n_iterations=res.n_iterations, inlier_rms=res.inlier_rms,
            hessian=res.hessian, filtered_points=fpts, filtered_mask=fmask)

    return frame_step


def make_app_frame_step(cfg: PipelineConfig, with_risk: bool = False,
                        with_classifier: bool = False):
    """The App's per-frame block:

      (raw_points, raw_mask, odom_pose, prev_total, ref_points, ref_normals,
       ref_mask, ref_pose, fixed_overlap, allow_large) -> AppFrameOutput

    Poses and `prev_total` are (4, 4) tensors on the points' device;
    `fixed_overlap` (float, >= 0 overrides the computed overlap) and
    `allow_large` (bool, exempts the frame from the accept gate) are host
    values. In debug working mode `prev_total` is applied to the reading
    first. The gates and the total-correction chaining run on the device.
    """
    if with_risk or with_classifier:
        raise NotImplementedError(
            "make_app_frame_step(with_risk=True): the risk stage (FOV "
            "overlap, alignability, classifier) is ROADMAP Q1 #9")
    debug_mode = cfg.working_mode != "robot"
    max_corr = float(cfg.max_correction_magnitude)

    def app_step(raw_points, raw_mask, odom_pose, prev_total, ref_points,
                 ref_normals, ref_mask, ref_pose, fixed_overlap,
                 allow_large):
        dev = raw_points.device
        if debug_mode:
            read_pose = prev_total @ odom_pose
            pts = se3.transform_points(prev_total, raw_points)
        else:
            read_pose = odom_pose
            pts = raw_points
        fpts, fmask, fnormals = _prefilter(cfg, pts, raw_mask,
                                           read_pose[:3, 3])

        if fixed_overlap >= 0.0:
            overlap = torch.full((), float(fixed_overlap),
                                 dtype=torch.float32, device=dev)
        else:
            overlap = _overlap_percent(cfg, ref_points, ref_mask, fpts,
                                       fmask)
        minus1 = torch.full((), -1.0, dtype=torch.float32, device=dev)

        ratio = clamp_trim_ratio(overlap, cfg.trim_ratio_floor,
                                 cfg.trim_ratio_ceil)
        eye4 = se3.identity(device=dev)
        res = point_to_plane_icp(fpts, fmask, ref_points, ref_normals,
                                 ref_mask, eye4, ratio, cfg.icp)

        # Gates. Overlap gate (same skip semantics as a high risk), then
        # the accept gate: any axis of the correction translation over the
        # magnitude cap drops the frame.
        risk_ok = torch.ones((), dtype=torch.bool, device=dev)
        if cfg.min_overlap_percent > 0.0:
            risk_ok = overlap >= cfg.min_overlap_percent
        corr_g = torch.where(risk_ok, res.T, eye4)
        accepted = (torch.abs(corr_g[:3, 3]) <= max_corr).all()
        if allow_large:
            accepted = torch.ones_like(accepted)
        corr_f = torch.where(accepted, corr_g, eye4)

        return AppFrameOutput(
            correction=corr_f, correction_raw=res.T, risk_ok=risk_ok,
            accepted=accepted, new_total=corr_f @ prev_total,
            overlap_percent=overlap, fov_overlap=minus1,
            alignability=minus1, risk=minus1, trim_ratio=ratio,
            n_iterations=res.n_iterations, inlier_rms=res.inlier_rms,
            hessian=res.hessian, filtered_points=fpts, filtered_mask=fmask,
            filtered_normals=fnormals, filtered_count=fmask.sum(),
            aligned_points=se3.transform_points(corr_f, fpts),
            aligned_normals=se3.rotate_vectors(corr_f, fnormals))

    return app_step


def make_reference_prep(cfg: PipelineConfig):
    """(points, mask, viewpoint) -> (points, mask, normals): the reference
    side's prefilter; the hough prefilter's normals serve ICP directly."""

    def prep(points, mask, viewpoint):
        return _prefilter(cfg, points, mask, viewpoint)

    return prep
