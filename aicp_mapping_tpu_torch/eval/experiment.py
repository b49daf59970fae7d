"""Batch pairwise registration experiments, PyTorch port of
`aicp_mapping_tpu.eval.experiment`.

Every ordered pair of N clouds is registered (the reference's
run_registration.sh over its pair CLI): octree overlap, FOV overlap,
alignability, the optional risk classifier, auto-tuned point-to-plane ICP
against radius normals of the reference (K3 below 16,384 points, the banded
moments above), and the ICP-Hessian degeneracy predictors; results come
out as one line per pair (`compare_results.txt`) and as N x N matrices.
Runs on the card unless the caller asks for the CPU.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch


@dataclasses.dataclass
class PairResult:
    reference_id: int
    reading_id: int
    octree_overlap: float
    fov_overlap: float
    alignability: float
    risk: float
    n_iterations: int
    inlier_rms: float
    correction: np.ndarray        # (4, 4)
    t_error: float = float("nan")  # vs ground truth, when available
    degeneracy: float = float("nan")  # ICP-Hessian predictors
    icn: float = float("nan")


def run_pairwise(clouds: Sequence[np.ndarray],
                 poses: Optional[Sequence[np.ndarray]] = None,
                 capacity: int = 8192,
                 classifier=None,
                 normal_radius: float = 0.4,
                 trim_floor: float = 0.25,
                 device="cuda") -> list[PairResult]:
    """Register every ordered pair (i -> reference, j -> reading), i != j.

    `poses` are ground-truth world poses; when given, clouds are expressed
    in the world frame, the expected correction is the identity, and
    `t_error` reports |t| of the recovered correction.
    """
    from ..cloud import Cloud
    from ..ops.normals import radius_normals
    from ..overlap.alignability import alignability_filter
    from ..overlap.fov import fov_overlap
    from ..overlap.voxel_overlap import compute_overlap
    from ..pipeline.app import check_device
    from ..registration.icp import (clamp_trim_ratio, degeneracy_predictions,
                                    point_to_plane_icp)

    dev = check_device(device, "run_pairwise")
    cs = [Cloud.from_numpy(np.asarray(c, np.float32), capacity=capacity,
                           device=dev) for c in clouds]
    ps = [torch.as_tensor(np.asarray(p, np.float32), device=dev)
          for p in poses] if poses is not None \
        else [torch.eye(4, device=dev) for _ in cs]
    normals = [radius_normals(c.points, c.mask, normal_radius, p[:3, 3])[0]
               for c, p in zip(cs, ps)]
    eye = torch.eye(4, device=dev)

    results = []
    for i in range(len(cs)):
        for j in range(len(cs)):
            if i == j:
                continue
            ref, read = cs[i], cs[j]
            ov = compute_overlap(ref.points, ref.mask, read.points,
                                 read.mask).overlap_percent
            ov_pct = float(ov)
            fov, _, _ = fov_overlap(ref.points, ref.mask, ps[i],
                                    read.points, read.mask, ps[j])
            align, _ = alignability_filter(ref.points, ref.mask, ps[i],
                                           read.points, read.mask, ps[j])
            risk = -1.0
            if classifier is not None:
                risk = float(classifier.test(np.array(
                    [[ov_pct, float(align)]], np.float32)).reshape(-1)[0])
            res = point_to_plane_icp(
                read.points, read.mask, ref.points, normals[i], ref.mask,
                eye, clamp_trim_ratio(ov, trim_floor, 0.70))
            T = res.T.cpu().numpy()
            deg, icn = degeneracy_predictions(res.hessian)
            results.append(PairResult(
                reference_id=i, reading_id=j,
                octree_overlap=ov_pct, fov_overlap=float(fov),
                alignability=float(align), risk=risk,
                n_iterations=int(res.n_iterations),
                inlier_rms=float(res.inlier_rms), correction=T,
                t_error=float(np.linalg.norm(T[:3, 3]))
                if poses is not None else float("nan"),
                degeneracy=float(deg), icn=float(icn)))
    return results


def write_compare_results(path: str, results: list[PairResult]) -> None:
    """One line per pair (registration_main.cpp:503-515's result lines):
    ids, the four metrics, iterations, rms and the correction."""
    with open(path, "w") as f:
        for r in results:
            t = r.correction.reshape(-1)
            vals = [r.reference_id, r.reading_id, r.octree_overlap,
                    r.fov_overlap, r.alignability, r.risk, r.n_iterations,
                    r.inlier_rms] + t.tolist()
            f.write(" ".join(f"{v:.6g}" for v in vals) + "\n")


def matrices(results: list[PairResult], n: int):
    """(overlap, accuracy) N x N matrices for the notebook analyses."""
    ov = np.full((n, n), np.nan)
    terr = np.full((n, n), np.nan)
    for r in results:
        ov[r.reference_id, r.reading_id] = r.octree_overlap
        terr[r.reference_id, r.reading_id] = r.t_error
    return ov, terr
