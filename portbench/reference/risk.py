"""The failure-prediction stage of the AICP frame in plain PyTorch: the
reference that decides `correct` in a cell with failure prediction on.

Nobili et al., "Predicting alignment risk to prevent localization
failure" (ICRA 2018): before a correction is trusted, the frame's
alignment risk is predicted from two features of the reference cloud and
the reading, their overlap and their alignability, by a classifier; a
risky frame's correction is discarded. `RiskPath` holds one
configuration and computes, as `aicp_mapping_tpu_torch/pipeline/fused.py:
risk_stage` and `pipeline/app.py` define it:

- the FOV overlap: each cloud's points inside the other sensor's field of
  view (|azimuth| under half the angular view, range under
  `sensor_range`, in that sensor's frame), overlap = the product of the
  two shares, in percent;
- the alignability of the two in-FOV subsets: each voxel-downsampled
  (`voxel_size`, `align_ds_capacity`), given exact 30-NN normals toward
  its sensor, segmented into smooth regions (15-NN pairs whose normals
  are within 3 degrees; points over curvature 1 join but do not forward),
  regions under 50 points dropped and the `align_max_clusters` largest
  kept; each region's oriented bounding box (its PCA axes, its extents);
  each reference region matched to the reading region whose points fill
  the most of its box and whose box holds the most of its own (box
  normal extent times 3), among those whose mean normal is within 20
  degrees, each reading region kept by the reference region that scores
  it highest; alignability = 100 l_min / l_max of the second moment of
  the matched reference regions' normals (0 without a match);
- P(failure) = sigmoid of the degree-3 polynomial SVM's decision on the
  standardised (voxel overlap, alignability), its weights, bias, mean
  and scale read from the configuration's classifier file;
- the gate: a frame whose P(failure) is over `risk_threshold` keeps its
  prior, its filtered cloud becomes the reference, and the next frame
  registers against it. (The port's second gate, a voxel overlap under
  `min_overlap_percent`, is not modelled: a configuration that sets it is
  refused.)

It runs in float32 with TF32 off, as `frame.py`, on `plain.py`'s voxel
grid and 3x3 eigen-solver. Departures from the port, each a precision
or an order of work, none of the semantics:

- label propagation runs to its fixed point (the port stops after 64
  rounds of one pull and six pointer jumps, which no cloud of this size
  needs);
- the regions' sizes, means, covariances, normal sums and the matched
  normals' second moment are summed in float64 (the port: float32,
  whose `scatter_reduce("sum")` is an atomic on the card), and their
  eigen-decompositions run in float64 (the port: `torch.linalg.eigh` in
  float32);
- the classifier's decision is taken in float64 and rounded once.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import plain

NORMAL_K = 30
GRAPH_K = 15
SMOOTHNESS_DEG = 3.0
CURVATURE_MAX = 1.0
MIN_CLUSTER = 50
MAX_CENTROID_DEG = 20.0
Z_SCALE = 3.0
_BIG = 3.4e38


@dataclasses.dataclass
class Risk:
    fov: float
    alignability: float
    risk: float          # P(failure)
    gated: bool          # the risk gate discards the frame


def _inverse(T: torch.Tensor) -> torch.Tensor:
    R = T[:3, :3].T
    out = torch.eye(4, dtype=T.dtype, device=T.device)
    out[:3, :3] = R
    out[:3, 3] = -torch.einsum("ij,j->i", R, T[:3, 3])
    return out


def in_fov(points, mask, pose, sensor_range: float, view_deg: float):
    """`mask` and: inside the field of view of a sensor at `pose`."""
    local = plain.transform_points(_inverse(pose), points)
    r = torch.linalg.norm(local, dim=-1)
    theta = torch.rad2deg(torch.atan2(local[:, 1], local[:, 0]))
    half = 180.0 - (360.0 - view_deg) / 2.0
    return mask & (theta < half) & (theta > -half) & (r < sensor_range)


def fov_overlap(points_a, mask_a, pose_a, points_b, mask_b, pose_b,
                sensor_range: float, view_deg: float):
    """(overlap %, A in B's view, B in A's view)."""
    a_in_b = in_fov(points_a, mask_a, pose_b, sensor_range, view_deg)
    b_in_a = in_fov(points_b, mask_b, pose_a, sensor_range, view_deg)
    share_a = a_in_b.sum() / torch.clamp(mask_a.sum(), min=1)
    share_b = b_in_a.sum() / torch.clamp(mask_b.sum(), min=1)
    return (share_a * share_b * 100.0).float(), a_in_b, b_in_a


# ------------------------------------------------------- segmentation ----

def knn(points, mask, k: int, block: int = 512):
    """Exact k nearest valid points of every point (itself included),
    nearest first, ties to the lower index."""
    out = []
    for s in range(0, points.shape[0], block):
        d = torch.where(mask[None, :], plain.sq_dists(points[s:s + block],
                                                      points), _BIG)
        out.append(torch.sort(d, dim=1, stable=True).indices[:, :k])
    return torch.where(mask[:, None], torch.cat(out), 0)


def knn_normals(points, mask, idx, viewpoint):
    """(normals, curvature) of each point's neighbourhood: covariance
    summed in float64, rounded to float32 once, its smallest eigenvector
    turned toward `viewpoint`; curvature = l_min / (l_0 + l_1 + l_2)."""
    nbrs = points[idx].double()
    w = (mask[idx] & mask[:, None]).double()[..., None]
    cnt = torch.clamp(w.sum(1), min=1.0)
    mean = (nbrs * w).sum(1) / cnt
    c = (nbrs - mean[:, None, :]) * w
    cov = (torch.einsum("nki,nkj->nij", c, c) / cnt[..., None]).float()
    eigvals, normal = plain._eigh3x3_smallest(cov)
    curvature = torch.clamp(eigvals[:, 0], min=0.0) / torch.clamp(
        plain._sum3(eigvals), min=1e-12)
    flip = plain._sum3(normal * (viewpoint - points)) < 0
    normal = torch.where(flip[:, None], -normal, normal)
    return (torch.where(mask[:, None], normal, 0.0),
            torch.where(mask, curvature, 0.0))


def regions(points, mask, normals, curvature, idx):
    """Each point's region: the least index it reaches by pulling labels
    from its `GRAPH_K` nearest neighbours whose normals are within
    `SMOOTHNESS_DEG` and which may forward (curvature <= 1); -1 for
    invalid points."""
    n = points.shape[0]
    idx = idx[:, :GRAPH_K]
    cos_min = torch.cos(torch.deg2rad(torch.tensor(
        SMOOTHNESS_DEG, dtype=torch.float32))).item()
    dots = torch.einsum("nd,nkd->nk", normals, normals[idx]).abs()
    forwards = (curvature <= CURVATURE_MAX) & mask
    pull = (dots >= cos_min) & mask[:, None] & mask[idx] & forwards[idx]
    labels = torch.where(mask, torch.arange(n, device=points.device), n)
    while True:
        new = torch.minimum(labels, torch.where(pull, labels[idx],
                                                n).amin(1))
        while True:      # pointer jumping: a label's own label
            jumped = torch.where(new < n, torch.minimum(
                new, new[torch.clamp(new, max=n - 1)]), n)
            if torch.equal(jumped, new):
                break
            new = jumped
        if torch.equal(new, labels):
            return torch.where(mask, labels, -1)
        labels = new


def top_regions(labels, n_top: int):
    """Regions of at least `MIN_CLUSTER` points, the `n_top` largest
    (equal sizes by the lower root) renumbered 0..; -1 for the rest.
    Returns (labels, valid (n_top,))."""
    n = labels.shape[0]
    root = torch.where(labels >= 0, labels, n)
    size = torch.zeros(n + 1, dtype=torch.int64,
                       device=labels.device).index_add_(
        0, root, torch.ones_like(root))[:n]
    size = torch.where(size >= MIN_CLUSTER, size, 0)
    top_size, top_root = torch.sort(size, descending=True, stable=True)
    valid = top_size[:n_top] > 0
    rank = torch.full((n + 1,), -1, dtype=torch.int64, device=labels.device)
    rank[top_root[:n_top][valid]] = torch.arange(
        n_top, device=labels.device)[valid]
    return rank[root], valid


def segment(points, mask, pose, p: dict):
    """(points, normals, region labels, region valid) of one in-FOV
    subset."""
    pts, m = plain.voxel_downsample(points, mask, p["voxel_size"],
                                    p["align_ds_capacity"])
    idx = knn(pts, m, max(NORMAL_K, GRAPH_K))
    normals, curvature = knn_normals(pts, m, idx[:, :NORMAL_K], pose[:3, 3])
    labels, valid = top_regions(regions(pts, m, normals, curvature, idx),
                                p["align_max_clusters"])
    return pts, normals, labels, valid


def _sums(values, labels, n: int):
    """Per-region sums of rows of `values` (float64), n regions."""
    seg = torch.where(labels >= 0, labels, n)
    out = torch.zeros((n + 1,) + values.shape[1:], dtype=torch.float64,
                      device=values.device)
    return out.index_add_(0, seg, values.double())[:n]


def boxes(points, normals, labels, n: int):
    """Per region: size, mean normal (unnormalised), oriented bounding box
    (mean, axes major-middle-minor as columns, lo and hi extents)."""
    size = _sums(torch.ones_like(points[:, 0]), labels, n)
    safe = torch.clamp(size, min=1.0)
    normal = (_sums(normals, labels, n) / safe[:, None]).float()
    mean = (_sums(points, labels, n) / safe[:, None]).float()
    lab = torch.clamp(labels, 0, n - 1)
    inside = (labels >= 0)[:, None]
    c = torch.where(inside, points - mean[lab], 0.0)
    cov = _sums(c[:, :, None] * c[:, None, :], labels, n) / safe[:, None,
                                                                 None]
    axes = torch.flip(torch.linalg.eigh(cov)[1], dims=[-1]).float()
    local = torch.einsum("nj,nji->ni", c, axes[lab])
    seg = torch.where(labels >= 0, labels, n)
    lo = torch.full((n + 1, 3), _BIG, device=points.device).scatter_reduce(
        0, seg[:, None].expand(-1, 3), local, "amin")[:n]
    hi = torch.full((n + 1, 3), -_BIG, device=points.device).scatter_reduce(
        0, seg[:, None].expand(-1, 3), local, "amax")[:n]
    some = (size > 0)[:, None]
    return (size.float(), normal, mean, axes, torch.where(some, lo, 0.0),
            torch.where(some, hi, 0.0))


def points_in_boxes(points, labels, n: int, mean, axes, lo, hi):
    """counts[i, j]: points of region j inside box i, its normal extent
    `Z_SCALE` times."""
    scale = torch.tensor([1.0, 1.0, Z_SCALE], device=points.device)
    lo, hi = lo * scale, hi * scale
    local = torch.einsum("cnj,cji->cni", points[None] - mean[:, None],
                         axes)
    inside = ((local >= lo[:, None]) & (local <= hi[:, None])).all(-1)
    member = labels[None, :] == torch.arange(n, device=points.device)[:, None]
    return torch.stack([(inside & member[j]).sum(1) for j in range(n)],
                       dim=1).float()


def alignability(points_a, mask_a, pose_a, points_b, mask_b, pose_b,
                 p: dict) -> torch.Tensor:
    """Alignability in [0, 100] of reference A and reading B (world
    frame, their in-FOV subsets)."""
    n = p["align_max_clusters"]
    pa, na, la, va = segment(points_a, mask_a, pose_a, p)
    pb, nb, lb, vb = segment(points_b, mask_b, pose_b, p)
    size_a, nc_a, mean_a, axes_a, lo_a, hi_a = boxes(pa, na, la, n)
    size_b, nc_b, mean_b, axes_b, lo_b, hi_b = boxes(pb, nb, lb, n)
    cos = (nc_a @ nc_b.T) / torch.clamp(
        torch.linalg.norm(nc_a, dim=1)[:, None]
        * torch.linalg.norm(nc_b, dim=1)[None, :], min=1e-12)
    angle = torch.rad2deg(torch.arccos(torch.clamp(cos, -1.0, 1.0)))
    b_in_a = points_in_boxes(pb, lb, n, mean_a, axes_a, lo_a, hi_a)
    a_in_b = points_in_boxes(pa, la, n, mean_b, axes_b, lo_b, hi_b)
    score = (a_in_b.T / torch.clamp(size_a[:, None], min=1.0)
             * (b_in_a / torch.clamp(size_b[None, :], min=1.0)) * 100.0)
    ok = (angle < MAX_CENTROID_DEG) & va[:, None] & vb[None, :]
    score = torch.where(ok, score, -1.0)
    best, best_b = score.max(dim=1)               # first maximum
    claims = torch.where((best > 0)[:, None] & (
        best_b[:, None] == torch.arange(n, device=pa.device)[None, :]),
        best[:, None], -1.0)
    top, winner = claims.max(dim=0)
    matched = torch.zeros(n, dtype=torch.bool, device=pa.device)
    matched[winner[top > 0]] = True
    w = ((la >= 0) & matched[torch.clamp(la, 0, n - 1)]).double()
    m2 = torch.einsum("n,ni,nj->ij", w, na.double(), na.double())
    lam = torch.linalg.eigvalsh(m2)
    if w.sum() == 0:
        return torch.zeros((), device=pa.device)
    return (100.0 * torch.clamp(lam[0], min=0.0)
            / torch.clamp(lam[2], min=1e-12)).float()


# ------------------------------------------------------- classifier ----

class RiskPath:
    def __init__(self, config: dict, device):
        self.device = torch.device(device)
        self.p = config["pipeline"]
        if self.p.get("min_overlap_percent", 0.0) > 0.0:
            raise ValueError("the reference has no overlap gate: the "
                             "configuration sets min_overlap_percent")
        d = np.load(self.p["classifier_path"])
        self.model = {k: torch.as_tensor(np.asarray(d[k], np.float64),
                                         device=self.device)
                      for k in ("w", "b", "mean", "std")}

    def probability(self, overlap: float, align: float) -> float:
        """P(failure) of (voxel overlap %, alignability)."""
        m = self.model
        z = (torch.tensor([overlap, align], dtype=torch.float64,
                          device=self.device) - m["mean"]) / m["std"]
        x, y = z[0], z[1]
        phi = torch.stack([torch.ones_like(x), x, y, x * x, x * y, y * y,
                           x * x * x, x * x * y, x * y * y, y * y * y])
        return float(torch.sigmoid((phi * m["w"]).sum() + m["b"]))

    def stage(self, ref_points, ref_mask, ref_pose, points, mask, pose,
              overlap: float) -> Risk:
        """The risk stage of a reading (at `pose`) against its reference
        (at `ref_pose`), the frame's voxel overlap given."""
        p = self.p
        ref_T = torch.as_tensor(np.asarray(ref_pose, np.float32),
                                device=self.device)
        T = torch.as_tensor(np.asarray(pose, np.float32), device=self.device)
        fov, a_in_b, b_in_a = fov_overlap(
            ref_points, ref_mask, ref_T, points, mask, T, p["sensor_range"],
            p["sensor_angular_view"])
        align = float(alignability(ref_points, a_in_b, ref_T, points, b_in_a,
                                   T, p))
        risk = self.probability(overlap, align)
        return Risk(float(fov), align, risk, risk > float(p["risk_threshold"]))
