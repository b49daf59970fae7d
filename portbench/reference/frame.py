"""The AICP front-end frame as the configuration states it, in plain
PyTorch: the reference that decides `correct`.

`FramePath` holds one configuration and computes, from a frame's raw
input, what the App's timed path must produce for it: the device cloud
(the int16 wire), the voxel grid and hough prefilter, the voxel overlap against
the reference cloud, the auto-tuned trim ratio, trimmed point-to-plane ICP
from the identity, the accept gate, and the corrected pose. It follows
`aicp_mapping_tpu_torch/pipeline/fused.py:make_app_frame_step` and
`pipeline/app.py` (robot working mode, failure prediction off, graph
reference) at commit d49b34b8df308b6b17527cfdc9cc292ea998a7ca, on
`plain.py`'s functions.

`reference_schedule` works out which earlier frame each frame registers
against: the bootstrap cloud, then every `reference_update_frequency`-th
frame since the last reference. The synchronous App counts accepted frames
only (a rejected frame's speculative adoption is rolled back); a
pipelined App counts every dispatched frame, since a rejection is seen
only after later frames have adopted newer references.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import plain


@dataclasses.dataclass
class Prefiltered:
    points: torch.Tensor       # (F, 3) in the frame's input (prior) frame
    mask: torch.Tensor
    normals: torch.Tensor
    moments_count: int         # radius neighbours summed over valid points


@dataclasses.dataclass
class Outcome:
    correction: np.ndarray     # (4, 4) the ICP solution
    accepted: bool
    corrected_pose: np.ndarray
    overlap: float
    n_iterations: int
    filtered: Prefiltered
    aligned_points: torch.Tensor


class FramePath:
    def __init__(self, config: dict, device):
        self.device = torch.device(device)
        p = config["pipeline"]
        if not (p["quantized_upload"] and p["wire_voxel"] > 0.0):
            raise ValueError("the reference follows the int16 wire: the "
                             "configuration needs quantized_upload and a "
                             "wire_voxel")
        self.p = p
        self.icp_cfg = plain.ICPConfig(**config["icp"])

    # ---------------------------------------------------------- input ----
    def device_cloud(self, pts: np.ndarray):
        """What the App is handed: (points, mask), off the int16 wire."""
        p = self.p
        return plain.wire_cloud(pts, p["wire_voxel"], p["downsample_capacity"],
                                self.device)

    def prefilter(self, pts: np.ndarray, prior: np.ndarray) -> Prefiltered:
        p = self.p
        points, mask = self.device_cloud(pts)
        if 0.0 < p["voxel_size"] <= p["wire_voxel"] \
                and points.shape[0] <= p["downsample_capacity"]:
            dpts, dmask = points, mask
        else:
            dpts, dmask = plain.voxel_downsample(points, mask,
                                                 p["voxel_size"],
                                                 p["downsample_capacity"])
        viewpoint = torch.as_tensor(np.asarray(prior, np.float32)[:3, 3],
                                    device=self.device)
        moments = []
        fpts, fmask, fnormals = plain.hough_prefilter(
            dpts, dmask, viewpoint, p["normal_radius"],
            p["min_cluster_size"], p["filtered_capacity"],
            moments_out=moments)
        M, valid = moments[0]
        return Prefiltered(fpts, fmask, fnormals,
                           int(M[valid, 9].sum().item()))

    # ---------------------------------------------------------- frame ----
    def register(self, frame: Prefiltered, prior: np.ndarray,
                 ref_points, ref_normals, ref_mask) -> Outcome:
        """The frame registered against a reference cloud. The graph holds
        the bootstrap cloud, so no frame is exempt from the accept gate
        (the App exempts a first registration into an empty graph only)."""
        p = self.p
        dev = self.device
        overlap = plain.overlap_percent(ref_points, ref_mask, frame.points,
                                        frame.mask, p["octree_resolution"])
        ratio = plain.clamp_trim_ratio(overlap, p["trim_ratio_floor"],
                                       p["trim_ratio_ceil"])
        res = plain.icp(frame.points, frame.mask, ref_points, ref_normals,
                        ref_mask, torch.eye(4, device=dev), ratio,
                        self.icp_cfg)
        T = res.T.double().cpu().numpy().astype(np.float32)
        accepted = bool(np.all(
            np.abs(T[:3, 3]) <= np.float32(p["max_correction_magnitude"])))
        prior = np.asarray(prior, np.float32)
        corrected = (plain.repin_roll_pitch_np(T @ prior, prior)
                     if accepted else prior)
        aligned = plain.transform_points(res.T if accepted else
                                         torch.eye(4, device=dev),
                                         frame.points)
        return Outcome(T, accepted, corrected, float(overlap.item()),
                       res.n_iterations, frame, aligned)

    def reference_cloud(self, frame: Prefiltered, correction):
        """(points, normals, mask) of a reference: the frame's prefiltered
        cloud moved by its gated correction (None: the bootstrap)."""
        if correction is None:
            return frame.points, frame.normals, frame.mask
        T = torch.as_tensor(np.asarray(correction, np.float32),
                            device=self.device)
        return (plain.transform_points(T, frame.points),
                plain.rotate_vectors(T, frame.normals), frame.mask)


def reference_schedule(accepted: list, frequency: int,
                       pipelined: bool) -> list:
    """For frames 0..n-1 (0 the bootstrap) and their accept flags, the frame
    each registers against (None for the bootstrap)."""
    refs, ref, since = [None], 0, 0
    for k in range(1, len(accepted)):
        refs.append(ref)
        if pipelined or accepted[k]:
            since += 1
            if since % frequency == 0:
                ref, since = k, 0
    return refs


def graph_index(accepted: list) -> list:
    """Each frame's index in the App's graph of clouds: the bootstrap is 0
    and every accepted frame is appended."""
    out, n = [], 0
    for a in accepted:
        out.append(n)
        n += 1 if a else 0
    return out
