"""Field-of-view (frustum) overlap between two sensor views, PyTorch port
of `aicp_mapping_tpu.overlap.fov`: each cloud is tested for membership in
the other sensor's field of view (azimuth window and range), and

    overlap = fracA_in_fovB * fracB_in_fovA * 100.

The in-FOV masks are returned too: the alignability filter runs on them.
"""
from __future__ import annotations

import torch

from ..geometry import se3


def _in_fov(points, mask, pose, sensor_range, angular_view_deg):
    """Membership of world-frame points in the sensor frustum at `pose`:
    |azimuth| < 180 - (360 - angular_view) / 2 and range < sensor_range."""
    local = se3.transform_points(se3.inverse(pose), points)
    r = torch.linalg.norm(local, dim=-1)
    theta = torch.rad2deg(torch.atan2(local[..., 1], local[..., 0]))
    thresh = 180.0 - (360.0 - angular_view_deg) / 2.0
    ok = (theta < thresh) & (theta > -thresh) & (r < sensor_range)
    return mask & ok


def fov_overlap(points_a, mask_a, pose_a, points_b, mask_b, pose_b,
                sensor_range=100.0, angular_view_deg=360.0):
    """Returns (overlap_percent, maskA_in_fovB, maskB_in_fovA)."""
    a_in_b = _in_fov(points_a, mask_a, pose_b, sensor_range,
                     angular_view_deg)
    b_in_a = _in_fov(points_b, mask_b, pose_a, sensor_range,
                     angular_view_deg)
    na = torch.clamp(mask_a.to(torch.float32).sum(), min=1.0)
    nb = torch.clamp(mask_b.to(torch.float32).sum(), min=1.0)
    frac_a = a_in_b.to(torch.float32).sum() / na
    frac_b = b_in_a.to(torch.float32).sum() / nb
    return frac_a * frac_b * 100.0, a_in_b, b_in_a
