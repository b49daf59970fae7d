"""Line geometry for visual debugging, numpy port of
`aicp_mapping_tpu.utils.drawing`: octree wireframes, normal whiskers and
pose axes as (K, 2, 3) segments, which `LiveVisualizer.publish_lines`
streams and `io.vtk.write_vtk_lines` writes for ParaView. Host numpy,
never on the frame path.
"""
from __future__ import annotations

import numpy as np

from .visualizer import occupied_cells

# 12 edges of a unit cube, as index pairs into the 8 corner offsets
_CUBE_CORNERS = np.array(
    [[x, y, z] for x in (0, 1) for y in (0, 1) for z in (0, 1)], np.float32)
_CUBE_EDGES = np.array([
    (0, 1), (0, 2), (0, 4), (1, 3), (1, 5), (2, 3),
    (2, 6), (3, 7), (4, 5), (4, 6), (5, 7), (6, 7)], np.int64)


def normals_segments(points: np.ndarray, normals: np.ndarray,
                     scale: float = 0.2,
                     stride: int = 1) -> np.ndarray:
    """Per-point normal whiskers (drawPointCloudNormalsCollections analog).

    Returns (K, 2, 3): segment k runs from point k to point k + scale *
    normal k. `stride` subsamples for dense clouds."""
    p = np.asarray(points, np.float32).reshape(-1, 3)[::stride]
    n = np.asarray(normals, np.float32).reshape(-1, 3)[::stride]
    return np.stack([p, p + scale * n], axis=1)


def octree_wireframe(points: np.ndarray, resolution: float) -> np.ndarray:
    """Wireframes of the occupied voxel cells (publishOctreeToLCM analog:
    the reference draws the octree's occupied leaves at a query depth).

    Returns (K * 12, 2, 3) line segments — 12 cube edges per occupied cell
    at `resolution`."""
    centers = occupied_cells(points, resolution)
    if len(centers) == 0:
        return np.zeros((0, 2, 3), np.float32)
    corners = (centers[:, None, :]
               + (_CUBE_CORNERS[None] - 0.5) * resolution)  # (K, 8, 3)
    segs = corners[:, _CUBE_EDGES]                           # (K, 12, 2, 3)
    return segs.reshape(-1, 2, 3).astype(np.float32)


def pose_axes_segments(poses, scale: float = 0.5) -> np.ndarray:
    """RGB-style coordinate-frame whiskers for a pose or list of poses
    (the reference's pose/path markers). Returns (3 * P, 2, 3): x, y, z
    axis segments per pose, in that order."""
    poses = np.asarray(poses, np.float32).reshape(-1, 4, 4)
    origins = poses[:, :3, 3]                                # (P, 3)
    segs = []
    for axis in range(3):
        tips = origins + scale * poses[:, :3, axis]
        segs.append(np.stack([origins, tips], axis=1))
    return np.concatenate(segs).astype(np.float32)
