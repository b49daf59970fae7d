"""Visualizer sinks, numpy port of `aicp_mapping_tpu.utils.visualizer`.

The App publishes clouds, maps, poses and metrics to a sink as host numpy
arrays: `NullVisualizer` (the default: the App then reads nothing from the
device for it), `RecordingVisualizer` (in memory, for tests and
evaluators) and `FileVisualizer` (also PCD dumps, through `io.pcd`).
`utils.live_viz.LiveVisualizer` streams to TCP viewers.
"""
from __future__ import annotations

import os

import numpy as np

from ..io.pcd import write_pcd


def occupied_cells(points: np.ndarray, resolution: float) -> np.ndarray:
    """Centres of the occupied voxel cells of side `resolution` (the
    reference's octree leaves at a query depth), sorted by cell index."""
    pts = np.asarray(points, np.float32).reshape(-1, 3)
    q = np.unique(np.floor(pts / resolution).astype(np.int64), axis=0)
    return ((q + 0.5) * resolution).astype(np.float32)


class Visualizer:
    """Abstract sink; every hook is an optional no-op."""

    def publish_cloud(self, points: np.ndarray, channel: int, name: str,
                      utime: int) -> None: ...

    def publish_map(self, points: np.ndarray, utime: int,
                    channel: int) -> None: ...

    def publish_pose(self, pose: np.ndarray, channel: int, name: str,
                     utime: int) -> None: ...

    def publish_prior_pose(self, pose: np.ndarray, channel: int, name: str,
                           utime: int) -> None: ...

    def publish_odom_pose(self, pose: np.ndarray, channel: int, name: str,
                          utime: int) -> None: ...

    def publish_odom_to_map(self, pose: np.ndarray, utime: int) -> None: ...

    def publish_metric(self, name: str, value: float, utime: int) -> None: ...

    def publish_lines(self, segments: np.ndarray, name: str,
                      utime: int) -> None:
        """Line segments (K, 2, 3): octree wireframes and normal whiskers
        from `utils.drawing`."""
        ...

    def get_path(self) -> list[np.ndarray]:
        return [np.eye(4, dtype=np.float32)]


class NullVisualizer(Visualizer):
    pass


class RecordingVisualizer(Visualizer):
    """Keeps every publish in memory, as (utime, array) pairs per hook."""

    def __init__(self) -> None:
        self.clouds: list[tuple[int, np.ndarray]] = []
        self.maps: list[tuple[int, np.ndarray]] = []
        self.poses: list[tuple[int, np.ndarray]] = []
        self.prior_poses: list[tuple[int, np.ndarray]] = []
        self.odom_poses: list[tuple[int, np.ndarray]] = []
        self.odom_to_map: list[tuple[int, np.ndarray]] = []
        self.metrics: dict[str, list[tuple[int, float]]] = {}
        self.lines: list[tuple[int, str, np.ndarray]] = []

    def publish_cloud(self, points, channel, name, utime):
        self.clouds.append((utime, np.asarray(points)))

    def publish_map(self, points, utime, channel):
        self.maps.append((utime, np.asarray(points)))

    def publish_pose(self, pose, channel, name, utime):
        self.poses.append((utime, np.asarray(pose)))

    def publish_prior_pose(self, pose, channel, name, utime):
        self.prior_poses.append((utime, np.asarray(pose)))

    def publish_odom_pose(self, pose, channel, name, utime):
        self.odom_poses.append((utime, np.asarray(pose)))

    def publish_odom_to_map(self, pose, utime):
        self.odom_to_map.append((utime, np.asarray(pose)))

    def publish_metric(self, name, value, utime):
        self.metrics.setdefault(name, []).append((utime, float(value)))

    def publish_lines(self, segments, name, utime):
        self.lines.append((utime, name, np.asarray(segments)))

    def get_path(self) -> list[np.ndarray]:
        if not self.poses:
            return [np.eye(4, dtype=np.float32)]
        return [p for _, p in self.poses]


class FileVisualizer(RecordingVisualizer):
    """Also writes each published cloud as `cloud_<name or channel>_<utime>
    .pcd` and the latest map as `aligned_map.pcd` under `directory`."""

    def __init__(self, directory: str) -> None:
        super().__init__()
        self.directory = directory
        os.makedirs(directory, exist_ok=True)

    def publish_cloud(self, points, channel, name, utime):
        super().publish_cloud(points, channel, name, utime)
        write_pcd(os.path.join(self.directory,
                               f"cloud_{name or channel}_{utime}.pcd"),
                  np.asarray(points))

    def publish_map(self, points, utime, channel):
        super().publish_map(points, utime, channel)
        write_pcd(os.path.join(self.directory, "aligned_map.pcd"),
                  np.asarray(points))
