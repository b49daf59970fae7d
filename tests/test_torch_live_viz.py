"""The port's live viewer (`utils.live_viz`) on the CPU: the four cases of
tests/test_live_viz.py on the port, the same publish calls on both
packages' LiveVisualizers giving identical byte streams, each package's
`read_frames` decoding the other's publisher, and `close()` joining every
thread it started."""
import socket
import threading
import time

import numpy as np
import pytest
import torch

from aicp_mapping_tpu.utils import live_viz as jlive
from aicp_mapping_tpu_torch.utils import live_viz
from aicp_mapping_tpu_torch.utils.drawing import octree_wireframe
from aicp_mapping_tpu_torch.utils.live_viz import LiveVisualizer, read_frames

torch.set_num_threads(1)


def _connect(vis) -> socket.socket:
    s = socket.create_connection(vis.address, timeout=5)
    deadline = time.time() + 5
    while time.time() < deadline:
        with vis._lock:
            if vis._clients:
                return s
        time.sleep(0.01)
    raise TimeoutError("client never registered")


def _publish_all(vis) -> None:
    """One call of every hook, with arrays of every shape they take."""
    rng = np.random.default_rng(3)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = [1.5, -2.0, 0.25]
    vis.publish_cloud(rng.normal(size=(700, 3)), 0, "reading", 10)
    vis.publish_map(rng.normal(size=(300, 3)).astype(np.float32), 11, 1)
    vis.publish_pose(pose, 0, "", 12)
    vis.publish_prior_pose(pose * 2, 0, "prior", 13)
    vis.publish_odom_pose(pose * 3, 0, "odom", 14)
    vis.publish_odom_to_map(np.linalg.inv(pose), 15)
    vis.publish_metric("octree_overlap", np.float32(87.25), 16)
    vis.publish_lines(octree_wireframe(rng.uniform(-2, 2, (40, 3)), 0.5),
                      "octree", 17)
    vis.publish_metric("done", 1.0, 18)


def _raw_stream(vis, end: bytes) -> bytes:
    """The bytes a viewer receives for `_publish_all`, up to `end`."""
    s = _connect(vis)
    _publish_all(vis)
    buf = b""
    deadline = time.time() + 10
    while not buf.endswith(end) and time.time() < deadline:
        buf += s.recv(1 << 16)
    s.close()
    return buf


def test_cloud_pose_metric_roundtrip():
    vis = LiveVisualizer()
    try:
        s = _connect(vis)
        cloud = np.random.default_rng(0).normal(size=(1000, 3)).astype(
            np.float32)
        pose = np.eye(4, dtype=np.float32)
        pose[:3, 3] = [1, 2, 3]
        vis.publish_cloud(cloud, 0, "reading", 42)
        vis.publish_pose(pose, 0, "", 43)
        vis.publish_metric("octree_overlap", 87.5, 44)
        it = read_frames(s)
        (h1, a1), (h2, a2), (h3, _) = (next(it) for _ in range(3))
        assert h1["type"] == "cloud" and h1["utime"] == 42
        np.testing.assert_array_equal(a1, cloud)
        assert h2["type"] == "pose"
        np.testing.assert_array_equal(a2, pose)
        assert h3["type"] == "metric" and h3["value"] == 87.5
        s.close()
    finally:
        vis.close()


def test_slow_viewer_never_blocks_publisher():
    vis = LiveVisualizer(max_queue=4)
    try:
        s = _connect(vis)
        cloud = np.zeros((5000, 3), np.float32)
        t0 = time.perf_counter()
        for i in range(200):
            vis.publish_cloud(cloud, 0, "x", i)
        assert time.perf_counter() - t0 < 2.0      # no backpressure stall
        assert vis.n_dropped > 0                   # oldest frames dropped
        s.close()
    finally:
        vis.close()


def test_app_streams_through_live_visualizer():
    """The port's App with the live sink: a viewer receives the reference
    cloud, map, pose and metric stream."""
    from aicp_mapping_tpu_torch.pipeline import (App, PipelineConfig,
                                                 SequenceRunner)
    from aicp_mapping_tpu_torch.pipeline.sequence import synthetic_sequence

    vis = LiveVisualizer()
    try:
        s = _connect(vis)
        got: list[str] = []

        def reader():
            for h, _ in read_frames(s):
                got.append(h["type"])

        th = threading.Thread(target=reader, daemon=True)
        th.start()
        cfg = PipelineConfig(raw_capacity=8192, downsample_capacity=4096,
                             filtered_capacity=2048, min_cluster_size=30)
        items, _ = synthetic_sequence(n_frames=6, n_points=5000, seed=0)
        SequenceRunner(App(cfg, device="cpu", visualizer=vis)).run_clouds(
            items)
        deadline = time.time() + 10
        while time.time() < deadline and not {"map", "pose"} <= set(got):
            time.sleep(0.05)
        s.close()
        th.join(timeout=5)
        assert {"cloud", "map", "pose", "metric"} <= set(got), got
    finally:
        vis.close()


def test_lines_frame_roundtrip():
    vis = LiveVisualizer()
    try:
        sock = _connect(vis)
        pts = np.random.default_rng(1).uniform(-2, 2, (50, 3)).astype(
            np.float32)
        segs = octree_wireframe(pts, 0.5)
        vis.publish_lines(segs, "octree", 123)
        vis.publish_metric("done", 1.0, 124)
        header, arr = next(read_frames(sock))
        assert header["type"] == "lines" and header["name"] == "octree"
        np.testing.assert_allclose(arr, segs, atol=1e-6)
        sock.close()
    finally:
        vis.close()


def test_byte_streams_equal_jax():
    """The same publish calls on both packages' publishers give the same
    bytes on the wire, decimation of an oversized cloud included."""
    end = jlive._encode({"type": "metric", "name": "done", "value": 1.0,
                         "utime": 18})
    assert live_viz._encode({"type": "metric", "name": "done", "value": 1.0,
                             "utime": 18}) == end
    streams = []
    for cls in (jlive.LiveVisualizer, LiveVisualizer):
        vis = cls(max_points=256)
        try:
            streams.append(_raw_stream(vis, end))
        finally:
            vis.close()
    assert streams[0].endswith(end) and len(streams[0]) > 10_000
    assert streams[0] == streams[1]


@pytest.mark.parametrize("publisher,reader", [
    (jlive.LiveVisualizer, read_frames),
    (LiveVisualizer, jlive.read_frames)])
def test_each_reader_decodes_the_other_publisher(publisher, reader):
    vis = publisher(max_points=256)
    try:
        s = _connect(vis)
        _publish_all(vis)
        frames = []
        for h, a in reader(s):
            frames.append((h, a))
            if h.get("name") == "done":
                break
        s.close()
    finally:
        vis.close()
    kinds = [h["type"] for h, _ in frames]
    assert kinds == ["cloud", "map", "pose", "prior_pose", "odom_pose",
                     "odom_to_map", "metric", "lines", "metric"]
    assert frames[0][1].shape == (234, 3)     # 700 rows, every 3rd kept
    assert frames[2][1][0, 3] == 1.5 and frames[6][0]["value"] == 87.25
    assert frames[7][1].shape[1:] == (2, 3)


def test_close_joins_every_thread():
    """close() releases a writer blocked on a viewer that never reads and
    leaves no thread of the visualizer running."""
    vis = LiveVisualizer(max_queue=2)
    socks = [_connect(vis)]
    socks.append(socket.create_connection(vis.address, timeout=5))
    deadline = time.time() + 5
    while len(vis._clients) < 2 and time.time() < deadline:
        time.sleep(0.01)
    big = np.zeros((200_000, 3), np.float32)   # fills the socket buffers
    for i in range(20):
        vis.publish_cloud(big, 0, "x", i)
    threads = [vis._acceptor] + [c["thread"] for c in vis._clients]
    assert len(threads) == 3 and all(t.is_alive() for t in threads)
    t0 = time.perf_counter()
    vis.close()
    assert time.perf_counter() - t0 < 5.0
    assert not any(t.is_alive() for t in threads)
    for s in socks:
        s.close()
