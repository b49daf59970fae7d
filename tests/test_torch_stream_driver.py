"""The port's StreamingDriver (CPU): every case of tests/test_stream.py on
the port's driver over the port's App, and the port's driver and JAX's
given the same scans, poses and callbacks."""
import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

from aicp_mapping_tpu.geometry import se3 as jse3
from aicp_mapping_tpu.pipeline.app import App as JApp
from aicp_mapping_tpu.pipeline.sequence import \
    synthetic_sequence as jax_sequence
from aicp_mapping_tpu.pipeline.stream import StreamingDriver as JDriver
from aicp_mapping_tpu.pipeline.stream import _rpy as jax_rpy
from aicp_mapping_tpu_torch import App, PipelineConfig, convert
from aicp_mapping_tpu_torch.pipeline.sequence import synthetic_sequence
from aicp_mapping_tpu_torch.pipeline.stream import StreamingDriver, _rpy
from test_golden import TOLERANCES

torch.set_num_threads(1)


def _small_cfg(**kw):
    """tests/test_stream.py's App configuration."""
    return PipelineConfig(raw_capacity=8192, downsample_capacity=4096,
                          filtered_capacity=2048, min_cluster_size=20, **kw)


def _small_app(**kw):
    return App(_small_cfg(**kw), device="cpu")


def _yaw(deg):
    c, s = np.cos(np.deg2rad(deg)), np.sin(np.deg2rad(deg))
    T = np.eye(4, dtype=np.float32)
    T[:2, :2] = [[c, -s], [s, c]]
    return T


def test_rpy_matches_jax():
    import jax.numpy as jnp

    T = np.asarray(jse3.make_transform(
        jse3.so3_exp(jnp.asarray([0.1, -0.2, 0.3])), jnp.zeros(3)))
    q = jse3.matrix_to_quat(jnp.asarray(T[:3, :3]))
    want = [float(v) for v in jse3.quat_to_euler(q)]
    np.testing.assert_allclose(_rpy(T[:3, :3]), want, atol=1e-5)
    np.testing.assert_array_equal(_rpy(T[:3, :3]), jax_rpy(T[:3, :3]))


def test_scan_before_pose_is_ignored():
    drv = StreamingDriver(_small_app(), batch_size=1)
    drv.on_scan(0, np.random.rand(100, 3).astype(np.float32))
    assert drv.accu.count == 0 and not drv._queue


def test_motion_gate_blocks_stationary_clouds():
    drv = StreamingDriver(_small_app(), batch_size=1, max_range=100.0)
    drv.on_pose(0, np.eye(4))
    scan = np.random.uniform(1, 5, (200, 3)).astype(np.float32)
    drv.on_scan(1, scan)          # batch complete but the robot is still
    assert len(drv._queue) == 0
    assert drv.accu.count == 0    # cleared, not queued
    T = np.eye(4)
    T[0, 3] = 2.0                 # moved 2 m: the gate opens
    drv.on_pose(2, T)
    drv.on_scan(3, scan)
    assert len(drv._queue) == 1


def test_rotation_gate():
    drv = StreamingDriver(_small_app(), batch_size=1, max_range=100.0)
    drv.on_pose(0, np.eye(4))
    scan = np.random.uniform(1, 5, (100, 3)).astype(np.float32)
    drv.on_pose(1, _yaw(15.0))
    drv.on_scan(2, scan)
    assert len(drv._queue) == 1


def test_bounded_queue_drops_oldest():
    drv = StreamingDriver(_small_app(), batch_size=1, max_queue_size=2,
                          max_range=100.0)
    drv.on_pose(0, np.eye(4))
    scan = np.random.uniform(1, 5, (100, 3)).astype(np.float32)
    for i in range(4):
        T = np.eye(4)
        T[0, 3] = 2.0 * (i + 1)
        drv.on_pose(i, T)
        drv.on_scan(i, scan)
    assert len(drv._queue) == 2
    assert drv.n_dropped == 2
    assert [c.utime for c in drv._queue] == [2, 3]


@pytest.mark.parametrize("pipelined", [False, True])
def test_end_to_end_stream(pipelined):
    """The driver's loop over a synthetic drive: sensor-frame scans, poses,
    the worker registering clouds; the corrected-pose output tracks the
    ground truth. Frame 0 is gated (the robot has not moved since the first
    pose), and with batch_size=1 the clear-buffer handshake consumes the
    scan after every correction: frames 1 (bootstrap), 2 (correction),
    3 (cleared), 4 (correction). `flush` waits for the worker's frame, so
    the handshake sees each correction in time."""
    items, gt = synthetic_sequence(n_frames=5, n_points=4000, step=1.5,
                                   seed=2)
    app = _small_app(pipeline_depth=2)
    poses_out, results = [], []
    drv = StreamingDriver(
        app, batch_size=1, max_range=100.0, motion_gate_translation=0.5,
        pose_callback=lambda t, T: poses_out.append((t, T)),
        result_callback=results.append, pipelined=pipelined)
    drv.run()
    try:
        for utime, pts_odom, odom_pose in items:
            drv.on_pose(utime, odom_pose)
            local = (pts_odom - odom_pose[:3, 3]) @ odom_pose[:3, :3]
            drv.on_scan(utime, local.astype(np.float32))
            drv.flush()
    finally:
        drv.stop()
    assert [r.utime for r in results] == [1_000_000, 2_000_000, 4_000_000]
    assert drv.n_processed == 3
    assert all(np.isfinite(r.corrected_pose).all() for r in results)
    assert len(poses_out) == len(items)
    final = app.correct_pose(items[-1][2])
    assert np.linalg.norm(final[:3, 3] - gt[-1][:3, 3]) < 0.5


def test_clear_buffer_handshake():
    """After a correction the next scan clears the accumulation instead of
    mixing scans across odom estimates."""
    drv = StreamingDriver(_small_app(), batch_size=3, max_range=100.0)
    drv.on_pose(0, np.eye(4))
    scan = np.random.uniform(1, 5, (100, 3)).astype(np.float32)
    drv.on_scan(1, scan)
    assert drv.accu.count > 0
    with drv._state_mutex:
        drv._updated_correction = True
    drv.on_pose(2, np.eye(4))     # latches the clear
    drv.on_scan(3, scan)          # clears instead of accumulating
    assert drv.accu.count == 0


def test_worker_errors_are_raised(monkeypatch):
    """A frame that fails stops the worker, and flush raises."""
    app = _small_app()

    def broken(cloud):
        raise ValueError("broken frame")

    monkeypatch.setattr(app, "process_cloud", broken)
    drv = StreamingDriver(app, batch_size=1, max_range=100.0)
    drv.run()
    drv.on_pose(0, np.eye(4))
    T = np.eye(4)
    T[0, 3] = 2.0
    drv.on_pose(1, T)
    drv.on_scan(2, np.random.uniform(1, 5, (100, 3)).astype(np.float32))
    with pytest.raises(RuntimeError, match="worker failed"):
        drv.flush(timeout=30.0)
    drv.stop(drain=False)


def test_concurrent_stress_pose_scan_threads():
    """A pose thread at estimator rate, a scan thread at lidar rate and a
    control thread injecting corrections hammer the driver while the
    worker registers clouds (pipelined, async finalize): no exception
    escapes any thread, the queue bound holds, the accounting stays
    consistent and the driver shuts down clean."""
    items, _ = synthetic_sequence(n_frames=5, n_points=2500, step=1.5,
                                  seed=4)
    app = _small_app(pipeline_depth=2, async_finalize=True)
    errors, results = [], []
    drv = StreamingDriver(app, batch_size=1, max_range=100.0,
                          motion_gate_translation=0.1, max_queue_size=2,
                          result_callback=results.append, pipelined=True)
    drv.run()
    stop = threading.Event()

    def guard(fn):
        def wrapped():
            try:
                fn()
            except Exception as e:
                errors.append(e)
        return wrapped

    @guard
    def pose_thread():
        i = 0
        while not stop.is_set():
            utime, _, odom = items[i % len(items)]
            drv.on_pose(utime + i, odom)
            i += 1

    @guard
    def scan_thread():
        i = 0
        while not stop.is_set():
            utime, pts_odom, odom = items[i % len(items)]
            local = (pts_odom - odom[:3, 3]) @ odom[:3, :3]
            drv.on_scan(utime + i, local.astype(np.float32))
            i += 1

    @guard
    def control_thread():
        while not stop.is_set():
            app.inject_correction(np.eye(4, dtype=np.float32))
            with drv._data_mutex:
                assert len(drv._queue) <= drv.max_queue_size

    threads = [threading.Thread(target=t, daemon=True)
               for t in (pose_thread, scan_thread, control_thread)]
    for t in threads:
        t.start()
    time.sleep(3.0)
    stop.set()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    drv.stop()
    app.close()
    assert not errors, errors
    assert drv.n_processed == len(results) >= 1
    assert all(np.isfinite(r.corrected_pose).all() for r in results)


def _drive(drv_cls, app, items, pipelined):
    """Feed a driver the sensor-frame scans and poses of `items`, running
    the worker's step by hand after each scan (no thread), and return what
    its callbacks received."""
    poses, results = [], []
    drv = drv_cls(app, batch_size=2, max_range=40.0, min_range=0.5,
                  motion_gate_translation=0.5, pipelined=pipelined,
                  pose_callback=lambda t, T: poses.append((t, T)),
                  result_callback=results.append)
    for k, (utime, pts_odom, odom) in enumerate(items):
        for half in (0, 1):          # two scans per pose
            drv.on_pose(utime + half, odom)
            local = (pts_odom - odom[:3, 3]) @ odom[:3, :3]
            drv.on_scan(utime + half, local[half::2].astype(np.float32))
            while drv._queue:
                drv._process(drv._queue.popleft())
    if pipelined:
        for r in app.flush():
            drv._emit(r)
    return poses, results, drv


@pytest.mark.parametrize("pipelined", [False, True])
def test_driver_matches_jax(pipelined):
    """The same scans, poses and callbacks through JAX's driver over JAX's
    App and the port's over the port's: the same clouds accumulated, gated
    and registered, results within the golden tolerances, the published
    poses within 5 cm."""
    items, _ = jax_sequence(n_frames=5, n_points=4000, step=1.5, seed=2)
    jcfg_kw = dict(raw_capacity=8192, downsample_capacity=4096,
                   filtered_capacity=2048, min_cluster_size=20,
                   pipeline_depth=2)
    from aicp_mapping_tpu.pipeline.config import PipelineConfig as JConfig

    jcfg = JConfig(**jcfg_kw)
    want = _drive(JDriver, JApp(jcfg), items, pipelined)
    got = _drive(StreamingDriver, App(convert.config_from_dict(
        dataclasses.asdict(jcfg)), device="cpu"), items, pipelined)
    (gp, gr, gd), (wp, wr, wd) = got, want
    assert (gd.n_processed, gd.n_dropped) == (wd.n_processed, wd.n_dropped)
    assert [r.utime for r in gr] == [r.utime for r in wr]
    assert len(gr) >= 3
    for g, w in zip(gr, wr):
        assert (g.accepted, g.registered, g.reference_id) == \
            (w.accepted, w.registered, w.reference_id)
        assert abs(g.octree_overlap - w.octree_overlap) <= \
            TOLERANCES["octree_overlap"]
        np.testing.assert_allclose(g.correction[:3, 3], w.correction[:3, 3],
                                   atol=TOLERANCES["correction_t"])
    assert [t for t, _ in gp] == [t for t, _ in wp]
    for (_, a), (_, b) in zip(gp, wp):
        np.testing.assert_allclose(a, b, atol=TOLERANCES["corrected_t"])
