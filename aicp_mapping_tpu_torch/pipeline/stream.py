"""Online streaming driver, PyTorch port of
`aicp_mapping_tpu.pipeline.stream`: the middleware layer of the reference's
`AppROS` without the middleware — scan callback -> accumulator -> motion
gate -> bounded work queue -> worker thread -> App, with plain Python
callbacks in place of ROS publishers.

Kept from the reference:
  - corrected poses are published at the state estimator's rate by
    composing the live odometry with the latest total correction, so
    registration latency never blocks pose output;
  - scans are accumulated in the odom frame with a range crop
    (`native.ScanAccumulator`) and gated on robot motion (> 1 m or
    > 10 deg on any axis);
  - the work queue is bounded; the oldest clouds are dropped on overflow;
  - after a fresh correction the accumulation in progress is discarded, so
    a cloud never mixes scans expressed in two odom estimates (the
    clear-buffer handshake).
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Callable, Optional

import numpy as np

from ..cloud import AlignedCloud
from ..native import ScanAccumulator
from .app import App, FrameResult
from .sequence import wire_cloud


def _rpy(R: np.ndarray) -> np.ndarray:
    """ZYX roll/pitch/yaw from a rotation matrix, in numpy for the host-side
    motion gate."""
    sy = -R[2, 0]
    pitch = np.arcsin(np.clip(sy, -1.0, 1.0))
    roll = np.arctan2(R[2, 1], R[2, 2])
    yaw = np.arctan2(R[1, 0], R[0, 0])
    return np.array([roll, pitch, yaw])


class StreamingDriver:
    def __init__(
        self,
        app: App,
        batch_size: int = 10,
        min_range: float = 0.5,
        max_range: float = 30.0,
        accumulator_capacity: int = 262144,
        max_queue_size: int = 3,
        motion_gate_translation: float = 1.0,
        motion_gate_rotation_deg: float = 10.0,
        pose_callback: Optional[Callable[[int, np.ndarray], None]] = None,
        result_callback: Optional[Callable[[FrameResult], None]] = None,
        recorder=None,
        pipelined: bool = False,
    ):
        """pipelined=True: the worker drives App.submit_cloud while the
        queue holds clouds and flushes the frames in flight when it
        drains; corrections then land up to the App's pipeline_depth
        frames later."""
        self.app = app
        self.pipelined = pipelined
        self.accu = ScanAccumulator(capacity=accumulator_capacity,
                                    batch_size=batch_size,
                                    min_range=min_range, max_range=max_range)
        self.max_queue_size = max_queue_size
        self.gate_t = motion_gate_translation
        self.gate_r = np.deg2rad(motion_gate_rotation_deg)
        self.pose_callback = pose_callback
        self.result_callback = result_callback
        self.recorder = recorder

        self._queue: collections.deque[AlignedCloud] = collections.deque()
        self._data_mutex = threading.Lock()
        self._state_mutex = threading.Lock()
        self._worker_cv = threading.Condition()
        self._stop = False
        self._worker: Optional[threading.Thread] = None
        self._worker_error: Optional[Exception] = None
        self._busy = False      # the worker holds a cloud it took

        self.pose_initialized = False
        self.world_to_body = np.eye(4, dtype=np.float32)
        self.world_to_body_previous = np.eye(4, dtype=np.float32)
        self._clear_clouds_buffer = False
        self._updated_correction = False
        self.n_dropped = 0
        self.n_processed = 0

    # ------------------------------------------------------------- inputs

    def on_pose(self, utime: int, world_to_body: np.ndarray) -> np.ndarray:
        """State-estimator pose input. Returns (and publishes) the corrected
        pose = total_correction * world_to_body."""
        with self._state_mutex:
            self.world_to_body = np.asarray(world_to_body, np.float32)
            if not self.pose_initialized:
                self.world_to_body_previous = self.world_to_body
                self.pose_initialized = True
            corrected = self.app.correct_pose(self.world_to_body)
            if self._updated_correction:
                self._clear_clouds_buffer = True
                self._updated_correction = False
        if self.pose_callback is not None:
            self.pose_callback(utime, corrected)
        return corrected

    def on_scan(self, utime: int, points: np.ndarray,
                T_sensor_to_odom: Optional[np.ndarray] = None) -> None:
        """Lidar scan input in the sensor frame. T_sensor_to_odom defaults to
        the latest odometry pose."""
        if not self.pose_initialized:
            return  # waiting for the pose prior

        with self._state_mutex:
            clear = self._clear_clouds_buffer
            self._clear_clouds_buffer = False
            wtb = self.world_to_body.copy()
        if clear:
            self.accu.clear()
        else:
            T = wtb if T_sensor_to_odom is None else \
                np.asarray(T_sensor_to_odom, np.float32)
            self.accu.push(points, T)

        if not self.accu.finished:
            return

        # motion gate between accumulated clouds
        rel = np.linalg.inv(self.world_to_body_previous) @ wtb
        dist = float(np.linalg.norm(rel[:3, 3]))
        rpy = np.abs(_rpy(rel[:3, :3]))
        if dist > self.gate_t or np.any(rpy > self.gate_r):
            accumulated = self.accu.take()
            cloud = wire_cloud(self.app.cfg, accumulated,
                               device=self.app.device)
            current = AlignedCloud.create(utime, cloud, wtb)
            self.world_to_body_previous = wtb
            if self.recorder is not None:
                self.recorder.record(utime, accumulated, wtb)
            with self._data_mutex:
                self._queue.append(current)
                while len(self._queue) > self.max_queue_size:
                    self._queue.popleft()   # drop the oldest
                    self.n_dropped += 1
        else:
            self.accu.clear()

        with self._worker_cv:
            self._worker_cv.notify()

    # ------------------------------------------------------------- worker

    def run(self) -> None:
        """Spawn the worker thread."""
        self._stop = False
        self._worker = threading.Thread(target=self._worker_loop,
                                        name="aicp-worker", daemon=True)
        self._worker.start()

    def stop(self, drain: bool = True) -> None:
        """Stop the worker (after draining the queue); raises the worker's
        error if it failed."""
        try:
            if drain:
                self.flush()
        finally:
            self._stop = True
            with self._worker_cv:
                self._worker_cv.notify_all()
            if self._worker is not None:
                self._worker.join()
                self._worker = None
        self._raise_worker_error()

    def flush(self, timeout: float = 60.0) -> None:
        """Block until the queue is drained and the worker has finished the
        cloud it took (for deterministic tests; the JAX driver waits for
        the queue only); raises the worker's error if it failed."""
        deadline = time.time() + timeout
        while time.time() < deadline and self._worker_error is None:
            with self._data_mutex:
                if not self._queue and not self._busy:
                    break
            time.sleep(0.01)
        self._raise_worker_error()

    def _raise_worker_error(self) -> None:
        if self._worker_error is not None:
            err, self._worker_error = self._worker_error, None
            raise RuntimeError("the streaming worker failed") from err

    def _worker_loop(self) -> None:
        try:
            self._drain_loop()
        except Exception as e:     # raised by the next flush / stop
            self._worker_error = e

    def _drain_loop(self) -> None:
        # wait up to 1 s, then drain the queue
        while not self._stop:
            with self._worker_cv:
                self._worker_cv.wait(timeout=1.0)
            while True:
                with self._data_mutex:
                    if not self._queue:
                        break
                    cloud = self._queue.popleft()
                    self._busy = True
                try:
                    self._process(cloud)
                    with self._data_mutex:
                        drained = not self._queue
                    if self.pipelined and drained:
                        # queue drained: finalize the frames in flight
                        for r in self.app.flush():
                            self._emit(r)
                finally:
                    with self._data_mutex:
                        self._busy = False

    def _process(self, cloud: AlignedCloud) -> None:
        if self.pipelined:
            for r in self.app.submit_cloud(cloud):
                self._emit(r)
        else:
            self._emit(self.app.process_cloud(cloud))

    def _emit(self, result: Optional[FrameResult]) -> None:
        if result is None:
            return
        self.n_processed += 1
        if result.accepted and not np.allclose(result.correction, np.eye(4),
                                               atol=1e-9):
            with self._state_mutex:
                self._updated_correction = True
        if self.result_callback is not None:
            self.result_callback(result)
