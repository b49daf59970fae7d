"""Live streaming visualizer, port of `aicp_mapping_tpu.utils.live_viz`.

A `LiveVisualizer` binds a TCP port and streams every publish to any
number of connected viewers as length-prefixed frames, byte for byte the
JAX package's, so that either package's viewer reads either publisher:

    b"AICP"            4-byte magic
    uint32 (LE)        header length H
    H bytes            compact JSON header: {"type", "utime",
                       "name"/"channel", "dtype", "shape"} (+ fields of
                       the type)
    payload            raw little-endian array bytes (C order), or empty

Frame types follow the Visualizer hooks: cloud, map, pose, prior_pose,
odom_pose, odom_to_map, metric, lines. Clouds are float32 (N, 3), poses
float32 (4, 4), lines float32 (K, 2, 3); a metric carries its value in
the header. `read_frames` is the reference client.

Publishers never block: each client has a bounded queue that drops its
oldest frame on overflow, a writer thread per client does the socket IO,
and clouds, maps and lines over `max_points` rows are decimated by an
even stride. `close()` stops and joins every thread it started.
"""
from __future__ import annotations

import collections
import json
import socket
import struct
import threading
from typing import Iterator, Optional

import numpy as np

from .visualizer import Visualizer

_MAGIC = b"AICP"
_JOIN_S = 2.0


def _encode(header: dict, payload: bytes = b"") -> bytes:
    h = json.dumps(header, separators=(",", ":")).encode()
    return _MAGIC + struct.pack("<I", len(h)) + h + payload


def read_frames(sock: socket.socket) -> Iterator[tuple[dict, np.ndarray]]:
    """Yield (header, array) frames from a connected socket until it
    closes; the array is empty for a header-only frame."""
    buf = b""

    def need(n: int) -> Optional[bytes]:
        nonlocal buf
        while len(buf) < n:
            try:
                chunk = sock.recv(65536)
            except OSError:
                return None     # the socket was closed under the reader
            if not chunk:
                return None
            buf += chunk
        out, buf = buf[:n], buf[n:]
        return out

    while True:
        head = need(8)
        if head is None:
            return
        if head[:4] != _MAGIC:
            raise ValueError(f"not an AICP frame: {head!r}")
        (hlen,) = struct.unpack("<I", head[4:])
        hraw = need(hlen)
        if hraw is None:
            return
        header = json.loads(hraw)
        shape = header.get("shape", [])
        dtype = np.dtype(header.get("dtype", "float32"))
        nbytes = int(np.prod(shape)) * dtype.itemsize if shape else 0
        payload = need(nbytes) if nbytes else b""
        if nbytes and payload is None:
            return
        arr = (np.frombuffer(payload, dtype).reshape(shape)
               if nbytes else np.empty((0,), dtype))
        yield header, arr


class LiveVisualizer(Visualizer):
    """Streams every publish_* call to the connected TCP viewers."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 max_queue: int = 32, max_points: int = 200_000):
        self.max_queue = max_queue
        self.max_points = max_points
        self._clients: list[dict] = []
        self._lock = threading.Lock()
        self._path: list[np.ndarray] = [np.eye(4, dtype=np.float32)]
        self.n_dropped = 0

        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(8)
        self.address = self._srv.getsockname()
        self._stop = False
        self._acceptor = threading.Thread(target=self._accept_loop,
                                          name="aicp-viz-accept", daemon=True)
        self._acceptor.start()

    # ----------------------------------------------------------- transport
    def _accept_loop(self) -> None:
        while not self._stop:
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            client = {"sock": conn, "queue": collections.deque(),
                      "cv": threading.Condition(), "alive": True}
            client["thread"] = threading.Thread(
                target=self._writer_loop, args=(client,), daemon=True,
                name="aicp-viz-writer")
            with self._lock:
                if self._stop:
                    conn.close()
                    return
                self._clients.append(client)
            client["thread"].start()

    def _writer_loop(self, client: dict) -> None:
        while client["alive"] and not self._stop:
            with client["cv"]:
                while (not client["queue"] and client["alive"]
                       and not self._stop):
                    client["cv"].wait(timeout=0.5)
                if not client["queue"]:
                    continue
                frame = client["queue"].popleft()
            try:
                client["sock"].sendall(frame)
            except OSError:
                client["alive"] = False
        try:
            client["sock"].close()
        except OSError:
            pass
        with self._lock:
            if client in self._clients:
                self._clients.remove(client)

    def _broadcast(self, frame: bytes) -> None:
        with self._lock:
            clients = list(self._clients)
        for c in clients:
            with c["cv"]:
                c["queue"].append(frame)
                while len(c["queue"]) > self.max_queue:
                    c["queue"].popleft()   # drop the oldest, never block
                    self.n_dropped += 1
                c["cv"].notify()

    def close(self) -> None:
        """Stop accepting, drop what is queued, and join every thread: a
        writer blocked on a slow viewer is released by shutting its
        socket down."""
        with self._lock:
            self._stop = True
            clients = list(self._clients)
        for sock in [self._srv] + [c["sock"] for c in clients]:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        try:
            self._srv.close()
        except OSError:
            pass
        for c in clients:
            c["alive"] = False
            with c["cv"]:
                c["cv"].notify_all()
        self._acceptor.join(timeout=_JOIN_S)
        for c in clients:
            c["thread"].join(timeout=_JOIN_S)

    # ----------------------------------------------------------- sink API
    def _send_array(self, ftype: str, arr: np.ndarray, **fields) -> None:
        arr = np.ascontiguousarray(np.asarray(arr, np.float32))
        header = {"type": ftype, "dtype": "float32",
                  "shape": list(arr.shape), **fields}
        self._broadcast(_encode(header, arr.tobytes()))

    def _decimated(self, rows: np.ndarray) -> np.ndarray:
        if len(rows) > self.max_points:
            rows = rows[:: len(rows) // self.max_points + 1]
        return rows

    def publish_cloud(self, points, channel, name, utime) -> None:
        pts = self._decimated(np.asarray(points, np.float32).reshape(-1, 3))
        self._send_array("cloud", pts, channel=channel, name=name,
                         utime=int(utime))

    def publish_map(self, points, utime, channel) -> None:
        pts = self._decimated(np.asarray(points, np.float32).reshape(-1, 3))
        self._send_array("map", pts, channel=channel, utime=int(utime))

    def publish_pose(self, pose, channel, name, utime) -> None:
        self._path.append(np.asarray(pose, np.float32))
        self._send_array("pose", pose, channel=channel, name=name,
                         utime=int(utime))

    def publish_prior_pose(self, pose, channel, name, utime) -> None:
        self._send_array("prior_pose", pose, channel=channel, name=name,
                         utime=int(utime))

    def publish_odom_pose(self, pose, channel, name, utime) -> None:
        self._send_array("odom_pose", pose, channel=channel, name=name,
                         utime=int(utime))

    def publish_odom_to_map(self, pose, utime) -> None:
        self._send_array("odom_to_map", pose, utime=int(utime))

    def publish_metric(self, name, value, utime) -> None:
        self._broadcast(_encode({"type": "metric", "name": name,
                                 "value": float(value),
                                 "utime": int(utime)}))

    def publish_lines(self, segments, name, utime) -> None:
        segs = self._decimated(
            np.asarray(segments, np.float32).reshape(-1, 2, 3))
        self._send_array("lines", segs, name=name, utime=int(utime))

    def get_path(self) -> list[np.ndarray]:
        return self._path
