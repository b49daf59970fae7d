"""Legacy VTK point and line IO, numpy port of `aicp_mapping_tpu.io.vtk`.

Reads and writes the POINTS section of legacy polydata files, ASCII or
binary. Binary VTK is big-endian by the legacy spec, whatever the host's
byte order; files are byte-for-byte the JAX package's.
"""
from __future__ import annotations

import numpy as np


def read_vtk(path: str) -> np.ndarray:
    """Read POINTS from a legacy .vtk polydata/unstructured-grid file."""
    with open(path, "rb") as f:
        header = f.readline()   # "# vtk DataFile Version x.x"
        if not header.startswith(b"# vtk"):
            raise IOError(f"not a legacy VTK file: {path}")
        f.readline()            # title
        fmt = f.readline().strip().upper()   # ASCII | BINARY
        while True:
            line = f.readline()
            if not line:
                raise IOError(f"no POINTS section in {path}")
            if line.upper().startswith(b"POINTS"):
                parts = line.split()
                n = int(parts[1])
                dtype = parts[2].decode().lower()
                break
        np_dtype = {"float": ">f4", "double": ">f8"}.get(dtype)
        if np_dtype is None:
            raise IOError(f"unsupported VTK point type {dtype!r}")
        if fmt == b"ASCII":
            vals: list[float] = []
            while len(vals) < 3 * n:
                vals.extend(float(t) for t in f.readline().split())
            pts = np.asarray(vals[:3 * n], np.float64).reshape(n, 3)
        else:  # BINARY: big-endian per the VTK legacy spec
            raw = f.read(n * 3 * int(np_dtype[2]))
            pts = np.frombuffer(raw, dtype=np_dtype, count=3 * n)
            pts = pts.astype(np.float64).reshape(n, 3)
    pts = pts.astype(np.float32)
    return pts[np.isfinite(pts).all(axis=1)]


def write_vtk(path: str, points: np.ndarray, binary: bool = False) -> None:
    pts = np.ascontiguousarray(points, np.float32).reshape(-1, 3)
    n = pts.shape[0]
    with open(path, "wb") as f:
        f.write(b"# vtk DataFile Version 3.0\n")
        f.write(b"aicp_mapping_tpu point cloud\n")
        f.write(b"BINARY\n" if binary else b"ASCII\n")
        f.write(b"DATASET POLYDATA\n")
        f.write(f"POINTS {n} float\n".encode())
        if binary:
            f.write(pts.astype(">f4").tobytes())
        else:
            for p in pts:
                f.write(f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n".encode())
        # vertices cell so viewers render the points
        f.write(f"\nVERTICES {n} {2 * n}\n".encode())
        if binary:
            cells = np.empty((n, 2), ">i4")
            cells[:, 0] = 1
            cells[:, 1] = np.arange(n)
            f.write(cells.tobytes())
        else:
            for i in range(n):
                f.write(f"1 {i}\n".encode())


def write_vtk_lines(path: str, segments: np.ndarray,
                    binary: bool = False) -> None:
    """Write (K, 2, 3) line segments as VTK POLYDATA LINES — the offline
    sink for utils.drawing geometry (octree wireframes, normal whiskers),
    viewable in ParaView; the reference pushed the same artifacts to the
    LCM collections viewer (drawingUtils.cpp)."""
    segs = np.ascontiguousarray(segments, np.float32).reshape(-1, 2, 3)
    k = segs.shape[0]
    pts = segs.reshape(-1, 3)
    with open(path, "wb") as f:
        f.write(b"# vtk DataFile Version 3.0\n")
        f.write(b"aicp_mapping_tpu line segments\n")
        f.write(b"BINARY\n" if binary else b"ASCII\n")
        f.write(b"DATASET POLYDATA\n")
        f.write(f"POINTS {2 * k} float\n".encode())
        if binary:
            f.write(pts.astype(">f4").tobytes())
        else:
            for p in pts:
                f.write(f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n".encode())
        f.write(f"\nLINES {k} {3 * k}\n".encode())
        if binary:
            cells = np.empty((k, 3), ">i4")
            cells[:, 0] = 2
            cells[:, 1] = 2 * np.arange(k)
            cells[:, 2] = 2 * np.arange(k) + 1
            f.write(cells.tobytes())
        else:
            for i in range(k):
                f.write(f"2 {2 * i} {2 * i + 1}\n".encode())
