"""PCD point-cloud file IO (ASCII, binary and LZF binary_compressed),
numpy-based: a copy of `aicp_mapping_tpu.io.pcd` (the sensor pose rides in
the VIEWPOINT header), plus `read_cloud` for .pcd and .bin files.
"""
from __future__ import annotations

import os

import numpy as np

_DTYPE_MAP = {
    ("F", 4): np.float32, ("F", 8): np.float64,
    ("I", 1): np.int8, ("I", 2): np.int16, ("I", 4): np.int32,
    ("U", 1): np.uint8, ("U", 2): np.uint16, ("U", 4): np.uint32,
}


def lzf_decompress(data: bytes, expected_size: int) -> bytes:
    """Decompress a liblzf stream (PCL `binary_compressed` payload format:
    ctrl < 0x20 = literal run of ctrl+1 bytes; otherwise a back-reference of
    (ctrl >> 5) + 2 bytes — +ext byte when ctrl >> 5 == 7 — at offset
    ((ctrl & 0x1f) << 8 | next) + 1, copies may overlap)."""
    out = bytearray(expected_size)
    i, o, n = 0, 0, len(data)
    while i < n:
        ctrl = data[i]
        i += 1
        if ctrl < 0x20:
            run = ctrl + 1
            if i + run > n or o + run > expected_size:
                raise ValueError("corrupt LZF stream (literal run)")
            out[o:o + run] = data[i:i + run]
            i += run
            o += run
        else:
            length = ctrl >> 5
            if length == 7:
                length += data[i]
                i += 1
            length += 2
            ref = o - (((ctrl & 0x1f) << 8) | data[i]) - 1
            i += 1
            if ref < 0 or o + length > expected_size:
                raise ValueError("corrupt LZF stream (back-reference)")
            if ref + length <= o:
                out[o:o + length] = out[ref:ref + length]
            else:  # overlapping copy: byte-wise
                for k in range(length):
                    out[o + k] = out[ref + k]
            o += length
    if o != expected_size:
        raise ValueError(f"LZF stream ended at {o}, expected {expected_size}")
    return bytes(out)


def lzf_compress(data: bytes) -> bytes:
    """Compress to a liblzf-format stream (see lzf_decompress). Greedy
    hash-table matcher; output is valid for any liblzf/PCL decoder."""
    n = len(data)
    out = bytearray()
    htab = {}
    i = 0
    lit_start = 0

    def flush(end):
        k = lit_start
        while k < end:
            run = min(32, end - k)
            out.append(run - 1)
            out.extend(data[k:k + run])
            k += run

    while i + 2 < n:
        key = data[i:i + 3]
        cand = htab.get(key, -1)
        htab[key] = i
        off = i - cand - 1
        if cand >= 0 and off <= 0x1FFF:
            max_len = min(n - i, 264)
            length = 3
            while length < max_len and data[cand + length] == data[i + length]:
                length += 1
            flush(i)
            lit_start = None
            l = length - 2
            if l < 7:
                out.append((l << 5) | (off >> 8))
            else:
                out.append((7 << 5) | (off >> 8))
                out.append(l - 7)
            out.append(off & 0xFF)
            i += length
            lit_start = i
        else:
            i += 1
    flush(n)
    return bytes(out)


def read_pcd(path: str):
    """Returns (points (N, 3) float32, viewpoint (tx,ty,tz,qw,qx,qy,qz))."""
    with open(path, "rb") as f:
        header = {}
        while True:
            raw_line = f.readline()
            if not raw_line:
                raise IOError(f"{path}: no DATA line in the PCD header")
            line = raw_line.decode("ascii", errors="replace").strip()
            if not line or line.startswith("#"):
                continue
            key, _, value = line.partition(" ")
            header[key.upper()] = value
            if key.upper() == "DATA":
                break
        fields = header["FIELDS"].split()
        sizes = [int(s) for s in header["SIZE"].split()]
        types = header["TYPE"].split()
        counts = [int(c) for c in header.get(
            "COUNT", " ".join(["1"] * len(fields))).split()]
        n = int(header["POINTS"])
        viewpoint = np.array(
            [float(v) for v in header.get(
                "VIEWPOINT", "0 0 0 1 0 0 0").split()], dtype=np.float64)

        data_mode = header["DATA"].split()[0]
        np_fields = []
        for name, size, typ, cnt in zip(fields, sizes, types, counts):
            base = _DTYPE_MAP[(typ, size)]
            np_fields.append((name, base, (cnt,)) if cnt > 1 else (name, base))
        dtype = np.dtype(np_fields)

        if data_mode == "ascii":
            raw = np.loadtxt(f, dtype=np.float64, max_rows=n)
            raw = np.atleast_2d(raw)
            cols = {}
            c = 0
            for name, _, cnt in [(fl, sz, ct) for fl, sz, ct in
                                 zip(fields, sizes, counts)]:
                cols[name] = raw[:, c]
                c += cnt
            pts = np.stack([cols["x"], cols["y"], cols["z"]], axis=1)
        elif data_mode == "binary":
            buf = f.read(dtype.itemsize * n)
            arr = np.frombuffer(buf, dtype=dtype, count=n)
            pts = np.stack([arr["x"], arr["y"], arr["z"]], axis=1)
        elif data_mode == "binary_compressed":
            # PCL layout: u32 compressed_size, u32 uncompressed_size, LZF
            # payload; decompressed data is field-by-field (SoA): all of
            # field 0 for every point, then field 1, ...
            csize, usize = np.frombuffer(f.read(8), dtype=np.uint32)
            raw = lzf_decompress(f.read(int(csize)), int(usize))
            cols = {}
            off = 0
            for name, size, typ, cnt in zip(fields, sizes, types, counts):
                base = np.dtype(_DTYPE_MAP[(typ, size)])
                block = size * cnt * n
                if name in ("x", "y", "z"):
                    arr = np.frombuffer(raw, dtype=base, count=n * cnt,
                                        offset=off)
                    cols[name] = arr.reshape(n, cnt)[:, 0] if cnt > 1 else arr
                off += block
            pts = np.stack([cols["x"], cols["y"], cols["z"]], axis=1)
        else:
            raise ValueError(f"unknown PCD DATA mode {data_mode!r}")

    pts = np.ascontiguousarray(pts, dtype=np.float32)
    finite = np.isfinite(pts).all(axis=1)
    return pts[finite], viewpoint


def write_pcd(path: str, points: np.ndarray,
              viewpoint=(0, 0, 0, 1, 0, 0, 0),
              binary: bool | str = True) -> None:
    """binary: False = ascii, True = binary, "compressed" =
    binary_compressed (LZF, the PCL default for many pipelines)."""
    points = np.ascontiguousarray(points, dtype=np.float32).reshape(-1, 3)
    n = points.shape[0]
    vp = " ".join(f"{float(v):g}" for v in viewpoint)
    mode = ("binary_compressed" if binary == "compressed"
            else ("binary" if binary else "ascii"))
    header = (
        "# .PCD v0.7 - Point Cloud Data file format\n"
        "VERSION 0.7\n"
        "FIELDS x y z\n"
        "SIZE 4 4 4\n"
        "TYPE F F F\n"
        "COUNT 1 1 1\n"
        f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT {vp}\nPOINTS {n}\n"
        f"DATA {mode}\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        if binary == "compressed":
            soa = np.ascontiguousarray(points.T).tobytes()  # SoA: x* y* z*
            comp = lzf_compress(soa)
            f.write(np.asarray([len(comp), len(soa)],
                               np.uint32).tobytes())
            f.write(comp)
        elif binary:
            f.write(points.tobytes())
        else:
            np.savetxt(f, points, fmt="%.6f")


def viewpoint_to_pose(viewpoint: np.ndarray) -> np.ndarray:
    """PCD VIEWPOINT (tx ty tz qw qx qy qz) -> 4x4 pose (float32)."""
    import torch

    from ..geometry import se3

    vp = np.asarray(viewpoint, np.float32)
    return se3.from_quat_trans(torch.as_tensor(vp[3:7]),
                               torch.as_tensor(vp[:3])).numpy()


def read_cloud(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Read a .pcd or a KITTI .bin (x y z intensity f32 rows) cloud:
    (points (N, 3) float32, viewpoint (7,) float64), non-finite points
    dropped. The JAX package's pure-Python reader; its C++ runtime is not
    ported."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".pcd":
        return read_pcd(path)
    if ext == ".bin":
        pts = np.fromfile(path, dtype=np.float32).reshape(-1, 4)[:, :3]
        return (pts[np.isfinite(pts).all(axis=1)],
                np.array([0, 0, 0, 1, 0, 0, 0], np.float64))
    raise IOError(f"no reader for {ext!r}")
