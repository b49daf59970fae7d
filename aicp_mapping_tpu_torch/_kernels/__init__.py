"""The port's hand-written CUDA kernels: build, loading and launch counts.

The sources in `csrc/` are CUDA C++ for Hopper (sm_90a) with a plain C
interface. At first use each is compiled by its own `nvcc`, all at once,
and the objects are linked into one shared library under
`build/aicp_torch_kernels/<source hash>/` at the root of the checkout,
loaded with `ctypes`; a changed source gets a new hash and so a new
build. Nothing here runs at import time, so the CPU-only test
machines import the package without `nvcc` or a card.

Every kernel wrapper (in `ops/knn.py`, `ops/normals.py`,
`ops/banded_nn.py` and `ops/segmentation.py`) adds one to its launch
count right after its kernel was launched, so a run can show that the
main path really went through the kernels. One exception: ICP's
iteration captured as a CUDA graph (`registration/icp.py`) holds a K1
launch, which `nn_payload_kernel` does not count under the capture
(nothing ran) and each replay counts once. K1 and K5 each have two modes,
with a wrapper and a count each: K1's `nn_payload` (the ICP matcher) and
`nn_argmin` (its index mode), K5's `banded_nn_payload_stream` and
`banded_nn_argmin`. Every C entry point of the scans launches a scan and
a merge pass (`csrc/common.cuh:merge_kernel` for K1 and K5,
`csrc/moments.cu:moments_merge_kernel` for K2 and K3); a wrapper counts
the pair as one launch of its kernel. Label propagation
(`csrc/propagation.cu`) is one launch, counted once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).with_name("csrc")
BUILD_ROOT = (Path(__file__).resolve().parents[2] / "build"
              / "aicp_torch_kernels")
LIB_NAME = "libaicp_torch_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

# One count per kernel, keyed by the name chip_smoke.py reports.
_launches = {"nn_payload": 0, "nn_argmin": 0, "banded_moments": 0,
             "radius_moments": 0, "banded_nn_payload_stream": 0,
             "banded_nn_argmin": 0, "label_propagation": 0}
_lib = None
_lock = threading.Lock()

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # q, qmask, m, r, rmask, n, payload, p, queries_per_thread, splits,
    # split_len, keys, dist_out, payload_out, stream
    "aicp_nn_payload": (_P, _P, _I, _P, _P, _I, _P, _I, _I, _I, _I, _P, _P,
                        _P, _P),
    # q, qmask, m, r, rmask, n, queries_per_thread, splits, split_len, keys,
    # dist_out, idx_out, stream
    "aicp_nn_argmin": (_P, _P, _I, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P),
    # ps, ms, n, codes, tile_m, tile_n, band, rad2, queries_per_thread,
    # splits, part, out, stream
    "aicp_banded_moments": (_P, _P, _I, _P, _I, _I, _I, _F, _I, _I, _P, _P,
                            _P),
    # ps, ms, n, rad2, queries_per_thread, splits, part, out, stream
    "aicp_radius_moments": (_P, _P, _I, _F, _I, _I, _P, _P, _P),
    # q, m, rs, rpen, n, payload, p, starts, tile_m, tile_n, band,
    # queries_per_thread, splits, split_len, keys, dist_out, payload_out,
    # stream
    "aicp_banded_nn_payload_stream": (_P, _I, _P, _P, _I, _P, _I, _P, _I, _I,
                                      _I, _I, _I, _I, _P, _P, _P, _P),
    # q, m, rs, rpen, n, starts, tile_m, tile_n, band, queries_per_thread,
    # splits, split_len, keys, dist_out, idx_out, stream
    "aicp_banded_nn_argmin": (_P, _I, _P, _P, _I, _P, _I, _I, _I, _I, _I, _I,
                              _P, _P, _P, _P),
    # idx, ld, k, pull_ok, mask, n, max_iters, jumps, mode, scratch, out,
    # rounds_total, stream
    "aicp_label_propagation": (_P, _I, _I, _P, _P, _I, _I, _I, _I, _P, _P, _P,
                               _P),
}


# Guards the counts: wrappers may launch from several threads (an App's
# dispatch and its finalizer).
_count_lock = threading.Lock()


def launch_counts() -> dict:
    with _count_lock:
        return dict(_launches)


def reset_launch_counts() -> None:
    with _count_lock:
        for k in _launches:
            _launches[k] = 0


def count_launch(name: str) -> None:
    with _count_lock:
        _launches[name] += 1


def sources() -> list:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME or put nvcc on PATH)")
    return nvcc


def _run(cmds: list) -> None:
    """Run the commands at once; raise with the output of any that fail."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in cmds]
    errors = []
    for cmd, proc in procs:
        output = proc.communicate()[0]
        if proc.returncode != 0:
            errors.append(" ".join(cmd) + "\n" + output)
    if errors:
        raise RuntimeError("kernel build failed:\n" + "\n".join(errors))


def build() -> Path:
    """Compile the kernels unless this source hash is already built: one
    `nvcc` per source, started together, then one link; returns the shared
    library's path. Safe across processes: each writes its own temporary
    files and renames the library into place."""
    out = BUILD_ROOT / source_hash() / LIB_NAME
    if out.exists():
        return out
    nvcc = _nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    tag = os.getpid()
    srcs = sorted(CSRC.glob("*.cu"))
    objs = [out.with_name(f"{s.stem}.{tag}.o") for s in srcs]
    _run([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)]
          for s, o in zip(srcs, objs)])
    tmp = out.with_name(f"{LIB_NAME}.{tag}.tmp")
    _run([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
           *[str(o) for o in objs]]])
    for o in objs:
        o.unlink()
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def check_status(status: int, name: str) -> None:
    """Raise on a refused launch (`cudaGetLastError` of the C entry point)."""
    if status != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch "
                           f"(cudaError {status})")


def check_tensors(name: str, *tensors) -> str:
    """Kernels take contiguous tensors on one device; returns that device's
    type, "cpu" (the plain twin runs) or "cuda" (the kernel launches).
    The checks run on the CPU too, so the CPU tests catch a caller that
    would hand the kernel a view."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {dev}")
    return dev.type
