#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `aicp_mapping_tpu_torch/_kernels/csrc`,
checks each kernel against its plain PyTorch twin on the card at the shapes
the main path gives it, drives the AICP frame path through
`App(config, device="cuda").process_cloud` at the benchmark's operating
point (65,536-point raw clouds -> 16,384 voxels -> 8,192 filtered points,
coarse-to-fine ICP) against the same App on the CPU, and replays the golden
scenario on the card against `tests/golden/pipeline_golden.json`. Every
phase asserts; the last line of standard output is
`{"ok": true, "device": {...}}` only when all of them passed. Imports
nothing of JAX. Exits non-zero without a result when CUDA is unavailable.
"""
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# Golden-file tolerances (tests/test_golden.py): overlap %, meters.
TOL_OVERLAP = 2.0
TOL_CORRECTION_T = 0.02
TOL_CORRECTED_T = 0.05

KERNELS = {
    "nn_payload": dict(
        source="aicp_mapping_tpu_torch/_kernels/csrc/nn_payload.cu",
        replaces="aicp_mapping_tpu/ops/knn.py:322"),
    "banded_moments": dict(
        source="aicp_mapping_tpu_torch/_kernels/csrc/moments.cu",
        replaces="aicp_mapping_tpu/ops/normals.py:221"),
    "radius_moments": dict(
        source="aicp_mapping_tpu_torch/_kernels/csrc/moments.cu",
        replaces="aicp_mapping_tpu/ops/normals.py:110"),
}


def log(*args):
    print(*args, flush=True)


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def time_ms(torch, fn, reps=20, warmup=3) -> float:
    """Mean device time of `fn` in ms, by CUDA events after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def lidar_room(n: int, seed: int) -> np.ndarray:
    """A 20 m synthetic room at lidar range: ~59 m from the origin."""
    from aicp_mapping_tpu_torch.tools.synthetic import room_cloud

    pts = room_cloud(n=n * 6 // 5 + 12, size=20.0, seed=seed, noise=0.01)[:n]
    return (pts + np.array([45.0, -38.0, 1.5], np.float32)).astype(np.float32)


def check_kernels(torch, results: dict) -> None:
    """Phase 3: each kernel against its plain twin on the card."""
    from aicp_mapping_tpu_torch.geometry import se3
    from aicp_mapping_tpu_torch.ops import banded_nn, knn, normals

    dev = "cuda"
    rng = np.random.default_rng(0)
    ref_np = lidar_room(8192, seed=1)
    ref = torch.as_tensor(ref_np, device=dev)
    rmask = torch.arange(8192, device=dev) < 8000
    payload = torch.cat([ref, torch.as_tensor(
        rng.normal(size=(8192, 5)).astype(np.float32), device=dev)],
        dim=1).contiguous()
    # queries: a second scan of the room, slightly moved (an ICP iterate)
    T = se3.se3_exp(torch.tensor([0.05, -0.03, 0.01, 0.0, 0.0, 0.01],
                                 device=dev))
    scan = torch.as_tensor(lidar_room(8192, seed=2), device=dev)
    for M in (8192, 1024):
        q = se3.transform_points(T, scan[:: 8192 // M]).contiguous()
        qm = torch.arange(M, device=dev) < M - M // 32
        args = (q, qm, ref, rmask, payload)
        d_k, p_k = knn.nn_payload_kernel(*args)
        d_p, p_p = knn.nn_payload(*args)
        torch.cuda.synchronize()
        same = (p_k == p_p).all(1)
        frac = same[qm].float().mean().item()
        err = (d_k - d_p)[qm].abs().max().item()
        log(f"K1 nn_payload M={M} N=8192: identical payload rows {frac:.5f}"
            f", max|dd2| {err:.3g} m^2")
        assert frac >= 0.997, frac
        assert err <= 3e-3, err
        assert bool(same[~qm].all()) and bool((d_k[~qm] == 3.4e38).all())
        ms = time_ms(torch, lambda: knn.nn_payload_kernel(*args))
        plain = time_ms(torch, lambda: knn.nn_payload(*args))
        log(f"K1 nn_payload M={M} N=8192: kernel {ms * 1e3:.1f} us, "
            f"plain {plain * 1e3:.1f} us")
        r = results.setdefault("nn_payload", dict(max_abs_err=0.0))
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if M == 8192:
            r.update(ms=ms, plain_ms=plain)

    def moments_check(name, a, b):
        diff = (a[:, 9] - b[:, 9]).abs()
        frac = (diff <= 2).float().mean().item()
        agree = diff == 0
        torch.testing.assert_close(a[agree], b[agree], rtol=1e-4, atol=1e-3)
        err = (a[agree] - b[agree]).abs().max().item()
        log(f"{name}: counts within 2 for {frac:.5f}, moments max|d| "
            f"{err:.3g} where counts agree ({agree.float().mean().item():.5f}"
            f"), mean count {b[:, 9].mean().item():.1f}")
        assert frac >= 0.99, frac
        return err

    # K2 at the main path's 16,384 points, Morton-sorted as the prefilter
    # sorts them
    N = 16384
    p = torch.as_tensor(lidar_room(N, seed=3), device=dev)
    m = torch.arange(N, device=dev) < N - 384
    codes = banded_nn.morton_codes(p, m, p[m].amin(0), 2.0)
    codes_s, perm = torch.sort(codes, stable=True)
    ps = p[perm].contiguous()
    ms = codes_s != banded_nn.SENTINEL
    args = (ps, ms, codes_s, 0.4)
    err = moments_check(
        f"K2 banded_moments N={N}",
        normals.sorted_radius_moments_kernel(*args),
        normals.sorted_radius_moments(*args))
    ms_k = time_ms(torch, lambda: normals.sorted_radius_moments_kernel(*args))
    plain = time_ms(torch, lambda: normals.sorted_radius_moments(*args))
    log(f"K2 banded_moments N={N}: kernel {ms_k * 1e3:.1f} us, "
        f"plain {plain * 1e3:.1f} us")
    results["banded_moments"] = dict(max_abs_err=err, ms=ms_k,
                                     plain_ms=plain)

    # K3 at the golden scenario's 4,096 and at 8,192 points
    r = results.setdefault("radius_moments", dict(max_abs_err=0.0))
    for N in (4096, 8192):
        p = torch.as_tensor(lidar_room(N, seed=4), device=dev)
        m = torch.arange(N, device=dev) < N - N // 16
        args = (p, m, 0.4)
        err = moments_check(f"K3 radius_moments N={N}",
                            normals.radius_moments_kernel(*args),
                            normals.radius_moments(*args))
        ms_k = time_ms(torch, lambda: normals.radius_moments_kernel(*args))
        plain = time_ms(torch, lambda: normals.radius_moments(*args))
        log(f"K3 radius_moments N={N}: kernel {ms_k * 1e3:.1f} us, "
            f"plain {plain * 1e3:.1f} us")
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if N == 4096:
            r.update(ms=ms_k, plain_ms=plain)


def frame_lines_agree(got, want, what: str) -> None:
    """The golden comparison (tests/test_golden.py::_compare) of one frame."""
    assert got.accepted == want["accepted"], (what, got, want)
    assert got.registered == want["registered"], (what, got, want)
    assert abs(got.filtered_size - want["filtered_size"]) <= max(
        0.02 * want["filtered_size"], 8), (what, got, want)
    if want["octree_overlap"] < 0:
        assert got.octree_overlap < 0, (what, got, want)
    else:
        assert abs(got.octree_overlap - want["octree_overlap"]) \
            <= TOL_OVERLAP, (what, got.octree_overlap, want)
    np.testing.assert_allclose(np.asarray(got.correction)[:3, 3],
                               want["correction_t"], atol=TOL_CORRECTION_T,
                               err_msg=what)
    np.testing.assert_allclose(np.asarray(got.corrected_pose)[:3, 3],
                               want["corrected_t"], atol=TOL_CORRECTED_T,
                               err_msg=what)


def as_line(r) -> dict:
    return dict(accepted=r.accepted, registered=r.registered,
                filtered_size=r.filtered_size,
                octree_overlap=r.octree_overlap,
                correction_t=np.asarray(r.correction)[:3, 3].tolist(),
                corrected_t=np.asarray(r.corrected_pose)[:3, 3].tolist())


def run_bench_slice(torch) -> None:
    """Phase 4: the frame path at the benchmark's operating point on the
    card, each frame checked against the CPU App started from the card
    App's state."""
    from aicp_mapping_tpu_torch import (AlignedCloud, App, Cloud,
                                        PipelineConfig)
    from aicp_mapping_tpu_torch.convert import (app_state_from_numpy,
                                                app_state_to_numpy)
    from aicp_mapping_tpu_torch.pipeline.sequence import synthetic_sequence

    cfg = PipelineConfig(raw_capacity=65536, downsample_capacity=16384,
                         filtered_capacity=8192, quantized_upload=False,
                         wire_voxel=0.0)
    cfg.icp = dataclasses.replace(cfg.icp, coarse_iterations=6,
                                  coarse_decimation=8)
    items, _ = synthetic_sequence(n_frames=6, n_points=60000, step=1.2,
                                  seed=0, world_size=60.0,
                                  sensor_range=40.0, noise=0.02)
    gpu, cpu = App(cfg, device="cuda"), App(cfg, device="cpu")
    gpu_ms, cpu_s = [], []
    for i, (utime, pts, pose) in enumerate(items):
        if i > 0:
            app_state_from_numpy(cpu, **app_state_to_numpy(gpu))
        cloud = Cloud.from_numpy(pts, capacity=cfg.raw_capacity)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rg = gpu.process_cloud(AlignedCloud.create(utime, cloud, pose))
        torch.cuda.synchronize()
        gpu_ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        rc = cpu.process_cloud(AlignedCloud.create(utime, cloud, pose))
        cpu_s.append(time.perf_counter() - t0)
        log(f"bench frame {i}: card {gpu_ms[-1]:.1f} ms, overlap "
            f"{rg.octree_overlap:.3f} (cpu {rc.octree_overlap:.3f}), iters "
            f"{rg.n_iterations} (cpu {rc.n_iterations}), filtered "
            f"{rg.filtered_size} (cpu {rc.filtered_size}), correction_t "
            f"{np.round(rg.correction[:3, 3], 4).tolist()} (cpu "
            f"{np.round(rc.correction[:3, 3], 4).tolist()})")
        assert rg.reference_id == rc.reference_id, (i, rg, rc)
        frame_lines_agree(rg, as_line(rc), f"bench frame {i}")
        assert all(r.registered for r in gpu.frames[1:]), gpu.frames
    steady = gpu_ms[2:]
    log(f"bench slice on the card: {np.mean(steady):.2f} ms/frame "
        f"(mean of frames 2-{len(gpu_ms) - 1}, after the bootstrap and one "
        f"warm-up frame; min {min(steady):.2f}, max {max(steady):.2f}); "
        f"CPU App {np.mean(cpu_s[2:]):.2f} s/frame")


def run_golden(torch) -> None:
    """Phase 5: the golden scenario (tests/test_golden.py::_run_pipeline)
    on the card against the golden file."""
    from aicp_mapping_tpu_torch import (AlignedCloud, App, Cloud,
                                        PipelineConfig)
    from aicp_mapping_tpu_torch.pipeline.sequence import synthetic_sequence

    with open(os.path.join(ROOT, "tests", "golden",
                           "pipeline_golden.json")) as f:
        golden = json.load(f)["frames"]
    cfg = PipelineConfig(raw_capacity=8192, downsample_capacity=4096,
                         filtered_capacity=2048, min_cluster_size=20,
                         failure_prediction_mode=False)
    app = App(cfg, device="cuda")
    items, _ = synthetic_sequence(n_frames=8, n_points=5000, seed=11)
    assert len(items) == len(golden)
    for i, ((utime, pts, pose), want) in enumerate(zip(items, golden)):
        r = app.process_cloud(AlignedCloud.create(
            utime, Cloud.from_numpy(pts, capacity=cfg.raw_capacity), pose))
        assert r.reading_id == want["reading_id"], (i, r)
        assert r.reference_id == want["reference_id"], (i, r)
        frame_lines_agree(r, want, f"golden frame {i}")
    log(f"golden scenario on the card: {len(golden)} frames match "
        "tests/golden/pipeline_golden.json")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from aicp_mapping_tpu_torch import _kernels

    # 1. device
    smi = gpu_line()
    log(f"device: {torch.cuda.get_device_name(0)} (torch {torch.__version__},"
        f" CUDA {torch.version.cuda}); nvidia-smi: {smi}")

    # 2. build
    t0 = time.perf_counter()
    _kernels.library()
    log(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s "
        f"({_kernels.source_hash()})")

    # 3. each kernel against its plain twin
    results: dict = {}
    check_kernels(torch, results)

    # 4-5. the main path, counting launches
    _kernels.reset_launch_counts()
    run_bench_slice(torch)
    run_golden(torch)
    counts = _kernels.launch_counts()

    # 6. the main path went through every kernel
    log(f"launches on the main path: {counts}")
    assert all(counts[k] > 0 for k in KERNELS), counts

    kernels = [dict(name=name, route="cuda", **KERNELS[name],
                    launches=counts[name], **results[name])
               for name in KERNELS]
    print(json.dumps({"kernels": kernels}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
