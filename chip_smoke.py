#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `aicp_mapping_tpu_torch/_kernels/csrc`,
checks each kernel against its plain PyTorch twin on the card at the shapes
the main paths give it, then drives the main paths, each with the kernel
launch counts set to 0 just before it and read just after:

- the AICP frame path through `App(config, device="cuda").process_cloud`
  at the benchmark's operating point (65,536-point raw clouds -> 16,384
  voxels -> 8,192 filtered points, coarse-to-fine ICP) against the same App
  on the CPU;
- the golden scenario against `tests/golden/pipeline_golden.json`;
- map-scale localization: `ShardedMapLocalizer.localize` of 60,000-point
  scans against a 262,144-point prior map, cropped to 65,536 and to
  131,072 points (the banded matcher K5 at both), against the same
  localizer on the CPU and against ground truth;
- the golden file's prior-map and go-back scenarios.

Every phase asserts; the last line of standard output is
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
        replaces="aicp_mapping_tpu/ops/normals.py:221, "
                 "aicp_mapping_tpu/ops/normals.py:182"),
    "radius_moments": dict(
        source="aicp_mapping_tpu_torch/_kernels/csrc/moments.cu",
        replaces="aicp_mapping_tpu/ops/normals.py:110"),
    "banded_nn_payload_stream": dict(
        source="aicp_mapping_tpu_torch/_kernels/csrc/banded_nn.cu",
        replaces="aicp_mapping_tpu/ops/banded_nn.py:397, "
                 "aicp_mapping_tpu/ops/banded_nn.py:498"),
}
GT_TOL = 0.06                     # m, tests/test_parallel.py:308


def log(*args):
    print(*args, flush=True)


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def cells():
    """The bench operating point (`bench_config`) and the map-scale
    localization cells (`map_scene`, `CROP_RADIUS`, `sensor_frame`),
    defined once in the port's localization profiler."""
    from aicp_mapping_tpu_torch.tools import profile_localize

    return profile_localize


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


def moments_check(torch, name, a, b):
    """Moments against their plain twin: counts within 2 for >= 99% of
    points, moments within rtol 1e-4 / atol 1e-3 where the counts agree."""
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
        torch, f"K2 banded_moments N={N}",
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
        err = moments_check(torch, f"K3 radius_moments N={N}",
                            normals.radius_moments_kernel(*args),
                            normals.radius_moments(*args))
        ms_k = time_ms(torch, lambda: normals.radius_moments_kernel(*args))
        plain = time_ms(torch, lambda: normals.radius_moments(*args))
        log(f"K3 radius_moments N={N}: kernel {ms_k * 1e3:.1f} us, "
            f"plain {plain * 1e3:.1f} us")
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if N == 4096:
            r.update(ms=ms_k, plain_ms=plain)


def check_banded_kernels(torch, results: dict, scene) -> None:
    """Phase 3, map scale: K2 on the 262,144-point map, and K5 on the crops
    of 65,536 and 131,072 points the localizer hands ICP (the TPU's
    resident and streaming shapes), with the fine phase's 8,192 queries and
    the coarse phase's 1,024, each against its plain twin; recall against
    exact NN (K1)."""
    from aicp_mapping_tpu_torch import App, Cloud
    from aicp_mapping_tpu_torch.geometry import se3
    from aicp_mapping_tpu_torch.ops import banded_nn, knn, normals
    from aicp_mapping_tpu_torch.parallel import ShardedMapLocalizer
    from aicp_mapping_tpu_torch.registration.icp import banded_band

    dev = "cuda"
    map_np, items, gts = scene
    loc = ShardedMapLocalizer(map_np, device=dev,
                              crop_radius=cells().CROP_RADIUS,
                              out_capacity=131072)
    # K2 on the whole map, Morton-sorted as _radius_moments_banded sorts it
    p, m = loc.map_points, loc.map_mask
    codes = banded_nn.morton_codes(p, m, p[m].amin(0), 2.0)
    cs, perm = torch.sort(codes, stable=True)
    args = (p[perm].contiguous(), cs != banded_nn.SENTINEL, cs, 0.4)
    N = p.shape[0]
    err = moments_check(torch, f"K2 banded_moments N={N}",
                        normals.sorted_radius_moments_kernel(*args),
                        normals.sorted_radius_moments(*args))
    ms_k = time_ms(torch, lambda: normals.sorted_radius_moments_kernel(*args))
    plain = time_ms(torch, lambda: normals.sorted_radius_moments(*args),
                    reps=3, warmup=1)
    log(f"K2 banded_moments N={N}: kernel {ms_k * 1e3:.1f} us, plain "
        f"{plain * 1e3:.1f} us")
    r = results["banded_moments"]
    r.update(max_abs_err=max(r["max_abs_err"], err), ms_262144=ms_k,
             plain_ms_262144=plain)

    # queries: scan 0 placed in the map, prefiltered as the App filters a
    # reading (8,192 points), under a small motion (an ICP iterate)
    cfg = cells().bench_config()
    cell = cfg.icp.nn_cell_size
    _, pts, odom = items[0]
    world = (cells().sensor_frame(pts, odom) @ gts[0][:3, :3].T
             + gts[0][:3, 3])
    reading = App(cfg, device=dev).filter_cloud(
        Cloud.from_numpy(world, capacity=cfg.raw_capacity), gts[0][:3, 3])
    assert int(reading.count()) == cfg.filtered_capacity
    T = se3.se3_exp(torch.tensor([0.05, -0.03, 0.01, 0.0, 0.0, 0.008],
                                 device=dev))
    reading = se3.transform_points(T, reading.points)
    kernel = banded_nn.nn_payload_banded_stream_kernel
    r = results.setdefault("banded_nn_payload_stream", dict(max_abs_err=0.0))
    for n_ref in (65536, 131072):
        loc.out_capacity = n_ref
        rp, rm, rn = loc.provide_reference(gts[0])
        origin = torch.where(rm[:, None], rp, 1e30).amin(0)
        rs, rpen, rcodes, pay = banded_nn.banded_prepare_payload(
            rp, rm, rn, origin, cell)
        assert rs.shape[0] == n_ref
        for M, phase in ((8192, "fine"), (1024, "coarse")):
            q = reading[:: 8192 // M]
            qm = torch.ones(M, dtype=torch.bool, device=dev)
            qcodes = banded_nn.morton_codes(q, qm, origin, cell)
            qcodes, qperm = torch.sort(qcodes, stable=True)
            q = q[qperm].contiguous()
            band = banded_band(M, n_ref)
            starts = banded_nn.banded_window_starts(
                qcodes, rcodes, n_ref // 1024, band, 512, 1024)
            args = (q, rs, rpen, pay, starts, band)
            d_k, p_k = kernel(*args)
            d_p, p_p = banded_nn.nn_payload_banded(*args)
            d_x, p_x = knn.nn_payload_kernel(q, qm, rs, rpen == 0, pay)
            torch.cuda.synchronize()
            frac = (p_k == p_p).all(1).float().mean().item()
            e = (d_k - d_p).abs().max().item()
            # K1 contracts its distance into FMAs, so compare which
            # reference was found (its payload row), and distances up to
            # that rounding
            exact = (p_k == p_x).all(1).float().mean().item()
            log(f"K5 M={M} N={n_ref} band={band}: identical payload rows "
                f"{frac:.5f}, max|dd2| {e:.3g} m^2, exact-NN share "
                f"{exact:.5f}, mean d2 {d_k.mean().item():.4g} m^2")
            assert frac >= 0.997, frac
            assert e <= 3e-3, e
            assert exact >= 0.98, exact
            assert bool((d_k >= d_x - 1e-5).all())
            ms_k = time_ms(torch, lambda: kernel(*args))
            plain = time_ms(torch, lambda: banded_nn.nn_payload_banded(*args))
            log(f"K5 M={M} N={n_ref} band={band}: kernel "
                f"{ms_k * 1e3:.1f} us, plain {plain * 1e3:.1f} us")
            r["max_abs_err"] = max(r["max_abs_err"], e)
            r[f"ms_{phase}_{n_ref}"] = ms_k
            r[f"plain_ms_{phase}_{n_ref}"] = plain
            if (phase, n_ref) == ("fine", 131072):
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
    from aicp_mapping_tpu_torch import AlignedCloud, App, Cloud
    from aicp_mapping_tpu_torch.convert import (app_state_from_numpy,
                                                app_state_to_numpy)
    from aicp_mapping_tpu_torch.pipeline.sequence import synthetic_sequence

    cfg = cells().bench_config()
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


def run_localization(torch, scene, out_capacity: int) -> None:
    """Map-scale localization: `ShardedMapLocalizer.localize` on the card
    at the bench operating point against the 262,144-point map cropped to
    `out_capacity` points, each frame checked against a CPU localizer
    built from the card's state (map normals included) and against the
    ground-truth pose."""
    from aicp_mapping_tpu_torch import _kernels
    from aicp_mapping_tpu_torch.convert import (localizer_from_state,
                                                localizer_state_to_numpy)
    from aicp_mapping_tpu_torch.parallel import ShardedMapLocalizer
    from aicp_mapping_tpu_torch.registration.icp import solver_plan

    map_np, items, gts = scene
    cfg = cells().bench_config()
    plan = solver_plan(cfg.icp, cfg.filtered_capacity, out_capacity, "cuda")
    assert plan == {"nn": "banded", "coarse": True}, plan
    kw = dict(pipeline_config=cfg, crop_radius=cells().CROP_RADIUS,
              out_capacity=out_capacity)
    before = _kernels.launch_counts()["banded_moments"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gpu = ShardedMapLocalizer(map_np, cfg.icp, device="cuda", **kw)
    torch.cuda.synchronize()
    load_ms = (time.perf_counter() - t0) * 1e3
    # the map's normals went through K2, once
    loads = _kernels.launch_counts()["banded_moments"] - before
    assert loads == 1, loads
    gpu_ms, cpu_s = [], []
    for i, ((utime, pts, odom), gt) in enumerate(zip(items, gts)):
        cpu = localizer_from_state(localizer_state_to_numpy(gpu), cfg.icp,
                                   device="cpu", **kw)
        local = cells().sensor_frame(pts, odom)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pose_g = gpu.localize(local, odom, capacity=cfg.raw_capacity)
        torch.cuda.synchronize()
        gpu_ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        pose_c = cpu.localize(local, odom, capacity=cfg.raw_capacity)
        cpu_s.append(time.perf_counter() - t0)
        rg, rc = gpu.last_result, cpu.last_result
        err = float(np.linalg.norm(pose_g[:3, 3] - gt[:3, 3]))
        log(f"localize crop {out_capacity} frame {i}: card "
            f"{gpu_ms[-1]:.1f} ms, iters {rg.n_iterations} (cpu "
            f"{rc.n_iterations}), filtered {rg.filtered_size}, correction_t "
            f"{np.round(rg.correction[:3, 3], 4).tolist()} (cpu "
            f"{np.round(rc.correction[:3, 3], 4).tolist()}), |t - gt| "
            f"{err:.4f} m (cpu "
            f"{float(np.linalg.norm(pose_c[:3, 3] - gt[:3, 3])):.4f})")
        assert rg.reference_id == rc.reference_id == -1, (rg, rc)
        assert rg.registered and rg.accepted, rg
        frame_lines_agree(rg, as_line(rc),
                          f"localize crop {out_capacity} frame {i}")
        assert err < GT_TOL, (i, err)
    log(f"localization (crop {out_capacity}) on the card: load "
        f"{load_ms:.1f} ms (Morton order, upload, normals of "
        f"{gpu.map_points.shape[0]} points); localize "
        f"{np.mean(gpu_ms[1:]):.2f} ms/frame (mean of frames 1-"
        f"{len(gpu_ms) - 1}; min {min(gpu_ms[1:]):.2f}, max "
        f"{max(gpu_ms[1:]):.2f}; frame 0 {gpu_ms[0]:.2f}); CPU localizer "
        f"{np.mean(cpu_s):.2f} s/frame")


def run_golden_maps(torch) -> None:
    """The golden file's prior-map and go-back scenarios
    (tests/test_golden.py::_run_prior_map, _run_go_back) on the card."""
    from aicp_mapping_tpu_torch import (AlignedCloud, App, Cloud,
                                        PipelineConfig)
    from aicp_mapping_tpu_torch.pipeline.sequence import synthetic_sequence

    with open(os.path.join(ROOT, "tests", "golden",
                           "pipeline_golden.json")) as f:
        golden = json.load(f)

    def cfg(**kw):
        return PipelineConfig(raw_capacity=8192, downsample_capacity=4096,
                              filtered_capacity=2048, min_cluster_size=20,
                              failure_prediction_mode=False,
                              crop_map_around_base=20.0, map_capacity=16384,
                              **kw)

    def frame(c, utime, pts, pose):
        return AlignedCloud.create(utime, Cloud.from_numpy(
            pts, capacity=c.raw_capacity), np.asarray(pose, np.float32))

    items, _ = synthetic_sequence(n_frames=8, n_points=5000, seed=11)
    c = cfg(localize_against_prior_map=True)
    app = App(c, device="cuda")
    world = np.concatenate([p for _, p, _ in items[:6]])
    app.set_prior_map(Cloud.from_numpy(world, capacity=16384))
    got = [app.process_cloud(frame(c, *it)) for it in items[:6]]
    c = cfg()
    app = App(c, device="cuda")
    back = []
    for i, it in enumerate(items):
        if i == 5:
            app.go_back_to_map()
        back.append(app.process_cloud(frame(c, *it)))
    for name, frames in (("prior_map", got), ("go_back", back)):
        want = golden[name]
        assert len(frames) == len(want)
        for i, (r, w) in enumerate(zip(frames, want)):
            assert r.reading_id == w["reading_id"], (name, i, r)
            assert r.reference_id == w["reference_id"], (name, i, r)
            frame_lines_agree(r, w, f"{name} frame {i}")
        log(f"golden {name} on the card: {len(want)} frames match "
            "tests/golden/pipeline_golden.json")


def drive(name: str, fn, expect) -> dict:
    """Run one main path with the launch counts set to 0 just before it;
    returns its counts and fails if a kernel of the path never launched."""
    from aicp_mapping_tpu_torch import _kernels

    _kernels.reset_launch_counts()
    fn()
    counts = _kernels.launch_counts()
    log(f"launches on the {name} path: {counts}")
    assert all(counts[k] > 0 for k in expect), (name, counts)
    return counts


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
    scene = cells().map_scene()
    check_kernels(torch, results)
    check_banded_kernels(torch, results, scene)

    # 4-7. the main paths, each with its own launch counts
    paths = [
        drive("frame", lambda: run_bench_slice(torch),
              ("nn_payload", "banded_moments")),
        drive("golden", lambda: run_golden(torch),
              ("nn_payload", "radius_moments")),
        drive("localization", lambda: (
            run_localization(torch, scene, 65536),
            run_localization(torch, scene, 131072)),
            ("banded_nn_payload_stream", "banded_moments")),
        drive("golden map modes", lambda: run_golden_maps(torch),
              ("nn_payload", "radius_moments")),
    ]
    counts = {k: sum(c[k] for c in paths) for k in KERNELS}

    # 8. the main paths went through every kernel
    log(f"launches on all paths: {counts}")
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
