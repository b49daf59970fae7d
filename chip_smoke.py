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
- ICP's captured iteration (`run_icp_graph`) at the same point: the
  App's two captures and then every iteration a replay, each frame's ICP
  call by the graph and by the eager loop against each other, K1's
  launches on both and under the profiler;
- the golden scenario against `tests/golden/pipeline_golden.json`;
- map-scale localization: `ShardedMapLocalizer.localize` of 60,000-point
  scans against a 262,144-point prior map, cropped to 65,536 and to
  131,072 points (the banded matcher K5 at both), against the same
  localizer on the CPU and against ground truth;
- the golden file's prior-map and go-back scenarios;
- failure prediction: the golden risk-gated scenario and the bench
  operating point with `failure_prediction_mode` and the shipped risk
  classifier, each frame against the CPU App started from the card App's
  state, and the card's risk stage against the CPU's on the same inputs;
- the pair-registration CLI, `cli.main(["register", ...])`, on a
  60,000-point pair with a known perturbation (ICP by K5, the Hausdorff
  check by K1's index mode), and on an 8,192-point pair against the same
  command on the CPU;
- the public nearest-neighbour API: `ops.knn.nn_payload_tiled_kernel` (JAX's
  `nn_payload_pallas`, K1) at 8,192 x 8,192, and `ops.banded_nn`'s
  `nn_argmin_banded_prepared` (K5's index mode), `nn_payload_banded_sorted`
  and `nn_payload_banded_resident` (K5) at 8,192 x 65,536, against exact
  1-NN by the plain twins on the card;
- the SLAM path (`run_slam`): `eval.slam_accuracy`'s urban drive at seed
  0 (44 frames, region growing at 16,384 raw / 8,192 voxels / 4,096
  filtered points) through the App and `run_backend` (loop closures by
  K1, keyframe normals by K3, PGO, plane BA), each back-end stage timed
  and counted, against the accuracy regression's assertions (its two
  back-end margins at seeds 3 and 7, printed at seed 0), with the whole
  back-end replayed by a CPU mapper from the card's seed-0 keyframes;
- the streaming front-end (`run_stream`) at bench.py's own operating point
  (depth 32, the host voxel grid at 0.08 m with the int16 upload, async
  finalize): bench.py's 40 frames through
  `SequenceRunner(pipelined=True).run_clouds(..., batch_h2d=16)`, a
  warm-up pass and 3 timed passes on one App (scans/s), the uploads of the
  preparation thread against synchronous uploads bit for bit, the frames
  against the same pipeline finalizing inline and against a synchronous
  App (ms/frame) up to the first rejection, 6 wire frames against the CPU
  App with the dequantized clouds equal on both devices, and a
  `StreamingDriver` drive;
- distribution (`run_distributed`): two ranks (processes started by
  `parallel.launch`) share the card over gloo, collectives staged through
  pinned host memory: (a) the reading-sharded ICP at the bench shape
  (8,192 x 8,192, coarse-to-fine, K1 on each rank) against the card's
  single-device solve; (b) the map-sharded ICP, 8,192 x 16,384 in two
  exhaustive blocks (K1) against the single-device solve, and 8,192 x the
  262,144-point map in two blocks (K5) recovering a known perturbation;
  (c) `ShardedMapLocalizer` over the two ranks (K2 normals of 131,072-row
  blocks) on the localization scene's 4 scans at the 65,536 crop; (d) the
  SLAM back-end at seed 0 from fixed keyframes, its PGO edge-sharded and
  its BA observation-sharded, each solve against the unsharded one on the
  card; (e) one rank on an NCCL mesh running (a). The ranks' launch counts
  of the sharded work are added to the phase's: each rank's inputs and
  references run inside `not_path` and are taken out, and the seed-0
  front-end that (d) starts from runs before the phase's counts start;
- the KITTI path (`run_kitti`): 20 KITTI-layout `.bin` scans of the urban
  world (the 64-beam scanner at 2,048 azimuths, ~121,000 points each)
  along a 10 m/s drive, through `eval.kitti_runner.run_kitti_sequence`
  at the KITTI default config (131,072 raw / 32,768 voxels / 16,384
  filtered points; K1 at 16,384^2, K2 at 32,768) with GPS-grade priors
  and ground removal on the card, held to tests/test_eval.py's runner
  assertions but for its error ratio, which is held to the JAX package's
  own on that drive; its first 4 frames against the CPU App from the
  card App's state, every scan's ground mask against the CPU's;
  tests/test_eval.py's own runner test, every assertion; then
  `kitti-run` and `kitti-eval` through the CLI;
- the outdoor-accuracy regression (`run_accuracy_phase`):
  `eval.accuracy.run_accuracy` over 200 frames at its full-width default
  (region growing at 65,536 / 16,384 / 8,192), printed beside
  ACCURACY_r3.json with the frames around its first rejection against
  the CPU App, and tests/test_accuracy.py's own 20-frame regression held
  to its thresholds;
- pairs and checkpoints (`run_pairs_and_checkpoints`): `run_pairwise` of
  3 room clouds at capacity 8,192 (K3 normals, K1 ICP), the `classifier
  --train/--test` CLI and a checkpointed bench run resumed on the card
  (bit for bit) and on the CPU, each against the CPU;
- the visualizer sinks and the last modules (`run_viz`): (1) the bench
  point with failure prediction through an App with a
  `RecordingVisualizer` and one without, in turns, their frames bit for
  bit, each frame's publishes against a CPU App's with its own sink
  (poses 0.05 m, cloud and map rows 1 %, metrics the golden tolerances),
  ms/frame and device-to-host copies per frame (`torch.profiler`) of
  both; (1b) the same pair pipelined at depth 4 with async finalize (the
  sink's reads on the finalizer thread), frames bit for bit, publishes in
  frame order; (2) a `FileVisualizer`'s PCDs read back; (3)
  `cli.main(["replay", ..., "--live-viz", PORT])` over a recorded
  sequence with a viewer thread, which must receive cloud, map, pose and
  metric frames; (4) `draw` (both modes) and `vtk-to-octree`, normals
  against `--device cpu`; (5) the planar 2D chain (K1 at 1,024^2) on
  `synthetic_room_scan` and the shipped `data/scan_0*.csv` against the
  CPU and the truth; (6) `tools/drive_demo.py`'s flow with its
  assertions.

Phase 3 holds K1 and K2 at the KITTI widths too (16,384^2, 2,048 x
16,384; 32,768), and holds K1 and K5 (both modes) to their twins on a scene of
exact ties across the slices their split scans cut the window into, and
logs each scan's grid (query blocks x splits) beside its time. The
moments kernels K2 and K3 must give their twins' neighbour counts at every
point and the same bits on two launches; their lines also carry the
share of rows equal to the twin's bits, the scan's and the merge's device
times (`torch.profiler`) and the issue-rate floor of the scan's inner loop
(`tools/kernel_sass.py`). The label-propagation kernel must give the
eager loop's labels bit for bit and its rounds, on an alignability cloud
of 4,096 slots (`anymal_fp`'s shape) and at 16,384 and 32,768 points; its
line carries its device time beside the eager loop's.
Kernel times are device times by CUDA events: the stream sleeps before
each timed loop, so that the host has queued every call first. Each
kernel's line also carries the least time the card could take for the
same work (`bound_ms`: FP32 operations at 67 TFLOP/s or bytes at 3.35
TB/s, whichever is longer, counted from this run's inputs) and the time
of one PyTorch call computing the same function where one exists
(`library_ms`; none does for these kernels).

Every phase asserts; the last line of standard output is
`{"ok": true, "device": {...}}` only when all of them passed. Imports
nothing of JAX. Exits non-zero without a result when CUDA is unavailable.
"""
import collections
import contextlib
import dataclasses
import functools
import importlib
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
        replaces="aicp_mapping_tpu/ops/knn.py:322, "
                 "aicp_mapping_tpu/ops/knn.py:218, "
                 "aicp_mapping_tpu/ops/knn.py:265"),
    "nn_argmin": dict(
        source="aicp_mapping_tpu_torch/_kernels/csrc/nn_payload.cu",
        replaces="aicp_mapping_tpu/ops/knn.py:139"),
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
                 "aicp_mapping_tpu/ops/banded_nn.py:498, "
                 "aicp_mapping_tpu/ops/banded_nn.py:200, "
                 "aicp_mapping_tpu/ops/banded_nn.py:293"),
    "banded_nn_argmin": dict(
        source="aicp_mapping_tpu_torch/_kernels/csrc/banded_nn.cu",
        replaces="aicp_mapping_tpu/ops/banded_nn.py:57"),
    "label_propagation": dict(
        source="aicp_mapping_tpu_torch/_kernels/csrc/propagation.cu",
        replaces="none (port only): the eager loop of "
                 "aicp_mapping_tpu_torch/ops/segmentation.py, where JAX "
                 "runs a while_loop"),
}
GT_TOL = 0.06                     # m, tests/test_parallel.py:308
# Golden-file tolerances of the risk stage (tests/test_golden.py): %, 0-100
# alignability, probability.
TOL_RISK = {"fov_overlap": 2.0, "alignability": 5.0, "risk": 0.1}
CLASSIFIER = os.path.join(ROOT, "data", "classification",
                          "risk_classifier.npz")
# The H100 SXM's published peaks (NVIDIA data sheet, at 700 W): FP32 off
# the tensor cores and HBM3 bandwidth.
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
# FP32 operations per distance evaluation |q - r|^2: 3 sub, 3 mul, 2 add.
OPS_PER_PAIR = 8
# ... and per neighbour accumulated into the 10 moment sums
OPS_PER_NEIGHBOUR = 10
BIG = 3.4e38
NN_API_CELL = 4.0     # m, the ICP's Morton cell (ICPConfig.nn_cell_size)
NN_API_BAND = 16      # of 64 blocks: the auto band of 8,192 x 65,536
STREAM_FRAMES = 40    # bench.py --frames
# The ICP graph phase: its bench frames, and the first frame after the
# bootstrap, the eager frame and the capturing one; the benchmark's limit
# on the widest gap between two corrections (portbench/workloads).
ICP_GRAPH_FRAMES = 8
ICP_GRAPH_WARM = 3
CORR_GAP_M = 0.002


def log(*args):
    print(*args, flush=True)


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


# Map-scale localization: a 60 m room mapped at 262,140 points (padded to
# 262,144) and scans of the same room (other samples) at the bench size.
MAP_ARGS = dict(n=262144, size=60.0, seed=1, noise=0.01)
SCAN_ARGS = dict(n_points=60000, step=1.2, seed=0, world_size=60.0,
                 sensor_range=40.0, noise=0.02)
CROP_RADIUS = 40.0                # the sensor range


def bench_config():
    """The benchmark's operating point (bench.py:260-281) on the raw path."""
    from aicp_mapping_tpu_torch.pipeline.config import PipelineConfig

    cfg = PipelineConfig(raw_capacity=65536, downsample_capacity=16384,
                         filtered_capacity=8192, quantized_upload=False,
                         wire_voxel=0.0)
    cfg.icp = dataclasses.replace(cfg.icp, coarse_iterations=6,
                                  coarse_decimation=8)
    return cfg


def stream_config():
    """bench.py's streaming operating point (bench.py:260-281) as the JAX
    App runs it there: the bench capacities and coarse-to-fine ICP,
    `pipeline_depth` 32, the host voxel grid at 0.08 m with the int16
    upload, and async finalize."""
    cfg = bench_config()
    cfg.pipeline_depth = 32
    cfg.quantized_upload = True
    cfg.wire_voxel = 0.08
    cfg.async_finalize = True
    return cfg


def map_scene(n_frames: int = 4):
    """The prior map, and `n_frames` scans of the bench sequence with their
    odometry and ground-truth poses."""
    from aicp_mapping_tpu_torch.pipeline.sequence import synthetic_sequence
    from aicp_mapping_tpu_torch.tools.synthetic import room_cloud

    items, gts = synthetic_sequence(n_frames=n_frames, **SCAN_ARGS)
    return room_cloud(**MAP_ARGS), items, gts


def sensor_frame(pts, odom):
    """Odometry-frame points back to the sensor frame."""
    odom = np.asarray(odom, np.float32)
    return ((pts - odom[:3, 3]) @ odom[:3, :3]).astype(np.float32)


def time_ms(torch, fn, reps=20, warmup=3) -> float:
    """Mean device time of `fn` in ms, by CUDA events after warm-up. The
    stream first sleeps ~10 ms, so that the host has queued every call
    before the first one runs: a call whose host side takes longer than its
    kernels (every path is host-bound) is timed by its kernels. A `fn` that
    reads from the device waits for it, and is timed with its waits."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def grid(plan, M: int) -> str:
    """A scan's grid, query blocks x splits (of split_len references), from
    its split plan."""
    blocks = -(-M // (128 * plan.queries_per_thread))
    return f"grid {blocks} x {plan.splits} (slices of {plan.split_len})"


def bound(ops: float, nbytes: float) -> dict:
    """The least time the card could take for `ops` FP32 operations that
    move `nbytes` of inputs and outputs once each, in ms, and which of the
    two bounds it."""
    t_ops, t_bytes = ops / PEAK_FP32, nbytes / PEAK_BYTES
    return dict(bound_ms=max(t_ops, t_bytes) * 1e3,
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                library_ms=None)


def window_pairs(qmask, rmask, starts, band: int, tm: int = 512,
                 tn: int = 1024) -> int:
    """Valid (query, reference) pairs a banded kernel must evaluate: each
    `tm`-query tile against the valid references of its `band` blocks."""
    total = 0
    for g, s in enumerate(starts.tolist()):
        total += (int(qmask[g * tm:(g + 1) * tm].sum())
                  * int(rmask[s * tn:(s + band) * tn].sum()))
    return total


def lidar_room(n: int, seed: int) -> np.ndarray:
    """A 20 m synthetic room at lidar range: ~59 m from the origin."""
    from aicp_mapping_tpu_torch.tools.synthetic import room_cloud

    pts = room_cloud(n=n * 6 // 5 + 12, size=20.0, seed=seed, noise=0.01)[:n]
    return (pts + np.array([45.0, -38.0, 1.5], np.float32)).astype(np.float32)


def moments_check(torch, name, a, b, valid):
    """Moments against their plain twin: the same neighbour count at every
    point, moments within rtol 1e-4 / atol 1e-3 at every point (`valid` or
    not: the sums are the same). Returns (max |difference| at the valid
    points, the share of rows equal to the twin's to the bit)."""
    bad = int((a[:, 9] != b[:, 9]).sum())
    assert bad == 0, f"{name}: {bad} neighbour counts differ from the twin"
    torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-3)
    err = (a[valid] - b[valid]).abs().max().item()
    same = (a == b).all(1).float().mean().item()
    log(f"{name}: neighbour counts equal to the twin's at every point, "
        f"moments max|d| {err:.3g} at the valid points, rows equal to the "
        f"twin's bits {same:.6f}, mean count {b[valid, 9].mean().item():.1f}")
    return err, same


@functools.lru_cache(maxsize=None)
def moments_sass() -> tuple:
    """(SASS instructions per pair of the moments scan's inner loop with 4
    queries per thread, its issue rate in lane-instructions per second at
    the card's maximum SM clock)."""
    from aicp_mapping_tpu_torch import _kernels
    from aicp_mapping_tpu_torch.tools import kernel_sass

    _, clock = kernel_sass.sm_clock_ghz()
    rows = [r for r in kernel_sass.analyse(str(_kernels.build()), clock)
            if "moments_scan_kernelILi4E" in r["kernel"]]
    assert len(rows) == 1, rows
    return rows[0]["instructions_per_pair"], 132 * 4 * 32 * clock * 1e9


def scan_and_merge_us(torch, fn, reps: int = 10) -> tuple:
    """Device µs per call of the scan and of the merge that `fn` launches,
    from a `torch.profiler` trace of `reps` calls."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    from portbench.trace import load, port_kernel

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        kernels = [(port_kernel(e.name), e.dur) for e in load(path).device
                   if e.cat == "kernel" and port_kernel(e.name)]
    scan = sum(us for k, us in kernels if "scan" in k) / reps
    merge = sum(us for k, us in kernels if "merge" in k) / reps
    assert scan > 0 and merge > 0, kernels
    return scan, merge


def check_moments(torch, name, kernel, plain, args, plan, window: int,
                  valid, ops: float, nbytes: float, plain_reps: int = 20):
    """K2 or K3 at one shape: two launches equal to the bit, then against
    the plain twin (`moments_check`); times of the kernel (and of its scan
    and merge apart) and the twin; the bound and the issue-rate floor of
    the n x `window` pairs the scan visits. Returns the kernel's numbers."""
    got = kernel(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, kernel(*args)), f"{name}: launches differ"
    err, same = moments_check(torch, name, got, plain(*args), valid)
    from aicp_mapping_tpu_torch.ops.normals import MOMENTS_PIECE

    n = valid.shape[0]
    blocks = -(-n // (128 * plan.queries_per_thread))
    grid_line = (f"grid {blocks} x {plan.splits}, pieces of {MOMENTS_PIECE}"
                 f" dealt round-robin, <= {plan.split_len} references a "
                 "block")
    ms = time_ms(torch, lambda: kernel(*args))
    plain_ms = time_ms(torch, lambda: plain(*args), reps=plain_reps,
                       warmup=1)
    scan, merge = scan_and_merge_us(torch, lambda: kernel(*args))
    per_pair, rate = moments_sass()
    floor_us = n * window * per_pair / rate * 1e6
    b = bound(ops, nbytes)
    log(f"{name}: kernel {ms * 1e3:.1f} us (scan {scan:.1f} + merge "
        f"{merge:.1f} us profiled; {grid_line}), plain "
        f"{plain_ms * 1e3:.1f} us, bound {b['bound_ms'] * 1e3:.1f} us "
        f"({b['bound_by']}), issue-rate floor {floor_us:.1f} us "
        f"({n} x {window} pairs x {per_pair:.2f} instructions)")
    return dict(err=err, bit_equal_rows=same, ms=ms, plain_ms=plain_ms,
                scan_us=scan, merge_us=merge, floor_us=floor_us, **b)


def moment_numbers(k: dict, suffix: str = "") -> dict:
    """`check_moments`' numbers as a kernel's JSON keys, with `suffix`."""
    return {key + suffix: k[key] for key in (
        "ms", "plain_ms", "bound_ms", "bit_equal_rows", "scan_us",
        "merge_us", "floor_us")}


def check_propagation(torch, results: dict) -> None:
    """Phase 3: the label-propagation kernel against the eager loop on the
    same card tensors, at `anymal_fp`'s shape (an alignability cloud: 4,096
    voxel-grid slots, 30-NN normals, a 15-NN graph) and at the region-
    growing prefilter's 16,384 and 32,768 points: labels bit for bit, the
    same rounds; the kernel's device time against the eager loop's, whose
    rounds each end in a host read."""
    from aicp_mapping_tpu_torch import _kernels
    from aicp_mapping_tpu_torch.ops import normals, segmentation
    from aicp_mapping_tpu_torch.ops.voxel import voxel_downsample
    knn = importlib.import_module("aicp_mapping_tpu_torch.ops.knn")

    dev = "cuda"
    r = results.setdefault("label_propagation", {})
    for n in (4096, 16384, 32768):
        if n == 4096:
            raw = torch.as_tensor(lidar_room(20000, seed=7), device=dev)
            p, m = voxel_downsample(raw, torch.ones(20000, dtype=torch.bool,
                                                    device=dev), 0.08, n)
        else:
            p = torch.as_tensor(lidar_room(n, seed=7), device=dev)
            m = torch.arange(n, device=dev) < n - n // 32
        _, nbr = knn.knn(p, m, p, m, 30)
        nrm, curv, _ = normals.normals_from_neighbors(
            p, m, nbr, torch.zeros(3, device=dev))
        idx, pull_ok = segmentation.smoothness_graph(p, m, nrm, curv, 15,
                                                     neighbor_idx=nbr)
        args = (idx, pull_ok, m)
        segmentation.reset_propagation_rounds()
        want = segmentation.propagate_labels(*args)
        rounds = segmentation.propagation_rounds()["rounds"]
        segmentation.reset_propagation_rounds()
        before = _kernels.launch_counts()["label_propagation"]
        got = segmentation.propagate_labels_kernel(*args)
        torch.cuda.synchronize()
        assert _kernels.launch_counts()["label_propagation"] == before + 1
        assert torch.equal(got, want), n
        got_rounds = segmentation.propagation_rounds()["rounds"]
        assert got_rounds == rounds, (n, got_rounds, rounds)
        ms = time_ms(torch, lambda: segmentation.propagate_labels_kernel(
            *args))
        plain = time_ms(torch, lambda: segmentation.propagate_labels(*args),
                        reps=5, warmup=1)
        k = idx.shape[1]
        b = bound(0, 8 * n * k + n * k + n + 8 * n)
        plan = segmentation.propagation_plan(n, k)
        log(f"label_propagation n={n} k={k} (mode {plan.mode}, "
            f"{plan.smem_bytes} B shared, {int(m.sum())} valid): labels "
            f"bit-equal, {rounds} rounds both; kernel {ms * 1e3:.1f} us "
            f"({ms * 1e3 / rounds:.2f} us a round), eager loop "
            f"{plain:.2f} ms, bound {b['bound_ms'] * 1e3:.2f} us "
            f"({b['bound_by']})")
        r.update({f"ms_{n}": ms, f"plain_ms_{n}": plain,
                  f"rounds_{n}": rounds})
        if n == 4096:
            r.update(ms=ms, plain_ms=plain, rounds=rounds, **b)


def check_kernels(torch, results: dict) -> None:
    """Phase 3: each kernel against its plain twin on the card."""
    from aicp_mapping_tpu_torch.geometry import se3
    from aicp_mapping_tpu_torch.ops import banded_nn, normals
    knn = importlib.import_module("aicp_mapping_tpu_torch.ops.knn")

    dev = "cuda"
    rng = np.random.default_rng(0)
    # queries: a second scan of the room, slightly moved (an ICP iterate)
    T = se3.se3_exp(torch.tensor([0.05, -0.03, 0.01, 0.0, 0.0, 0.01],
                                 device=dev))
    # (M, N): the frame path's fine and coarse ICP, the SLAM path's
    # front-end and closure ICP at 4,096 x 4,096 (no coarse phase there),
    # and the KITTI widths' fine and coarse ICP
    for M, N in ((8192, 8192), (1024, 8192), (4096, 4096), (16384, 16384),
                 (2048, 16384)):
        ref = torch.as_tensor(lidar_room(N, seed=1), device=dev)
        rmask = torch.arange(N, device=dev) < N - 3 * N // 128
        payload = torch.cat([ref, torch.as_tensor(
            rng.normal(size=(N, 5)).astype(np.float32), device=dev)],
            dim=1).contiguous()
        scan = torch.as_tensor(lidar_room(N, seed=2), device=dev)
        q = se3.transform_points(T, scan[:: N // M]).contiguous()
        qm = torch.arange(M, device=dev) < M - M // 32
        args = (q, qm, ref, rmask, payload)
        d_k, p_k = knn.nn_payload_kernel(*args)
        d_p, p_p = knn.nn_payload(*args)
        torch.cuda.synchronize()
        same = (p_k == p_p).all(1)
        frac = same[qm].float().mean().item()
        err = (d_k - d_p)[qm].abs().max().item()
        log(f"K1 nn_payload M={M} N={N} ({grid(knn.nn_split_plan(M, N), M)})"
            f": identical payload rows {frac:.5f}, max|dd2| {err:.3g} m^2")
        assert frac >= 0.997, frac
        assert err <= 3e-3, err
        assert bool(same[~qm].all()) and bool((d_k[~qm] == 3.4e38).all())
        ms = time_ms(torch, lambda: knn.nn_payload_kernel(*args))
        plain = time_ms(torch, lambda: knn.nn_payload(*args))
        P = payload.shape[1]
        b = bound(OPS_PER_PAIR * int(qm.sum()) * int(rmask.sum()),
                  13 * (M + N) + 4 * P * N + 4 * M * (1 + P))
        log(f"K1 nn_payload M={M} N={N}: kernel {ms * 1e3:.1f} us "
            f"({grid(knn.nn_split_plan(M, N), M)}), plain "
            f"{plain * 1e3:.1f} us, bound {b['bound_ms'] * 1e3:.1f} us "
            f"({b['bound_by']})")
        r = results.setdefault("nn_payload", dict(max_abs_err=0.0))
        r["max_abs_err"] = max(r["max_abs_err"], err)
        tag = str(M) if N == 8192 else f"{M}x{N}"
        r.update({f"ms_{tag}": ms, f"plain_ms_{tag}": plain,
                  f"bound_ms_{tag}": b["bound_ms"]})
        if M == 8192:
            r.update(ms=ms, plain_ms=plain, **b)

    # K1's index mode (Q2 #7) at the frame path's 8,192 points and at the
    # 65,536 points of the pair-registration CLI's Hausdorff check
    r = results.setdefault("nn_argmin", dict(max_abs_err=0.0))
    for n in (8192, 65536):
        q = torch.as_tensor(lidar_room(n, seed=5), device=dev)
        ref_n = torch.as_tensor(lidar_room(n, seed=6), device=dev)
        qm = torch.arange(n, device=dev) < n - n // 32
        rm = torch.arange(n, device=dev) % 50 != 0
        args = (q, qm, ref_n, rm)
        d_k, i_k = knn.nn_argmin_kernel(*args)
        d_p, i_p = knn.nn_argmin(*args)
        torch.cuda.synchronize()
        frac = (i_k == i_p)[qm].float().mean().item()
        err = (d_k - d_p)[qm].abs().max().item()
        log(f"#7 nn_argmin {n}x{n}: identical indices {frac:.5f}, max|dd2| "
            f"{err:.3g} m^2")
        assert frac >= 0.997, frac
        assert err <= 3e-3, err
        assert bool((d_k[~qm] == 3.4e38).all()) and bool((i_k[~qm] == 0).all())
        ms = time_ms(torch, lambda: knn.nn_argmin_kernel(*args))
        plain = time_ms(torch, lambda: knn.nn_argmin(*args), reps=5,
                        warmup=1)
        b = bound(OPS_PER_PAIR * int(qm.sum()) * int(rm.sum()),
                  13 * 2 * n + 12 * n)
        log(f"#7 nn_argmin {n}x{n}: kernel {ms * 1e3:.1f} us "
            f"({grid(knn.nn_split_plan(n, n), n)}), plain "
            f"{plain * 1e3:.1f} us, bound {b['bound_ms'] * 1e3:.1f} us "
            f"({b['bound_by']})")
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r[f"ms_{n}"], r[f"plain_ms_{n}"] = ms, plain
        if n == 65536:
            r.update(ms=ms, plain_ms=plain, **b)

    # K2 at the main path's 16,384 points and the KITTI widths' 32,768,
    # Morton-sorted as the prefilter sorts them
    r = results.setdefault("banded_moments", dict(max_abs_err=0.0))
    for N in (16384, 32768):
        p = torch.as_tensor(lidar_room(N, seed=3), device=dev)
        m = torch.arange(N, device=dev) < N - 384
        codes = banded_nn.morton_codes(p, m, p[m].amin(0), 2.0)
        codes_s, perm = torch.sort(codes, stable=True)
        ms = codes_s != banded_nn.SENTINEL
        args = (p[perm].contiguous(), ms, codes_s, 0.4)
        starts = banded_nn.banded_window_starts(codes_s, codes_s, N // 1024,
                                                8, 512, 1024)
        nbrs = int(normals.sorted_radius_moments(*args)[ms, 9].sum().item())
        k = check_moments(
            torch, f"K2 banded_moments N={N}",
            normals.sorted_radius_moments_kernel,
            normals.sorted_radius_moments, args,
            normals.moments_split_plan(N, 8 * 1024, 512), 8 * 1024, ms,
            OPS_PER_PAIR * window_pairs(ms, ms, starts, 8)
            + OPS_PER_NEIGHBOUR * nbrs, 21 * N + 40 * N)
        r["max_abs_err"] = max(r["max_abs_err"], k["err"])
        if N == 16384:
            r.update(bound_by=k["bound_by"], library_ms=k["library_ms"],
                     **moment_numbers(k))
        else:
            r.update(moment_numbers(k, f"_{N}"))

    # K3 at the golden scenario's 4,096 and at 8,192 points
    r = results.setdefault("radius_moments", dict(max_abs_err=0.0))
    for N in (4096, 8192):
        p = torch.as_tensor(lidar_room(N, seed=4), device=dev)
        m = torch.arange(N, device=dev) < N - N // 16
        args = (p, m, 0.4)
        nv = int(m.sum())
        nbrs = int(normals.radius_moments(*args)[m, 9].sum().item())
        k = check_moments(
            torch, f"K3 radius_moments N={N}", normals.radius_moments_kernel,
            normals.radius_moments, args, normals.moments_split_plan(N, N),
            N, m,
            OPS_PER_PAIR * nv * nv + OPS_PER_NEIGHBOUR * nbrs,
            13 * N + 40 * N)
        r["max_abs_err"] = max(r["max_abs_err"], k["err"])
        r.update(moment_numbers(k, f"_{N}"))
        if N == 4096:
            r.update(bound_by=k["bound_by"], library_ms=k["library_ms"],
                     **moment_numbers(k))


def check_banded_kernels(torch, results: dict, scene) -> None:
    """Phase 3, map scale: K2 on the 262,144-point map, and K5 on the crops
    of 65,536 and 131,072 points the localizer hands ICP (the TPU's
    resident and streaming shapes), with the fine phase's 8,192 queries and
    the coarse phase's 1,024, each against its plain twin; recall against
    exact NN (K1)."""
    from aicp_mapping_tpu_torch import App, Cloud
    from aicp_mapping_tpu_torch.geometry import se3
    from aicp_mapping_tpu_torch.ops import banded_nn, normals
    knn = importlib.import_module("aicp_mapping_tpu_torch.ops.knn")
    from aicp_mapping_tpu_torch.parallel import ShardedMapLocalizer
    from aicp_mapping_tpu_torch.registration.icp import banded_band

    dev = "cuda"
    map_np, items, gts = scene
    loc = ShardedMapLocalizer(map_np, device=dev,
                              crop_radius=CROP_RADIUS,
                              out_capacity=131072)
    # K2 on the whole map, Morton-sorted as _radius_moments_banded sorts it
    p, m = loc.map_points, loc.map_mask
    codes = banded_nn.morton_codes(p, m, p[m].amin(0), 2.0)
    cs, perm = torch.sort(codes, stable=True)
    valid = cs != banded_nn.SENTINEL
    args = (p[perm].contiguous(), valid, cs, 0.4)
    N = p.shape[0]
    starts = banded_nn.banded_window_starts(cs, cs, N // 1024, 8, 512, 1024)
    nbrs = int(normals.sorted_radius_moments(*args)[valid, 9].sum().item())
    k = check_moments(
        torch, f"K2 banded_moments N={N}",
        normals.sorted_radius_moments_kernel, normals.sorted_radius_moments,
        args, normals.moments_split_plan(N, 8 * 1024, 512), 8 * 1024, valid,
        OPS_PER_PAIR * window_pairs(valid, valid, starts, 8)
        + OPS_PER_NEIGHBOUR * nbrs, 21 * N + 40 * N,
        plain_reps=3)
    r = results["banded_moments"]
    r.update(max_abs_err=max(r["max_abs_err"], k["err"]),
             **moment_numbers(k, f"_{N}"))

    # queries: scan 0 placed in the map, prefiltered as the App filters a
    # reading (8,192 points), under a small motion (an ICP iterate)
    cfg = bench_config()
    cell = cfg.icp.nn_cell_size
    _, pts, odom = items[0]
    world = (sensor_frame(pts, odom) @ gts[0][:3, :3].T
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
            # bit for bit: every operation is rounded alike
            assert torch.equal(d_k, d_p) and torch.equal(p_k, p_p), (frac, e)
            assert exact >= 0.98, exact
            assert bool((d_k >= d_x - 1e-5).all())
            ms_k = time_ms(torch, lambda: kernel(*args))
            plain = time_ms(torch, lambda: banded_nn.nn_payload_banded(*args))
            log(f"K5 M={M} N={n_ref} band={band}: kernel "
                f"{ms_k * 1e3:.1f} us "
                f"({grid(banded_nn.banded_split_plan(M, band), M)}), plain "
                f"{plain * 1e3:.1f} us")
            P = pay.shape[1]
            b = bound(OPS_PER_PAIR * window_pairs(qm, rpen == 0, starts, band),
                      12 * M + 16 * n_ref + 4 * P * n_ref
                      + 4 * starts.numel() + 4 * M * (1 + P))
            log(f"K5 M={M} N={n_ref} band={band}: bound "
                f"{b['bound_ms'] * 1e3:.1f} us ({b['bound_by']})")
            r["max_abs_err"] = max(r["max_abs_err"], e)
            r[f"ms_{phase}_{n_ref}"] = ms_k
            r[f"plain_ms_{phase}_{n_ref}"] = plain
            r[f"bound_ms_{phase}_{n_ref}"] = b["bound_ms"]
            if (phase, n_ref) == ("fine", 131072):
                r.update(ms=ms_k, plain_ms=plain, **b)


def nn_api_scenes(torch) -> dict:
    """The public NN API's inputs on the card, at the repo's own drives of
    it: tools/nn_split_check.py's scene for `nn_payload_pallas` (8,192
    queries against 8,192 points of a 40 m room 25 m out, P = 8) and
    tools/banded_split_check.py's for the banded functions (8,192 readings
    of a 65,536-point 30 m room under a small motion), its reference
    prepared once by `banded_prepare`, with payload [x y z normal 0 0]."""
    from aicp_mapping_tpu_torch.geometry import se3
    from aicp_mapping_tpu_torch.ops import banded_nn
    from aicp_mapping_tpu_torch.tools.synthetic import room_cloud

    dev = "cuda"
    raw = torch.as_tensor(room_cloud(n=9000, size=40.0, seed=5, noise=0.01)
                          + np.float32(25.0), device=dev)
    ones = torch.ones(8192, dtype=torch.bool, device=dev)
    r = raw[200:8392].contiguous()
    tiled = (raw[:8192].contiguous(), ones, r, ones, torch.cat(
        [r, torch.zeros((8192, 5), device=dev)], 1).contiguous())
    world = torch.as_tensor(room_cloud(n=66000, size=30.0, seed=11,
                                       noise=0.01)[:65536], device=dev)
    nrm = np.random.default_rng(11).normal(size=(65536, 3))
    nrm = torch.as_tensor((nrm / np.linalg.norm(nrm, axis=1, keepdims=True))
                          .astype(np.float32), device=dev)
    pay = torch.cat([world, nrm, torch.zeros((65536, 2), device=dev)], 1)
    T = se3.make_transform(
        se3.so3_exp(torch.tensor([0.008, -0.012, 0.03], device=dev)),
        torch.tensor([0.09, -0.07, 0.04], device=dev))
    reading = se3.transform_points(T, world[::8][:8192]).contiguous()
    rm = torch.ones(65536, dtype=torch.bool, device=dev)
    origin = torch.minimum(reading.amin(0), world.amin(0))
    prep = banded_nn.banded_prepare(world, rm, origin, NN_API_CELL)
    qcodes, qperm = torch.sort(banded_nn.morton_codes(
        reading, ones, origin, NN_API_CELL), stable=True)
    pay_t = pay[prep[3]].T.contiguous()
    starts = {band: banded_nn.banded_window_starts(
        qcodes, prep[2], 64, band, 512, 1024) for band in (NN_API_BAND, 64)}
    rs = prep[0].T.contiguous()
    rpen = torch.where(prep[1][0] >= BIG, BIG, 0.0).contiguous()
    return dict(tiled=tiled, world=world, rm=rm, pay=pay, reading=reading,
                qm=ones, origin=origin, prep=prep, qperm=qperm,
                qs=reading[qperm].contiguous(), pay_t=pay_t,
                pay_s=pay_t.T.contiguous(), starts=starts, rs=rs, rpen=rpen,
                blocks=banded_nn.banded_blocks(prep[0], prep[1], pay_t))


def check_nn_api_kernels(torch, results: dict, s: dict) -> None:
    """Phase 3, the public NN API's shapes: K5's index mode against its
    plain twin at band 16 and 64 (every block) of 8,192 x 65,536, and the
    time of each public function beside its kernel and plain twin."""
    from aicp_mapping_tpu_torch.ops import banded_nn
    knn = importlib.import_module("aicp_mapping_tpu_torch.ops.knn")

    qs, rs, rpen = s["qs"], s["rs"], s["rpen"]
    M, N = qs.shape[0], rs.shape[0]
    r = results.setdefault("banded_nn_argmin", dict(max_abs_err=0.0))
    for band in (NN_API_BAND, 64):
        args = (qs, rs, rpen, s["starts"][band], band)
        d_k, i_k = banded_nn.banded_nn_argmin_kernel(*args)
        d_p, i_p = banded_nn.banded_nn_argmin(*args)
        torch.cuda.synchronize()
        frac = (i_k == i_p).float().mean().item()
        err = (d_k - d_p).abs().max().item()
        log(f"K5 index mode (#10) M={M} N={N} band={band}: identical "
            f"indices {frac:.5f}, max|dd2| {err:.3g} m^2")
        assert torch.equal(d_k, d_p) and torch.equal(i_k, i_p), (frac, err)
        assert bool((i_k >= 0).all())
        ms = time_ms(torch, lambda: banded_nn.banded_nn_argmin_kernel(*args))
        plain = time_ms(torch, lambda: banded_nn.banded_nn_argmin(*args))
        b = bound(OPS_PER_PAIR * window_pairs(s["qm"], rpen == 0,
                                              s["starts"][band], band),
                  12 * M + 16 * N + 4 * s["starts"][band].numel() + 12 * M)
        api = time_ms(torch, lambda: banded_nn.nn_argmin_banded_prepared(
            s["reading"], s["qm"], *s["prep"], s["origin"], NN_API_CELL,
            band=band))
        log(f"K5 index mode (#10) M={M} N={N} band={band}: kernel "
            f"{ms * 1e3:.1f} us "
            f"({grid(banded_nn.banded_split_plan(M, band), M)}), plain "
            f"{plain * 1e3:.1f} us, bound "
            f"{b['bound_ms'] * 1e3:.1f} us ({b['bound_by']}); "
            f"nn_argmin_banded_prepared {api * 1e3:.1f} us")
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r.update({f"ms_band{band}": ms, f"plain_ms_band{band}": plain,
                  f"bound_ms_band{band}": b["bound_ms"],
                  f"api_ms_band{band}": api})
        if band == NN_API_BAND:
            r.update(ms=ms, plain_ms=plain, **b)

    # #8: nn_payload_tiled_kernel is K1 plus a select
    t = s["tiled"]
    api = time_ms(torch, lambda: knn.nn_payload_tiled_kernel(*t))
    ms = time_ms(torch, lambda: knn.nn_payload_kernel(*t))
    plain = time_ms(torch, lambda: knn.nn_payload(*t))
    log(f"#8 nn_payload_tiled_kernel 8192x8192 P=8: {api * 1e3:.1f} us "
        f"(K1 {ms * 1e3:.1f} us, plain {plain * 1e3:.1f} us)")
    results["nn_payload"].update(api_ms_tiled=api, ms_nn_api=ms,
                                 plain_ms_nn_api=plain)

    # #9 and #11: K5's payload mode after a layout conversion
    args = (qs, rs, rpen, s["pay_s"], s["starts"][NN_API_BAND], NN_API_BAND)
    ms = time_ms(torch,
                 lambda: banded_nn.nn_payload_banded_stream_kernel(*args))
    plain = time_ms(torch, lambda: banded_nn.nn_payload_banded(*args))
    st = s["starts"][NN_API_BAND]
    srt = time_ms(torch, lambda: banded_nn.nn_payload_banded_sorted(
        qs, *s["prep"][:2], s["pay_t"], st, band=NN_API_BAND))
    res = time_ms(torch, lambda: banded_nn.nn_payload_banded_resident(
        qs, *s["blocks"], st, band=NN_API_BAND))
    log(f"#11 nn_payload_banded_sorted / #9 nn_payload_banded_resident "
        f"M={M} N={N} band={NN_API_BAND}: {srt * 1e3:.1f} / {res * 1e3:.1f}"
        f" us (K5 {ms * 1e3:.1f} us, plain {plain * 1e3:.1f} us)")
    results["banded_nn_payload_stream"].update(
        api_ms_sorted=srt, api_ms_resident=res, ms_nn_api=ms,
        plain_ms_nn_api=plain)


def check_tie_scenes(torch) -> None:
    """Phase 3, ties across splits: points on a small integer grid (every
    squared distance exact in any rounding, and many equal), each reference
    point stored twice, half a reference apart, and the reference's first
    slice masked. K1 (both modes) at 8,192 x 8,192, 1,024 x 8,192 and the
    SLAM path's 4,096 x 4,096, and K5
    (both modes) at the coarse phase's 1,024 x 65,536, band 64 (the whole
    reference), each equal to its plain twin: the lowest index wins every
    tie."""
    from aicp_mapping_tpu_torch.ops import banded_nn
    knn = importlib.import_module("aicp_mapping_tpu_torch.ops.knn")

    dev = "cuda"
    rng = np.random.default_rng(17)

    def points(n, cols=3, grid_step=True):
        a = (rng.integers(0, 12, (n, cols)) if grid_step
             else rng.normal(size=(n, cols)))
        return torch.as_tensor(a.astype(np.float32), device=dev)

    def equal(got, want):
        return all(torch.equal(a, b) for a, b in zip(got, want))

    for M, N, band in ((8192, 8192, 0), (1024, 8192, 0), (4096, 4096, 0),
                       (1024, 65536, 64)):
        half = points(N // 2)
        r = torch.cat([half, half]).contiguous()
        q = points(M)
        pay = torch.cat([r, points(N, 5, grid_step=False)], 1).contiguous()
        if band:
            plan = banded_nn.banded_split_plan(M, band)
            pen = torch.zeros(N, device=dev)
            pen[:plan.split_len] = BIG
            st = torch.zeros(M // 512, dtype=torch.int32, device=dev)
            got_i = banded_nn.banded_nn_argmin_kernel(q, r, pen, st, band)
            ok = (equal(got_i, banded_nn.banded_nn_argmin(q, r, pen, st,
                                                          band))
                  and equal(banded_nn.nn_payload_banded_stream_kernel(
                      q, r, pen, pay, st, band), banded_nn.nn_payload_banded(
                          q, r, pen, pay, st, band)))
            name = "K5"
        else:
            plan = knn.nn_split_plan(M, N)
            qm = torch.arange(M, device=dev) % 5 != 4
            rm = torch.arange(N, device=dev) >= plan.split_len
            got_i = knn.nn_argmin_kernel(q, qm, r, rm)
            ok = (equal(got_i, knn.nn_argmin(q, qm, r, rm))
                  and equal(knn.nn_payload_kernel(q, qm, r, rm, pay),
                            knn.nn_payload(q, qm, r, rm, pay)))
            name = "K1"
        first = (got_i[1] < N // 2).float().mean().item()
        log(f"{name} tie scene M={M} N={N}{f' band={band}' if band else ''} "
            f"({grid(plan, M)}): both modes equal to the twins: {ok}; "
            f"winners in the first copy (each tied with its twin point a "
            f"half reference on) {first:.4f}")
        assert ok, (name, M, N)


def run_nn_api(torch, s: dict) -> None:
    """The public NN API on the card, once per function, against the plain
    twins on the card: `nn_payload_tiled_kernel` (packed and not: both the
    exact distance) against `nn_payload`; `nn_argmin_banded_prepared` at
    band 16 (recall of the exact 1-NN, never nearer) and at every block
    (the exact 1-NN); `nn_payload_banded_sorted` and `_resident` (equal to
    each other, recall of the exact payload rows)."""
    from aicp_mapping_tpu_torch.ops import banded_nn
    knn = importlib.import_module("aicp_mapping_tpu_torch.ops.knn")

    t = s["tiled"]
    d_p, p_p = knn.nn_payload(*t)
    outs = [knn.nn_payload_tiled_kernel(*t, packed=p) for p in (True, False)]
    for (d, p), packed in zip(outs, (True, False)):
        torch.cuda.synchronize()
        assert d.shape == (8192,) and p.shape == (8192, 8)
        assert bool(torch.isfinite(d).all()) and bool((d < BIG).all())
        frac = (p == p_p).all(1).float().mean().item()
        err = (d - d_p).abs().max().item()
        log(f"nn api: nn_payload_tiled_kernel(packed={packed}) 8192x8192: "
            f"identical rows {frac:.5f}, max|dd2| {err:.3g} m^2, mean d2 "
            f"{d.mean().item():.4g} m^2")
        assert frac >= 0.997 and err <= 3e-3, (frac, err)
    assert all(torch.equal(a, b) for a, b in zip(*outs))

    reading, qm, world, rm = s["reading"], s["qm"], s["world"], s["rm"]
    d_x, i_x = knn.nn_argmin(reading, qm, world, rm)
    for band in (NN_API_BAND, 64):
        d, i = banded_nn.nn_argmin_banded_prepared(
            reading, qm, *s["prep"], s["origin"], NN_API_CELL, band=band)
        torch.cuda.synchronize()
        assert d.shape == (8192,) and i.dtype == torch.int64
        exact = (i == i_x).float().mean().item()
        log(f"nn api: nn_argmin_banded_prepared band={band} of 64: exact-NN "
            f"share {exact:.5f}, mean d2 {d.mean().item():.4g} m^2 (exact "
            f"{d_x.mean().item():.4g})")
        assert bool((d >= d_x - 1e-6).all()) and bool((d < BIG).all())
        assert exact >= (0.997 if band == 64 else 0.98), exact
        if band == 64:
            assert (d - d_x).abs().max().item() <= 3e-3

    st = s["starts"][NN_API_BAND]
    d_s, p_s = banded_nn.nn_payload_banded_sorted(
        s["qs"], *s["prep"][:2], s["pay_t"], st, band=NN_API_BAND)
    d_r, p_r = banded_nn.nn_payload_banded_resident(
        s["qs"], *s["blocks"], st, band=NN_API_BAND)
    torch.cuda.synchronize()
    assert torch.equal(d_s, d_r) and torch.equal(p_s, p_r)
    want = s["pay"][i_x[s["qperm"]]]
    exact = (p_s == want).all(1).float().mean().item()
    log(f"nn api: nn_payload_banded_sorted / _resident band={NN_API_BAND}: "
        f"equal; exact-NN share {exact:.5f}")
    assert exact >= 0.98, exact
    assert bool((d_s >= d_x[s["qperm"]] - 1e-6).all())


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
    for key, tol in TOL_RISK.items():
        if key not in want:
            continue
        if want[key] < 0:
            assert getattr(got, key) < 0, (what, key, got, want)
        else:
            assert abs(getattr(got, key) - want[key]) <= tol, (
                what, key, getattr(got, key), want[key])


def as_line(r) -> dict:
    return dict(accepted=r.accepted, registered=r.registered,
                filtered_size=r.filtered_size,
                octree_overlap=r.octree_overlap,
                fov_overlap=r.fov_overlap, alignability=r.alignability,
                risk=r.risk,
                correction_t=np.asarray(r.correction)[:3, 3].tolist(),
                corrected_t=np.asarray(r.corrected_pose)[:3, 3].tolist())


def record_steps(app) -> list:
    """Wrap `app`'s frame step to keep each call's arguments and output."""
    calls, step = [], app._app_step

    def recording(*args):
        out = step(*args)
        calls.append((args, out))
        return out

    app._app_step = recording
    return calls


def risk_stage_agrees(torch, cfg, call, what: str) -> None:
    """The card's risk stage against the CPU's on the same inputs: that
    frame's reference and filtered reading, copied to the CPU."""
    from aicp_mapping_tpu_torch.classification import SVMModel
    from aicp_mapping_tpu_torch.pipeline.fused import risk_stage

    args, out = call
    cpu = [a.cpu() if isinstance(a, torch.Tensor) else a for a in args]
    debug = cfg.working_mode != "robot"
    read_pose = cpu[3] @ cpu[2] if debug else cpu[2]
    model = SVMModel(*cpu[10:14]) if len(cpu) > 10 else None
    fov, align, risk, ok = risk_stage(
        cfg, cpu[4], cpu[6], cpu[7], out.filtered_points.cpu(),
        out.filtered_mask.cpu(), read_pose, out.overlap_percent.cpu(), model)
    got = dict(fov_overlap=float(out.fov_overlap),
               alignability=float(out.alignability), risk=float(out.risk))
    want = dict(fov_overlap=float(fov), alignability=float(align),
                risk=float(risk))
    for key, tol in TOL_RISK.items():
        assert abs(got[key] - want[key]) <= tol, (what, key, got, want)
    assert bool(out.risk_ok) == bool(ok), (what, got, want)


def run_bench_slice(torch, risk: bool = False, wire: bool = False) -> float:
    """Phase 4: the frame path at the benchmark's operating point on the
    card, each frame checked against the CPU App started from the card
    App's state; with `risk`, failure prediction on (the shipped
    classifier) and the card's risk stage also checked against the CPU's
    on the same inputs; with `wire`, the stream cell's wire format (host
    voxel grid, int16 upload, async finalize), each frame's cloud uploaded
    to both devices and dequantized there to the same bits. Returns the
    steady ms/frame."""
    from aicp_mapping_tpu_torch import AlignedCloud, App, Cloud, _kernels
    from aicp_mapping_tpu_torch.convert import (app_state_from_numpy,
                                                app_state_to_numpy)
    from aicp_mapping_tpu_torch.ops import segmentation
    from aicp_mapping_tpu_torch.pipeline.sequence import (synthetic_sequence,
                                                          wire_cloud)

    cfg = stream_config() if wire else bench_config()
    if risk:
        cfg.failure_prediction_mode = True
        cfg.classifier_path = CLASSIFIER
    name = ("bench slice with failure prediction" if risk else
            "bench slice on the wire" if wire else "bench slice")
    items, _ = synthetic_sequence(n_frames=6, **SCAN_ARGS)
    gpu, cpu = App(cfg, device="cuda"), App(cfg, device="cpu")
    calls = record_steps(gpu)
    gpu_ms, cpu_s = [], []
    for i, (utime, pts, pose) in enumerate(items):
        if i > 0:
            app_state_from_numpy(cpu, **app_state_to_numpy(gpu))
        if wire:
            cloud_g = wire_cloud(cfg, pts, device="cuda")
            cloud_c = wire_cloud(cfg, pts, device="cpu")
            assert cloud_g.pre_voxelized and cloud_c.pre_voxelized
            assert torch.equal(cloud_g.points.cpu(), cloud_c.points), i
            assert torch.equal(cloud_g.mask.cpu(), cloud_c.mask), i
        else:
            cloud_g = cloud_c = Cloud.from_numpy(pts,
                                                 capacity=cfg.raw_capacity)
        before = sum(_kernels.launch_counts().values())
        segmentation.reset_propagation_rounds()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rg = gpu.process_cloud(AlignedCloud.create(utime, cloud_g, pose))
        torch.cuda.synchronize()
        gpu_ms.append((time.perf_counter() - t0) * 1e3)
        launches = sum(_kernels.launch_counts().values()) - before
        rounds = segmentation.propagation_rounds()["rounds"]
        t0 = time.perf_counter()
        rc = cpu.process_cloud(AlignedCloud.create(utime, cloud_c, pose))
        cpu_s.append(time.perf_counter() - t0)
        log(f"{name} frame {i}: card {gpu_ms[-1]:.1f} ms, overlap "
            f"{rg.octree_overlap:.3f} (cpu {rc.octree_overlap:.3f}), fov "
            f"{rg.fov_overlap:.3f} (cpu {rc.fov_overlap:.3f}), alignability "
            f"{rg.alignability:.3f} (cpu {rc.alignability:.3f}), risk "
            f"{rg.risk:.4f} (cpu {rc.risk:.4f}), iters {rg.n_iterations} "
            f"(cpu {rc.n_iterations}), filtered {rg.filtered_size} (cpu "
            f"{rc.filtered_size}), correction_t "
            f"{np.round(rg.correction[:3, 3], 4).tolist()} (cpu "
            f"{np.round(rc.correction[:3, 3], 4).tolist()}); port kernel "
            f"launches {launches}, label-propagation rounds {rounds}")
        assert rg.reference_id == rc.reference_id, (i, rg, rc)
        # A risk within the tolerance of the threshold on both sides may
        # gate on one and not the other; then only the risk stage compares.
        marginal = (risk and rg.registered != rc.registered
                    and max(abs(rg.risk - cfg.risk_threshold),
                            abs(rc.risk - cfg.risk_threshold))
                    <= TOL_RISK["risk"])
        if marginal:
            log(f"{name} frame {i}: risk at the threshold, gated on one "
                "side only")
            want = as_line(rc)
            for key, tol in TOL_RISK.items():
                assert abs(getattr(rg, key) - want[key]) <= tol, (i, key)
        else:
            frame_lines_agree(rg, as_line(rc), f"{name} frame {i}")
        if risk and i > 0:
            risk_stage_agrees(torch, cfg, calls[-1], f"{name} frame {i}")
            assert 0.0 <= rg.risk <= 1.0 and rounds > 0, rg
    gpu.close()
    cpu.close()
    if risk:
        assert any(r.registered for r in gpu.frames[1:]), gpu.frames
    else:
        assert all(r.registered for r in gpu.frames[1:]), gpu.frames
    steady = gpu_ms[2:]
    log(f"{name} on the card: {np.mean(steady):.2f} ms/frame "
        f"(mean of frames 2-{len(gpu_ms) - 1}, after the bootstrap and one "
        f"warm-up frame; min {min(steady):.2f}, max {max(steady):.2f}); "
        f"CPU App {np.mean(cpu_s[2:]):.2f} s/frame")
    return float(np.mean(steady))


def run_icp_graph(torch) -> dict:
    """The "ICP graph" phase, at the benchmark's operating point: (1) an
    App on the card over ICP_GRAPH_FRAMES bench frames from an empty cache
    of captured solves: two captures (the coarse 1,024 x 8,192 and fine
    8,192 x 8,192 keys) in the frames before ICP_GRAPH_WARM, then every
    ICP iteration a replay and none eager; (2) each later frame's ICP call
    again, by the graph path and by the eager loop (`capture_plan` forced
    off), for T, n_iterations and the hessian: bitwise, else the largest
    gap reported, where T's is the widest gap between where the two
    corrections put a filtered point, held to the benchmark's `corr_gap_m`
    limit; K1's launches equal on both paths; each path's synchronised host
    ms a call; (3) one graph call under `torch.profiler`: K1's scan and
    merge seen inside the replays. Returns the timings."""
    from aicp_mapping_tpu_torch import AlignedCloud, App, Cloud, _kernels
    from aicp_mapping_tpu_torch.pipeline import fused
    from aicp_mapping_tpu_torch.pipeline.sequence import synthetic_sequence
    from aicp_mapping_tpu_torch.registration import icp

    cfg = bench_config()
    items, _ = synthetic_sequence(n_frames=ICP_GRAPH_FRAMES, **SCAN_ARGS)
    icp._graphs.clear()
    icp.reset_graph_counts()
    calls = []
    solve = fused.point_to_plane_icp

    def recording(*args):
        res = solve(*args)
        calls.append(([a.clone() if isinstance(a, torch.Tensor) else a
                       for a in args], res))
        return res

    app = App(cfg, device="cuda")
    fused.point_to_plane_icp = recording
    try:
        for i, (utime, pts, pose) in enumerate(items):
            if i == ICP_GRAPH_WARM:
                warm, first = icp.graph_counts(), len(calls)
                icp.reset_graph_counts()
            app.process_cloud(AlignedCloud.create(
                utime, Cloud.from_numpy(pts, capacity=cfg.raw_capacity),
                pose))
    finally:
        fused.point_to_plane_icp = solve
    app.close()
    after = icp.graph_counts()
    iters = sum(res.n_iterations for _, res in calls[first:])
    log(f"ICP graph, App over {len(items)} bench frames: before frame "
        f"{ICP_GRAPH_WARM} {warm}, after it {after} ({iters} ICP "
        f"iterations in {len(calls) - first} calls); keys "
        f"{[(k[4][0][0][0], k[0].max_iterations) for k in icp._graphs]}")
    assert warm["captures"] == 2 and after["captures"] == 0, (warm, after)
    assert after["eager_iterations"] == 0, after
    assert after["replays"] == iters > 0, (after, iters)

    real_plan = icp.capture_plan

    def run(args, graph: bool):
        icp.capture_plan = real_plan if graph else (lambda *a, **k: False)
        try:
            before = _kernels.launch_counts()["nn_payload"]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = icp.point_to_plane_icp(*args)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            return res, ms, _kernels.launch_counts()["nn_payload"] - before
        finally:
            icp.capture_plan = real_plan

    ms = {True: [], False: []}
    worst_m, worst_h, bitwise = 0.0, 0.0, True
    for n, (args, in_app) in enumerate(calls[first:]):
        got = {}
        for graph in (True, False, False, True):
            res, t, k1 = run(args, graph)
            ms[graph].append(t)
            got[graph] = (res, k1)
        (g, k1_g), (e, k1_e) = got[True], got[False]
        assert g.n_iterations == e.n_iterations == in_app.n_iterations, n
        assert k1_g == k1_e == g.n_iterations, (n, k1_g, k1_e)
        pts, mask = args[0], args[1]
        gap = (pts @ (g.T - e.T)[:3, :3].T + (g.T - e.T)[:3, 3]).norm(dim=1)
        worst_m = max(worst_m, float(gap[mask].max()))
        worst_h = max(worst_h, float(((g.hessian - e.hessian).abs().max())
                                     / e.hessian.abs().max()))
        same = (torch.equal(g.T, e.T) and torch.equal(g.hessian, e.hessian)
                and torch.equal(g.T, in_app.T))
        bitwise = bitwise and same
    log(f"ICP graph against the eager loop ({gpu_line()}): "
        f"{len(calls) - first} calls, bitwise {bitwise}; widest gap of a "
        f"filtered point {worst_m:.3g} m, hessian {worst_h:.3g} of its "
        f"largest entry; host ms a call (synchronised) graph median "
        f"{np.median(ms[True]):.3f} (min {min(ms[True]):.3f}), eager median "
        f"{np.median(ms[False]):.3f} (min {min(ms[False]):.3f})")
    assert worst_m <= CORR_GAP_M, worst_m

    args = calls[-1][0]
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        res = icp.point_to_plane_icp(*args)
        torch.cuda.synchronize()
    names = collections.Counter(
        e.name for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA)
    scans = sum(v for k, v in names.items() if "nn_scan_kernel" in k)
    merges = sum(v for k, v in names.items() if "merge_kernel" in k)
    log(f"ICP graph under the profiler: {res.n_iterations} iterations, "
        f"{scans} K1 scans and {merges} merges seen, "
        f"{sum(names.values())} device events")
    assert scans == merges == res.n_iterations, (names, res.n_iterations)
    return {"graph_ms": float(np.median(ms[True])),
            "eager_ms": float(np.median(ms[False]))}


def worst(got, want) -> dict:
    """The largest differences between two runs' frames."""
    def most(f):
        return max((f(g, w) for g, w in zip(got, want)), default=0.0)

    return dict(
        correction_t=most(lambda g, w: float(np.abs(
            g.correction[:3, 3] - w.correction[:3, 3]).max())),
        corrected_t=most(lambda g, w: float(np.abs(
            g.corrected_pose[:3, 3] - w.corrected_pose[:3, 3]).max())),
        octree_overlap=most(lambda g, w: abs(g.octree_overlap
                                             - w.octree_overlap)),
        filtered_size=most(lambda g, w: abs(g.filtered_size
                                            - w.filtered_size)))


def run_stream(torch) -> dict:
    """The "stream" phase: the streaming front-end at bench.py's own
    operating point (`stream_config()`: depth 32, the host voxel
    grid at 0.08 m with the int16 upload, async finalize) on bench.py's
    40-frame sequence, driven as `bench.py:bench_app` drives the JAX App:
    `SequenceRunner(pipelined=True).run_clouds` over frames 0-1, then 2-39
    in upload batches of 16 (the warm-up pass), then 3 timed passes over
    frames 2-39 on the same App. The clouds the App received from the
    preparation thread (one pinned, non-blocking copy per batch) must be
    the bits of a synchronous upload. The warm-up pass's 40 frames must
    agree (gates and reference ids equal, the rest within the golden
    tolerances) with the same pipeline finalizing on its dispatch thread,
    and with a synchronous App of the same wire config up to the first
    rejected frame; then the bench slice's card-vs-CPU check on 6 wire
    frames (`run_bench_slice(wire=True)`), and a `StreamingDriver` drive on
    the card. Returns the numbers it prints."""
    from aicp_mapping_tpu_torch import AlignedCloud, App, _kernels
    from aicp_mapping_tpu_torch.native import voxel_downsample_q16
    from aicp_mapping_tpu_torch.pipeline.sequence import (SequenceRunner,
                                                          synthetic_sequence,
                                                          wire_cloud)

    cfg = stream_config()
    batch = cfg.pipeline_depth // 2
    items, gts = synthetic_sequence(n_frames=STREAM_FRAMES, **SCAN_ARGS)
    smi = gpu_line()
    t0 = time.perf_counter()
    for _, pts, _ in items:
        voxel_downsample_q16(pts, cfg.wire_voxel, cfg.downsample_capacity)
    prep_ms = (time.perf_counter() - t0) * 1e3 / len(items)

    app = App(cfg, device="cuda")
    received, submit = [], app.submit_cloud

    def recording(cloud):
        received.append(cloud.cloud)
        return submit(cloud)

    app.submit_cloud = recording
    runner = SequenceRunner(app, pipelined=True)
    n = len(items) - 2
    try:
        piped = runner.run_clouds(items[:2])
        piped += runner.run_clouds(items[2:], batch_h2d=batch)
        app.submit_cloud = submit
        before = _kernels.launch_counts()
        rates = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runner.run_clouds(items[2:], batch_h2d=batch)
            torch.cuda.synchronize()
            rates.append(n / (time.perf_counter() - t0))
        launches = {k: (v - before[k]) / (3 * n)
                    for k, v in _kernels.launch_counts().items()}
    finally:
        app.close()
    assert [r.utime for r in piped] == [it[0] for it in items], piped
    for (utime, pts, _), got in zip(items, received):
        want = wire_cloud(cfg, pts, device="cuda")
        assert got.pre_voxelized and torch.equal(got.mask, want.mask), utime
        assert torch.equal(got.points, want.points), utime

    # the same pipeline with finalize on the dispatch thread: the same
    # frames (which frame's finalize lands before which dispatch decides
    # nothing here, as every window of 16 frames adopts a new reference)
    inline = App(dataclasses.replace(cfg, async_finalize=False),
                 device="cuda")
    runner = SequenceRunner(inline, pipelined=True)
    inline_res = runner.run_clouds(items[:2])
    inline_res += runner.run_clouds(items[2:], batch_h2d=batch)
    for i, (p, r) in enumerate(zip(piped, inline_res)):
        assert (p.accepted, p.registered, p.reference_id) == \
            (r.accepted, r.registered, r.reference_id), (i, p, r)
        frame_lines_agree(p, as_line(r), f"stream frame {i}, inline")
    log(f"stream: async vs inline finalize at depth {cfg.pipeline_depth}, "
        f"largest differences over {len(items)} frames: "
        f"{json.dumps(worst(piped, inline_res))}")

    # the synchronous App: the same frames up to the first rejection; after
    # it the pipeline registers against its speculative references (the
    # JAX package's pipelined semantics) and the two runs part
    sync = App(dataclasses.replace(cfg, async_finalize=False), device="cuda")
    sync_res, sync_ms = [], []
    for utime, pts, pose in items:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sync_res.append(sync.process_cloud(AlignedCloud.create(
            utime, wire_cloud(cfg, pts, device="cuda"), pose)))
        torch.cuda.synchronize()
        sync_ms.append((time.perf_counter() - t0) * 1e3)
    first_reject = next((i for i, r in enumerate(sync_res)
                         if not r.accepted), len(items) - 1)
    for i, (p, r) in enumerate(zip(piped[:first_reject + 1], sync_res)):
        assert (p.accepted, p.registered, p.reference_id) == \
            (r.accepted, r.registered, r.reference_id), (i, p, r)
        frame_lines_agree(p, as_line(r), f"stream frame {i}, synchronous")
    assert sum(r.registered for r in piped) >= len(items) // 2, piped
    log(f"stream: pipelined vs synchronous App on the card agree on frames "
        f"0-{first_reject} (the synchronous App's first rejection is frame "
        f"{first_reject}, if any); largest differences "
        f"there {json.dumps(worst(piped[:first_reject + 1], sync_res))}, "
        f"over all {len(items)} frames "
        f"{json.dumps(worst(piped, sync_res))}; pipelined accepted "
        f"{sum(r.accepted for r in piped)}, registered "
        f"{sum(r.registered for r in piped)}; synchronous accepted "
        f"{sum(r.accepted for r in sync_res)}, registered "
        f"{sum(r.registered for r in sync_res)}")

    wire_ms = run_bench_slice(torch, wire=True)
    driven = drive_stream(torch, cfg, items, gts)
    out = dict(scans_per_s=float(np.median(rates)), passes=rates,
               sync_ms=float(np.mean(sync_ms[2:])), prep_ms=prep_ms,
               wire_slice_ms=wire_ms, driver_frames=driven,
               launches_per_frame={k: v for k, v in launches.items() if v})
    log(f"stream cell on the card ({smi}): pipelined "
        f"{out['scans_per_s']:.2f} scans/s (median of 3 passes over "
        f"{n} frames: {', '.join(f'{r:.2f}' for r in rates)}); synchronous "
        f"{out['sync_ms']:.2f} ms/frame (frames 2-{len(items) - 1}, upload "
        f"included); wire preparation {prep_ms:.2f} ms per cloud on the "
        f"host; port kernel launches per frame "
        f"{json.dumps(out['launches_per_frame'])}")
    return out


def drive_stream(torch, cfg, items, gts) -> int:
    """A `StreamingDriver` on the card over the stream cell's App (its
    worker pipelined, `debug_dir` set, so the finalizer thread also reads
    clouds back for the dumps): the first 8 frames as sensor-frame scans,
    one scan a cloud; the corrected pose tracks the ground truth."""
    import tempfile

    from aicp_mapping_tpu_torch import App
    from aicp_mapping_tpu_torch.pipeline.stream import StreamingDriver

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as d:
        app = App(dataclasses.replace(cfg, debug_dir=d), device="cuda")
        results, poses = [], []
        drv = StreamingDriver(app, batch_size=1, max_range=100.0,
                              motion_gate_translation=0.5, pipelined=True,
                              pose_callback=lambda t, T: poses.append(T),
                              result_callback=results.append)
        drv.run()
        try:
            for utime, pts, odom in items[:8]:
                drv.on_pose(utime, odom)
                drv.on_scan(utime, sensor_frame(pts, odom))
                drv.flush()
        finally:
            drv.stop()
            app.close()
        dumps = sorted(os.listdir(d))
    err = float(np.linalg.norm(app.correct_pose(items[7][2])[:3, 3]
                               - gts[7][:3, 3]))
    log(f"stream: StreamingDriver on the card, {len(results)} clouds "
        f"registered of 8 scans ({drv.n_dropped} dropped), {len(poses)} "
        f"poses published, final position error {err:.3f} m; debug dumps "
        f"{dumps}")
    assert drv.n_processed == len(results) >= 3, results
    assert all(np.isfinite(r.corrected_pose).all() for r in results)
    assert len(poses) == 8 and err < 0.5, err
    # one prefiltered dump per frame after the bootstrap, one aligned per
    # registered frame kept
    aligned = sum(r.accepted and r.registered for r in results)
    assert len(dumps) == (len(results) - 1) + aligned, dumps
    return len(results)


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


def run_golden_risk(torch) -> None:
    """The golden risk-gated scenario (tests/test_golden.py::_run_risk_gated:
    a degenerate corridor scan replaces frame 4) with the shipped
    classifier on the card: each frame against the CPU App started from
    the card App's state and the card's risk stage against the CPU's on the
    same inputs; every frame the golden file gates is gated, and a gated
    frame becomes the next frame's reference."""
    from aicp_mapping_tpu_torch import (AlignedCloud, App, Cloud,
                                        PipelineConfig)
    from aicp_mapping_tpu_torch.convert import (app_state_from_numpy,
                                                app_state_to_numpy)
    from aicp_mapping_tpu_torch.pipeline.sequence import synthetic_sequence
    from aicp_mapping_tpu_torch.tools.synthetic import corridor_cloud

    with open(os.path.join(ROOT, "tests", "golden",
                           "pipeline_golden.json")) as f:
        golden = json.load(f)["risk_gated"]
    cfg = PipelineConfig(raw_capacity=8192, downsample_capacity=4096,
                         filtered_capacity=2048, min_cluster_size=20,
                         failure_prediction_mode=True,
                         align_ds_capacity=1024, align_max_clusters=8,
                         classifier_path=CLASSIFIER)
    items, _ = synthetic_sequence(n_frames=7, n_points=5000, seed=11)
    bad = corridor_cloud(n=5000, seed=3, noise=0.01) + np.float32(
        [60.0, 60.0, 0.0])
    items[4] = (items[4][0], bad.astype(np.float32), items[4][2])
    gpu, cpu = App(cfg, device="cuda"), App(cfg, device="cpu")
    calls = record_steps(gpu)
    got = []
    for i, ((utime, pts, pose), want) in enumerate(zip(items, golden)):
        if i > 0:
            app_state_from_numpy(cpu, **app_state_to_numpy(gpu))
        cloud = Cloud.from_numpy(pts, capacity=cfg.raw_capacity)
        rg = gpu.process_cloud(AlignedCloud.create(utime, cloud, pose))
        rc = cpu.process_cloud(AlignedCloud.create(utime, cloud, pose))
        log(f"golden risk frame {i}: registered {rg.registered} (cpu "
            f"{rc.registered}, golden {want['registered']}), overlap "
            f"{rg.octree_overlap:.3f} (golden {want['octree_overlap']}), fov "
            f"{rg.fov_overlap:.3f} ({want['fov_overlap']}), alignability "
            f"{rg.alignability:.4f} (cpu {rc.alignability:.4f}, golden "
            f"{want['alignability']}), risk {rg.risk:.4f} (cpu "
            f"{rc.risk:.4f}, golden {want['risk']})")
        assert (rg.reading_id, rg.reference_id) == (rc.reading_id,
                                                    rc.reference_id), i
        assert rg.reading_id == want["reading_id"], (i, rg)
        frame_lines_agree(rg, as_line(rc), f"golden risk frame {i}")
        if i > 0:
            risk_stage_agrees(torch, cfg, calls[-1], f"golden risk frame {i}")
        assert rg.accepted, rg
        if not want["registered"]:
            assert not rg.registered, (i, rg)
        got.append(rg)
    for i, r in enumerate(got[:-1]):
        if not r.registered:
            assert np.allclose(r.correction[:3, 3], 0.0), r
            assert got[i + 1].reference_id == i, (i, got[i + 1])
    assert got[4].octree_overlap == 0.0 and got[4].risk > 0.99, got[4]
    log(f"golden risk scenario on the card: {len(got)} frames agree with "
        f"the CPU App; gated frames {[r.reading_id for r in got[1:] if not r.registered]}"
        f" (golden: {[w['reading_id'] for w in golden[1:] if not w['registered']]})")


def register(argv) -> dict:
    """`python -m aicp_mapping_tpu_torch register ...` in this process;
    returns its JSON."""
    import contextlib
    import io

    from aicp_mapping_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(["register", *argv]) == 0
    return json.loads(buf.getvalue())


def run_register(torch) -> None:
    """The pair-registration CLI on the card: a 60,000-point pair (capacity
    65,536, so ICP takes K5 by shape and the Hausdorff check runs K1's index
    mode at 65,536 x 65,536) with a known perturbation of 8 cm and 1.5
    degrees about the sensor, which the correction must undo (2 cm, 0.5
    degrees), and whose Hausdorff distance must equal the plain twin's on
    the card; then an 8,192-point pair, field by field against the same
    command on the CPU."""
    import tempfile

    from aicp_mapping_tpu_torch import Cloud
    from aicp_mapping_tpu_torch.io import write_pcd
    knn = importlib.import_module("aicp_mapping_tpu_torch.ops.knn")
    from aicp_mapping_tpu_torch.ops.quantile import masked_quantile

    center = np.float32([45.0, -38.0, 1.5])
    yaw = np.deg2rad(1.5)
    P = np.eye(4, dtype=np.float32)
    P[:2, :2] = [[np.cos(yaw), -np.sin(yaw)], [np.sin(yaw), np.cos(yaw)]]
    P[:3, 3] = center - P[:3, :3] @ center + np.float32([0.08, -0.05, 0.02])
    vp = (*center.tolist(), 1.0, 0.0, 0.0, 0.0)
    ref = lidar_room(60000, seed=21)
    read = (lidar_room(60000, seed=22) @ P[:3, :3].T + P[:3, 3]).astype(
        np.float32)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as d:
        paths = [os.path.join(d, f) for f in ("read.pcd", "ref.pcd")]
        write_pcd(paths[0], read, viewpoint=vp)
        write_pcd(paths[1], ref, viewpoint=vp)
        argv = [*paths, "--classifier", CLASSIFIER]
        register(argv)                      # warm-up: first-use costs
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = register(argv)
        wall = time.perf_counter() - t0
        T = np.asarray(out["correction"], np.float32)
        E = T @ P.astype(np.float64)
        dr = np.rad2deg(np.arccos(np.clip((np.trace(E[:3, :3]) - 1) / 2,
                                          -1, 1)))
        dt = np.linalg.norm(E[:3, :3] @ center + E[:3, 3] - center)
        # the Hausdorff distance by the plain twin on the card
        dev = "cuda"
        a = Cloud.from_numpy(read, capacity=65536, device=dev).transform(
            torch.as_tensor(T, device=dev))
        b = Cloud.from_numpy(ref, capacity=65536, device=dev)
        d_ab = knn.nn_argmin(a.points, a.mask, b.points, b.mask)[0]
        d_ba = knn.nn_argmin(b.points, b.mask, a.points, a.mask)[0]
        plain = max(float(masked_quantile(d_ab, a.mask, 1.0)),
                    float(masked_quantile(d_ba, b.mask, 1.0))) ** 0.5
        log(f"register 60,000-point pair on the card: {wall:.2f} s; "
            f"overlap {out['overlap_percent']:.3f}, fov "
            f"{out['fov_overlap']:.3f}, alignability "
            f"{out['alignability']:.3f}, risk {out['risk']:.4f}, trim "
            f"{out['trim_ratio']:.3f}, iterations {out['n_iterations']}, "
            f"residual at the sensor {dt * 100:.2f} cm / {dr:.4f} deg, "
            f"Hausdorff {out['hausdorff']:.5f} m (plain twin {plain:.5f})")
        assert dt < 0.02 and dr < 0.5, (dt, dr)
        assert abs(out["hausdorff"] - plain) <= 1e-5, (out, plain)

        pick = np.sort(np.random.default_rng(0).choice(60000, 8192,
                                                       replace=False))
        write_pcd(paths[0], read[pick], viewpoint=vp)
        write_pcd(paths[1], ref[pick], viewpoint=vp)
        got = register(argv)
        want = register(argv + ["--device", "cpu"])
    log(f"register 8,192-point pair: card {json.dumps(got)}; cpu "
        f"{json.dumps(want)}")
    for key, tol in (("overlap_percent", TOL_OVERLAP), ("hausdorff", 0.02),
                     *TOL_RISK.items()):
        assert abs(got[key] - want[key]) <= tol, (key, got, want)
    np.testing.assert_allclose(np.asarray(got["correction"])[:3, 3],
                               np.asarray(want["correction"])[:3, 3],
                               atol=TOL_CORRECTION_T)


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
    cfg = bench_config()
    plan = solver_plan(cfg.icp, cfg.filtered_capacity, out_capacity, "cuda")
    assert plan == {"nn": "banded", "coarse": True}, plan
    kw = dict(pipeline_config=cfg, crop_radius=CROP_RADIUS,
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
        local = sensor_frame(pts, odom)
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
    return {"load_ms": load_ms, "frame_ms": float(np.mean(gpu_ms[1:]))}


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


def near_gate(m, lc, pre: np.ndarray, post: np.ndarray,
              consistency_reject_t: float = 0.15) -> bool:
    """Whether loop closure `lc` of mapper `m` sits within rounding of one
    of the gates that accept it: inlier rms, the seam bounds on the prior's
    correction (`pre`: the keyframe poses it was proposed at), the post-fit
    overlap, or the consistency test at the optimized poses `post`. Two
    implementations may disagree on such a closure."""
    Z0 = np.linalg.inv(pre[lc.i]) @ pre[lc.j]
    D = np.linalg.inv(Z0) @ lc.measurement
    ang = np.rad2deg(np.arccos(np.clip((np.trace(D[:3, :3]) - 1) / 2, -1, 1)))
    r = np.linalg.inv(lc.measurement) @ np.linalg.inv(post[lc.i]) @ post[lc.j]
    return (abs(lc.inlier_rms - m.closure_rms) < 0.01
            or abs(np.linalg.norm(D[:3, 3]) - m.max_seam_t) < 0.02
            or abs(ang - m.max_seam_rot_deg) < 0.2
            or abs(lc.overlap - m.min_loop_overlap) < 1.0
            or abs(np.linalg.norm(r[:3, 3]) - consistency_reject_t) < 0.02)


def check_slam_accuracy(out: dict, margins: bool = True) -> None:
    """tests/test_slam_accuracy.py's assertions on a `run_backend` record.
    With `margins=False` the two back-end margins (post-PGO ATE < 0.5 x the
    front-end's, post-BA <= 1.03 x post-PGO) are printed, not asserted:
    on the card's seed-0 keyframes the JAX package's own back-end misses
    them too, on the keyframes as they are and on copies moved by one ulp
    (`tests/test_torch_slam_replay.py`, PERF.md)."""
    assert out["frames_accepted"] == 34, out
    assert out["frames_registered"] < out["frames_accepted"], out
    assert out["n_loop_closures"] >= 3, out
    pre_gap = sum(1 for f in out["keyframe_frames"] if f < 14)
    assert any(i < pre_gap <= j for i, j in out["closure_spans"]), out
    assert out["ate_frontend_m"] > 0.3, out
    assert out["plane_ba_ran"], out
    pgo = out["ate_post_pgo_m"] / out["ate_frontend_m"]
    ba = out["ate_post_ba_m"] / out["ate_post_pgo_m"]
    log(f"slam margins, seed {out['seed']}: post-PGO / front-end ATE "
        f"{pgo:.3f} (< 0.5 in tests/test_slam_accuracy.py); post-BA / "
        f"post-PGO {ba:.3f} (<= 1.03){'' if margins else ' (printed)'}")
    if margins:
        assert pgo < 0.5 and ba <= 1.03, out


def run_slam(torch) -> None:
    """The SLAM path on the card: `eval.slam_accuracy`'s urban drive at seed
    0 (44 frames, 34 delivered; region growing at 16,384 raw / 8,192 voxels
    / 4,096 filtered / 65,536 map points) through `frontend_on` (the App and
    SequenceRunner, as `run_frontend` drives them) and `run_backend` (two
    rounds of closure proposal + PGO, then plane BA), i.e.
    `run_slam_accuracy(seed=0, device="cuda")` with its stages timed, held
    to `check_slam_accuracy` but its margins; then
    `run_slam_accuracy(seed=3 and 7, device="cuda")`, held to all of it.
    One frame's prefilter must keep the CPU's points. From the card's
    seed-0 keyframes the CPU runs the same back-end: the same closures
    proposed and kept in each round (a pair at a gate edge is printed, not
    failed), their measurements within 2 cm / 0.5 deg, post-PGO and
    post-BA ATE within 1 cm (with a gate-edge pair: the ATE of a PGO over
    the closures both kept, each device's measurements, from the card's
    second-round poses). The CPU solves each of the card's PGO graphs to
    the card's poses within 1 mm; two card solves of a graph give the same
    bits."""
    import tempfile

    from aicp_mapping_tpu_torch import App, Cloud, _kernels, convert
    from aicp_mapping_tpu_torch.eval import slam_accuracy as sa
    from aicp_mapping_tpu_torch.ops import segmentation
    from aicp_mapping_tpu_torch.pipeline import mapper
    ba = importlib.import_module("aicp_mapping_tpu_torch.parallel.ba")
    pg = importlib.import_module("aicp_mapping_tpu_torch.parallel.posegraph")

    t0 = time.perf_counter()
    items, gt, meta = sa.urban_drive(seed=0)
    host_s = time.perf_counter() - t0
    segmentation.reset_propagation_rounds()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    app, gt, meta = sa.frontend_on(items, gt, meta)
    torch.cuda.synchronize()
    front_s = time.perf_counter() - t0
    rounds = segmentation.propagation_rounds()["rounds"]
    log(f"slam front-end on the card: {len(items)} frames in {front_s:.2f} s"
        f" ({front_s / len(items) * 1e3:.1f} ms/frame; {rounds} "
        f"label-propagation rounds), the drive made on the host in "
        f"{host_s:.1f} s")
    # one frame's voxel + region-growing prefilter, card against CPU
    cpu_app = App(sa.scenario_config(), device="cpu")
    _, pts, pose = items[5]
    cap = app.cfg.raw_capacity
    card = app.filter_cloud(Cloud.from_numpy(pts, cap, "cuda"), pose[:3, 3])
    cpu = cpu_app.filter_cloud(Cloud.from_numpy(pts, cap), pose[:3, 3])
    log(f"slam prefilter of frame 5: card keeps {int(card.mask.sum())}, CPU "
        f"{int(cpu.mask.sum())} points")
    assert torch.equal(card.mask.cpu(), cpu.mask)
    assert torch.equal(card.points.cpu(), cpu.points)

    stages, solves = [], []
    Mapper = mapper.PoseGraphMapper

    def timed(fn, sink, **tags):
        def run(*args, **kwargs):
            before = {**mapper.backend_counts(), **_kernels.launch_counts()}
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            after = {**mapper.backend_counts(), **_kernels.launch_counts()}
            kept = (list(args[0].loop_closures)
                    if tags["stage"] == "optimize" else None)
            sink.append(dict(tags, s=time.perf_counter() - t, out=out,
                             args=args, kept=kept,
                             **{k: after[k] - before[k] for k in after}))
            return out
        return run

    saved = [(Mapper, n, getattr(Mapper, n)) for n in (
        "propose_loop_closures", "optimize", "run_plane_ba")]
    saved += [(mapper, "optimize_pose_graph", mapper.optimize_pose_graph),
              (ba, "optimize_plane_ba", ba.optimize_plane_ba)]
    for obj, name, fn in saved:
        setattr(obj, name, timed(fn, solves if obj is not Mapper else stages,
                                 stage=name))
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as d:
        snap = os.path.join(d, "frontend.npz")
        sa.save_frontend_snapshot(app, gt, meta, snap)
        kfs = Mapper(app).keyframes()
        pre = np.stack([k.pose for k in kfs])
        utimes = [k.utime for k in kfs]
        try:
            t0 = time.perf_counter()
            out = sa.run_backend(app, gt, meta)
            back_s = time.perf_counter() - t0
            card, card_solves = list(stages), list(solves)
            # the same back-end on the CPU, from the card's keyframes
            del stages[:], solves[:]
            capp, _, _ = sa.load_frontend_snapshot(snap, device="cpu")
            t0 = time.perf_counter()
            cpu_out = sa.run_backend(capp, gt, meta)
            cpu_s = time.perf_counter() - t0
            cpu = list(stages)
        finally:
            for obj, name, fn in saved:
                setattr(obj, name, fn)

    want = json.load(open(os.path.join(ROOT, "ACCURACY_SLAM.json")))
    poses = [pre] + [np.stack([k.pose for k in x["out"]]) for x in card
                     if x["stage"] != "propose_loop_closures"]
    ate = [sa._keyframe_ate(x["out"], gt) for x in card
           if x["stage"] != "propose_loop_closures"]
    log(f"slam accuracy on the card: {json.dumps(out)}; keyframe ATE after "
        f"each PGO round and BA: {ate}")
    log(f"ACCURACY_SLAM.json (the JAX package, CPU): {json.dumps(want)}")
    check_slam_accuracy(out, margins=False)

    pgo = [x for x in card_solves if x["stage"] == "optimize_pose_graph"]
    bas = [x for x in card_solves if x["stage"] == "optimize_plane_ba"]
    summary = dict(front_ms_per_frame=front_s / len(items) * 1e3,
                   propagation_rounds=rounds, backend_s=back_s,
                   pgo_ms=[x["s"] * 1e3 for x in pgo],
                   ba_solve_ms=[x["s"] * 1e3 for x in bas], stages=[
                       {k: x[k] for k in ("stage", "s", "candidates",
                                          "icp_calls", "host_reads",
                                          "nn_payload", "radius_moments")}
                       for x in card])
    log(f"slam back-end on the card: {json.dumps(summary)}")

    # the CPU's back-end against the card's, round by round
    log(f"slam back-end on the CPU from the card's keyframes: {cpu_s:.1f} s;"
        f" {json.dumps(cpu_out)}")
    gates = Mapper(capp, **sa.MAPPER_KW)
    edge = False
    for r in range(2):
        for what, key, at in (("proposed", "out", 2 * r),
                              ("kept", "kept", 2 * r + 1)):
            g = {(lc.i, lc.j): lc for lc in card[at][key]}
            c = {(lc.i, lc.j): lc for lc in cpu[at][key]}
            log(f"slam round {r + 1}, {what}: closures card {sorted(g)}, "
                f"cpu {sorted(c)}")
            for pair in set(g) ^ set(c):
                lc = g.get(pair) or c.get(pair)
                assert near_gate(gates, lc, poses[r], poses[r + 1]), (
                    r, what, pair, lc)
                log(f"slam round {r + 1}: closure {pair} {what} on one "
                    f"device only sits at a gate edge: {lc}")
                edge = True
            for pair in set(g) & set(c):
                D = np.linalg.inv(g[pair].measurement) @ c[pair].measurement
                ang = np.rad2deg(np.arccos(np.clip(
                    (np.trace(D[:3, :3]) - 1) / 2, -1, 1)))
                assert np.linalg.norm(D[:3, 3]) <= 0.02 and ang <= 0.5, (
                    pair, D)
    if not edge:
        for key in ("ate_post_pgo_m", "ate_post_ba_m"):
            assert abs(out[key] - cpu_out[key]) <= 0.01, (key, out, cpu_out)
    else:
        # a PGO over the closures both devices kept, each with its own
        # measurements, from the card's second-round poses
        def common_ate(m, lcs):
            m.loop_closures = sorted(lcs, key=lambda lc: (lc.i, lc.j))
            start = [mapper.Keyframe(0, u, p, None)
                     for u, p in zip(utimes, poses[1])]
            opt = pg.optimize_pose_graph(m.build_graph(start),
                                         robust_delta=m.pgo_robust_delta)[0]
            return sa._keyframe_ate([mapper.Keyframe(0, u, p, None) for u, p
                                     in zip(utimes, opt.cpu().numpy())], gt)
        g = {(lc.i, lc.j): lc for lc in card[3]["kept"]}
        c = {(lc.i, lc.j): lc for lc in cpu[3]["kept"]}
        both = set(g) & set(c)
        a_card = common_ate(Mapper(app, **sa.MAPPER_KW),
                            [g[p] for p in both])
        a_cpu = common_ate(gates, [c[p] for p in both])
        log(f"slam PGO over the {len(both)} closures both devices kept: "
            f"ATE card {a_card:.4f} m, CPU {a_cpu:.4f} m")
        assert abs(a_card - a_cpu) <= 0.01, (a_card, a_cpu)
    # every PGO solve of the card again on the CPU, from the card's graph
    d = []
    for x in pgo:
        cpu_opt = pg.optimize_pose_graph(convert.pose_graph_from_numpy(
            **convert.pose_graph_to_numpy(x["args"][0]), device="cpu"),
            robust_delta=10.0)[0]
        d.append(float((x["out"][0].cpu() - cpu_opt)[:, :3, 3].norm(
            dim=1).max()))
    again = pg.optimize_pose_graph(pgo[0]["args"][0], robust_delta=10.0)[0]
    log(f"slam PGO of each of the card's graphs "
        f"({pgo[0]['args'][0].n_poses} poses, edges "
        f"{[x['args'][0].n_edges for x in pgo]}), card vs CPU: {d} m; two "
        f"card solves equal: "
        f"{bool(torch.equal(again, pgo[0]['out'][0]))}")
    assert max(d) <= 1e-3, d
    assert torch.equal(again, pgo[0]["out"][0])

    # the regression's other seeds on the card, margins asserted
    for seed in (3, 7):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = sa.run_slam_accuracy(seed=seed, device="cuda")
        torch.cuda.synchronize()
        log(f"slam accuracy on the card, seed {seed} "
            f"({time.perf_counter() - t0:.1f} s): {json.dumps(res)}")
        check_slam_accuracy(res)


# ---------------------------------------------------------------------------
# KITTI odometry, the outdoor-accuracy regression, pairs and checkpoints
# ---------------------------------------------------------------------------

KITTI_SCANS = 20          # KITTI-layout scans of the urban world
KITTI_CPU_FRAMES = 4      # of them, held against the CPU App
# tests/test_eval.py's runner assertions: the trajectory's error (relative
# to the first frame, unaligned) under this share of the prior chain's
# and under KITTI_MAX_ATE, the final yaw within KITTI_MAX_YAW
KITTI_RATIO = 0.3
KITTI_MAX_ATE = 0.2       # m
KITTI_MAX_YAW = 2.0       # deg
# The JAX package's own ratio on the KITTI-width drive at its KITTI
# default config (CPU, tests/outdoor_reference.py kitti): the 0.3 above
# comes from a configuration and drive of its own (below), which the
# reference does not meet at the KITTI default either; the port is held
# to the reference there.
KITTI_REFERENCE_RATIO = 0.527
ACCURACY_FRAMES = 200     # the length of ACCURACY_r3.json's drive
# frames of the 200-frame drive held against the CPU App from the card's
# state: on either package, exact kNN makes frame 31 the first rejection
# (tests/outdoor_reference.py accuracy 31)
ACCURACY_CPU_FRAMES = (29, 30, 31, 32)


def cli_json(argv) -> dict:
    """`python -m aicp_mapping_tpu_torch ARGV` in this process; its JSON."""
    import io

    from aicp_mapping_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(list(argv)) == 0
    return json.loads(buf.getvalue())


def kitti_ground_masks(torch, scan_dir: str) -> float:
    """Each scan's ground mask at the runner's raster (0.5 m, 256 x 256) on
    the card, equal to the CPU's at every point; returns the mean ground
    share."""
    from aicp_mapping_tpu_torch.cloud import Cloud
    from aicp_mapping_tpu_torch.eval.kitti_runner import list_velodyne_scans
    from aicp_mapping_tpu_torch.ops.ground import (GroundFilterConfig,
                                                   ground_mask)

    gcfg = GroundFilterConfig(cell_size=0.5, grid_dim=256)
    shares = []
    for path in list_velodyne_scans(scan_dir):
        pts = np.fromfile(path, np.float32).reshape(-1, 4)[:, :3]
        card = Cloud.from_numpy(pts, capacity=131072, device="cuda")
        cpu = Cloud.from_numpy(pts, capacity=131072)
        g = ground_mask(card.points, card.mask, gcfg).cpu()
        assert torch.equal(g, ground_mask(cpu.points, cpu.mask, gcfg)), path
        shares.append(float(g.sum()) / len(pts))
    return float(np.mean(shares))


def checked_app(torch, tag: str, frames):
    """An App class for a runner that builds its own App: each frame is
    timed on the card, and the frames numbered in `frames` also run on a
    CPU App started from the card App's state, held to the golden
    tolerances."""
    from aicp_mapping_tpu_torch import AlignedCloud, App, Cloud
    from aicp_mapping_tpu_torch.convert import (app_state_from_numpy,
                                                app_state_to_numpy)

    class CheckedApp(App):
        made: list = []      # the instances, for their frame times

        def __init__(self, cfg, device):
            super().__init__(cfg, device=device)
            self.cpu = App(cfg, device="cpu")
            self.ms: list = []
            self.made.append(self)

        def process_cloud(self, cloud):
            i = len(self.ms)
            if i in frames:
                if i > 0:
                    app_state_from_numpy(self.cpu, **app_state_to_numpy(self))
                twin = AlignedCloud.create(cloud.utime, Cloud(
                    cloud.cloud.points.cpu(), cloud.cloud.mask.cpu(),
                    cloud.cloud.pre_voxelized), cloud.prior_pose)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = super().process_cloud(cloud)
            torch.cuda.synchronize()
            self.ms.append((time.perf_counter() - t0) * 1e3)
            if i in frames:
                want = self.cpu.process_cloud(twin)
                log(f"{tag} frame {i}: card {self.ms[-1]:.1f} ms, accepted "
                    f"{res.accepted} (cpu {want.accepted}), overlap "
                    f"{res.octree_overlap:.3f} (cpu {want.octree_overlap:.3f})"
                    f", iters {res.n_iterations} (cpu {want.n_iterations}), "
                    f"filtered {res.filtered_size} (cpu {want.filtered_size})"
                    f", correction_t {np.round(res.correction[:3, 3], 4)} "
                    f"(cpu {np.round(want.correction[:3, 3], 4)})")
                frame_lines_agree(res, as_line(want), f"{tag} frame {i}")
            return res

    return CheckedApp


@contextlib.contextmanager
def app_class(module, cls):
    """Let `module` build its App as `cls` (the runners make their own)."""
    saved = module.App
    module.App = cls
    try:
        yield
    finally:
        module.App = saved


def run_kitti(torch) -> None:
    """The "kitti" phase. (1) `run_kitti_sequence` on the card at the KITTI
    default config (131,072 raw / 32,768 voxels / 16,384 filtered points,
    80 m range, normal-space trim) over KITTI_SCANS scans at 2,048
    azimuths, with GPS-grade priors and ground removal on the device: every
    frame accepted, the error under KITTI_MAX_ATE and at most the JAX
    package's share of the prior chain's (KITTI_REFERENCE_RATIO), the
    final yaw within KITTI_MAX_YAW; its first KITTI_CPU_FRAMES frames
    against the CPU App from the card App's state (the golden tolerances);
    every scan's ground mask the CPU's. (2) tests/test_eval.py's own
    runner test on the card — its drive (14 scans at 512 azimuths cut to
    16,000 points), configuration and every assertion (KITTI_RATIO). (3)
    `kitti-run` and `kitti-eval` through the CLI on (1)'s scans."""
    import tempfile

    from aicp_mapping_tpu_torch import _kernels
    from aicp_mapping_tpu_torch.eval import kitti_runner
    from aicp_mapping_tpu_torch.eval.kitti_runner import drive_errors
    from aicp_mapping_tpu_torch.pipeline.config import PipelineConfig
    from aicp_mapping_tpu_torch.tools.urban import write_kitti_drive

    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as d:
        t0 = time.perf_counter()
        scan_dir, gt_path, gt, priors = write_kitti_drive(d, KITTI_SCANS)
        scene_s = time.perf_counter() - t0
        sizes = [os.path.getsize(p) // 16
                 for p in kitti_runner.list_velodyne_scans(scan_dir)]
        assert max(sizes) <= 131072, max(sizes)
        share = kitti_ground_masks(torch, scan_dir)
        log(f"kitti scene: {KITTI_SCANS} scans of {min(sizes)}-{max(sizes)}"
            f" points (mean {np.mean(sizes):.0f}), made on the host in "
            f"{scene_s:.1f} s; ground masks on the card equal to the CPU's "
            f"at every point, ground share {share:.3f}")

        before = _kernels.launch_counts()
        with app_class(kitti_runner, checked_app(
                torch, "kitti", range(KITTI_CPU_FRAMES))):
            t0 = time.perf_counter()
            traj, results, app = kitti_runner.run_kitti_sequence(
                scan_dir, priors=priors, remove_ground=True)
            wall_s = time.perf_counter() - t0
        after = _kernels.launch_counts()
        n = len(results)
        per_frame = {k: (after[k] - before[k]) / n
                     for k in ("nn_payload", "banded_moments")}
        assert all(r is not None and r.accepted for r in results), [
            (r.accepted, r.inlier_rms) for r in results]
        e = drive_errors(traj, gt, priors)
        steady = app.ms[KITTI_CPU_FRAMES:]
        log(f"kitti on the card ({gpu_line()}): {n} frames, "
            f"{np.mean(steady):.2f} ms/frame (frames {KITTI_CPU_FRAMES}-"
            f"{n - 1}; min {min(steady):.2f}, max {max(steady):.2f}), "
            f"{wall_s:.1f} s with the CPU checks; K1 "
            f"{per_frame['nn_payload']:.2f} and K2 "
            f"{per_frame['banded_moments']:.2f} launches per frame; ATE "
            f"(relative, unaligned) {e['ate_m']:.4f} m, prior chain "
            f"{e['prior_chain_ate_m']:.4f} m (ratio {e['ratio']:.3f}; the "
            f"JAX package's {KITTI_REFERENCE_RATIO}), final yaw error "
            f"{e['final_yaw_deg']:.3f} deg")
        assert e["ratio"] <= KITTI_REFERENCE_RATIO, e
        assert e["ate_m"] < KITTI_MAX_ATE, e
        assert e["final_yaw_deg"] < KITTI_MAX_YAW, e

        out = os.path.join(d, "kitti_run.txt")
        run = cli_json(["kitti-run", scan_dir, "-o", out, "--ground-truth",
                        gt_path, "--remove-ground"])
        ev = cli_json(["kitti-eval", gt_path, out])
        log(f"kitti-run (constant-velocity model, no priors): "
            f"{json.dumps(run)}; kitti-eval: {json.dumps(ev)}")
        assert run["frames"] == KITTI_SCANS and os.path.exists(out)
        assert isinstance(ev["rpe_trans"], float), ev
        assert np.isfinite(ev["ate_rmse"]) and np.isfinite(ev["rpe_rot"])

    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as d:
        scan_dir, _, gt, priors = write_kitti_drive(
            d, 14, n_azimuth=512, cap=16000, scan_seed=0)
        cfg = PipelineConfig(raw_capacity=16384, downsample_capacity=8192,
                             filtered_capacity=4096,
                             segmentation_method="region_growing",
                             sensor_range=80.0, max_correction_magnitude=3.0,
                             trim_ratio_floor=0.50)
        cfg.icp = dataclasses.replace(cfg.icp, degeneracy_threshold=30.0)
        t0 = time.perf_counter()
        traj, results, _ = kitti_runner.run_kitti_sequence(
            scan_dir, config=cfg, priors=priors, remove_ground=True)
        e = drive_errors(traj, gt, priors)
        log(f"kitti, tests/test_eval.py's runner test on the card: 14 frames"
            f" in {time.perf_counter() - t0:.1f} s, ATE {e['ate_m']:.4f} m, "
            f"prior chain {e['prior_chain_ate_m']:.4f} m (ratio "
            f"{e['ratio']:.3f}), final yaw error {e['final_yaw_deg']:.3f} deg")
        assert all(r is not None and r.accepted for r in results)
        assert e["ratio"] < KITTI_RATIO, e
        assert e["ate_m"] < KITTI_MAX_ATE, e
        assert e["final_yaw_deg"] < KITTI_MAX_YAW, e


def accuracy_thresholds(res: dict) -> None:
    """tests/test_accuracy.py's thresholds."""
    pipe, odo = res["pipeline"], res["odometry_only"]
    assert pipe["ate_rmse_noalign_m"] < 0.75 * odo["ate_rmse_noalign_m"], res
    assert pipe["rpe_rot_rmse_deg"] < 0.75 * odo["rpe_rot_rmse_deg"], res
    assert pipe["ate_rmse_m"] < 0.08, res
    assert res["dropped_frames"] == 0, res


def run_accuracy_phase(torch) -> None:
    """The "accuracy" phase. (1) `eval.accuracy.run_accuracy` on the card at
    its default (outdoor, full-width) config over ACCURACY_FRAMES frames,
    printed beside ACCURACY_r3.json (the JAX package's record, made on a
    TPU: its accuracy compares, its wall time is another machine's), with
    frames ACCURACY_CPU_FRAMES against the CPU App from the card App's
    state. Under exact kNN (the port everywhere, JAX off the TPU) frame 31
    is rejected and the drive does not recover, in both packages, so the
    regression's thresholds are not asserted at this config (ROADMAP Q3).
    (2) tests/test_accuracy.py's own regression on the card — 20 frames,
    16,384 / 8,192 / 4,096, a 64 x 512 scanner and its drift — held to its
    thresholds."""
    from aicp_mapping_tpu_torch import _kernels
    from aicp_mapping_tpu_torch.eval.accuracy import run_accuracy
    from aicp_mapping_tpu_torch.pipeline import app as app_module
    from aicp_mapping_tpu_torch.pipeline.config import PipelineConfig

    before = _kernels.launch_counts()["nn_payload"]
    t0 = time.perf_counter()
    checked = checked_app(torch, "accuracy", ACCURACY_CPU_FRAMES)
    with app_class(app_module, checked):
        res = run_accuracy(n_frames=ACCURACY_FRAMES, seed=0)
    wall_s = time.perf_counter() - t0
    ms = [m for i, m in enumerate(checked.made[0].ms[2:], 2)
          if i not in ACCURACY_CPU_FRAMES]
    launches = _kernels.launch_counts()["nn_payload"] - before
    with open(os.path.join(ROOT, "ACCURACY_r3.json")) as f:
        ref = json.load(f)
    pipe, odo = res["pipeline"], res["odometry_only"]
    log(f"accuracy on the card ({gpu_line()}): {res['n_frames']} frames "
        f"({res['track_length_m']} m) in {wall_s:.1f} s, the drive's scans "
        f"made on the host and {len(ACCURACY_CPU_FRAMES)} CPU frames "
        f"included; {np.mean(ms):.2f} ms/frame on the card (process_cloud, "
        f"frames 2-199 but the CPU-checked ones; min {min(ms):.2f},"
        f" max {max(ms):.2f}); K1 {launches / res['n_frames']:.2f} launches "
        f"per frame; "
        f"dropped {res['dropped_frames']} (ACCURACY_r3.json "
        f"{ref['dropped_frames']})")
    for k in ("t_err_percent", "r_err_deg_per_m", "ate_rmse_m",
              "ate_rmse_noalign_m", "rpe_trans_rmse_m", "rpe_rot_rmse_deg"):
        log(f"accuracy {k}: pipeline {pipe[k]:.5f} (ACCURACY_r3.json "
            f"{ref['pipeline'][k]:.5f}), odometry {odo[k]:.5f} "
            f"({ref['odometry_only'][k]:.5f})")
    assert res["n_frames"] == ACCURACY_FRAMES
    assert all(np.isfinite(v) for v in pipe.values()), pipe
    # the drive and its odometry are the JAX package's (the same draws)
    assert all(abs(odo[k] - ref["odometry_only"][k]) <= 1e-9
               for k in odo), (odo, ref["odometry_only"])

    cfg = PipelineConfig(working_mode="debug",
                         segmentation_method="region_growing",
                         raw_capacity=16384, downsample_capacity=8192,
                         filtered_capacity=4096)
    t0 = time.perf_counter()
    small = run_accuracy(n_frames=20, seed=0, cfg=cfg, seq_kwargs=dict(
        n_azimuth=512, n_points_cap=16000, drift_per_m=0.025,
        drift_yaw_deg_per_m=0.2))
    log(f"accuracy, tests/test_accuracy.py's regression on the card: 20 "
        f"frames in {time.perf_counter() - t0:.1f} s, dropped "
        f"{small['dropped_frames']}; pipeline ATE "
        f"{small['pipeline']['ate_rmse_m']:.4f} m, ATE-noalign "
        f"{small['pipeline']['ate_rmse_noalign_m']:.4f} (odometry "
        f"{small['odometry_only']['ate_rmse_noalign_m']:.4f}), RPE rot "
        f"{small['pipeline']['rpe_rot_rmse_deg']:.4f} deg (odometry "
        f"{small['odometry_only']['rpe_rot_rmse_deg']:.4f})")
    accuracy_thresholds(small)


def pairs_scene() -> list:
    """3 overlapping subsets of one room (8,000 points each), world
    frame."""
    from aicp_mapping_tpu_torch.tools.synthetic import room_cloud

    world = room_cloud(n=12000, seed=6, noise=0.01)
    rng = np.random.default_rng(0)
    return [world[rng.choice(len(world), 8000, replace=False)]
            for _ in range(3)]


def run_pairs_and_checkpoints(torch) -> None:
    """The "pairs and checkpoints" phase: `run_pairwise` of 3 room clouds at
    capacity 8,192 (K3 normals, K1 ICP) against the CPU (overlap within 2
    %, |t| within 0.01 m); the `classifier --train/--test` CLI on the
    synthetic label sets against the CPU (the same confusion counts,
    probabilities within 1e-4); the bench point's 6 frames with a
    checkpoint after frame 3, resumed on the card (frames 4-6 the
    uninterrupted run's bits) and on the CPU (the golden tolerances)."""
    import tempfile

    from aicp_mapping_tpu_torch import AlignedCloud, App, Cloud
    from aicp_mapping_tpu_torch.eval.experiment import run_pairwise
    from aicp_mapping_tpu_torch.io import checkpoint
    from aicp_mapping_tpu_torch.pipeline.sequence import synthetic_sequence

    clouds = pairs_scene()
    poses = [np.eye(4, dtype=np.float32)] * 3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = run_pairwise(clouds, poses, capacity=8192)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = run_pairwise(clouds, poses, capacity=8192, device="cpu")
    cpu_s = time.perf_counter() - t0
    for a, b in zip(card, cpu):
        assert (a.reference_id, a.reading_id) == (b.reference_id,
                                                  b.reading_id)
        assert abs(a.octree_overlap - b.octree_overlap) <= TOL_OVERLAP, (a, b)
        assert abs(a.t_error - b.t_error) <= 0.01, (a, b)
        assert a.t_error < 0.05, a
    log(f"pairs on the card: {len(card)} pairs in {card_s:.2f} s (CPU "
        f"{cpu_s:.1f} s); overlap {[round(r.octree_overlap, 2) for r in card]}"
        f" (cpu {[round(r.octree_overlap, 2) for r in cpu]}); |t| "
        f"{[round(r.t_error, 5) for r in card]}")

    labels = os.path.join(ROOT, "data", "labels")
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as d:
        runs = {}
        for dev in ("cuda", "cpu"):
            probs = os.path.join(d, f"{dev}.txt")
            t0 = time.perf_counter()
            runs[dev] = cli_json([
                "classifier", "--train",
                os.path.join(labels, "training_synthetic.txt"), "--test",
                os.path.join(labels, "testing_synthetic.txt"),
                "--save-probs", probs, "--device", dev])
            runs[dev + "_s"] = time.perf_counter() - t0
            runs[dev + "_probs"] = np.loadtxt(probs)
        dp = float(np.abs(runs["cuda_probs"] - runs["cpu_probs"]).max())
        log(f"classifier --train/--test: card {runs['cuda_s']:.2f} s, CPU "
            f"{runs['cpu_s']:.2f} s; confusion card "
            f"{[runs['cuda'][k] for k in ('tp', 'tn', 'fp', 'fn')]} (cpu "
            f"{[runs['cpu'][k] for k in ('tp', 'tn', 'fp', 'fn')]}), AUC "
            f"{runs['cuda']['auc']:.4f}, max |dp| {dp:.3g}")
        for k in ("tp", "tn", "fp", "fn"):
            assert runs["cuda"][k] == runs["cpu"][k], k
        assert dp <= 1e-4, dp

        cfg = bench_config()
        items, _ = synthetic_sequence(n_frames=6, **SCAN_ARGS)

        def frame(utime, pts, pose, dev="cuda"):
            return AlignedCloud.create(utime, Cloud.from_numpy(
                pts, capacity=cfg.raw_capacity, device=dev), pose)

        full = App(cfg)
        want = [full.process_cloud(frame(*it)) for it in items]
        app = App(cfg)
        for it in items[:3]:
            app.process_cloud(frame(*it))
        path = os.path.join(d, "state")
        checkpoint.save_checkpoint(app, path)
        back = checkpoint.load_checkpoint(path)
        got = [back.process_cloud(frame(*it)) for it in items[3:]]
        for g, w in zip(got, want[3:]):
            assert (g.accepted, g.registered) == (w.accepted, w.registered)
            assert np.array_equal(g.correction, w.correction), (g, w)
            assert np.array_equal(g.corrected_pose, w.corrected_pose)
        cpu_app = checkpoint.load_checkpoint(path, device="cpu")
        for i, it in enumerate(items[3:]):
            frame_lines_agree(cpu_app.process_cloud(frame(*it, dev="cpu")),
                              as_line(want[3 + i]), f"resumed frame {3 + i}")
        size = os.path.getsize(path + ".npz")
        log(f"checkpoint after frame 2 of the bench point: frames 3-5 "
            f"resumed on the card bit for bit the uninterrupted run's, on "
            f"the CPU within the golden tolerances ({size} B npz)")


# ---------------------------------------------------------------------------
# The visualizer sinks, the live viewer, drawing, planar IO and the demo
# ---------------------------------------------------------------------------

VIZ_FRAMES = 5        # bench scans through the sink comparison
VIZ_PROFILED = 2      # further scans under torch.profiler, each App
VIZ_KERNELS = ("nn_payload", "banded_moments", "radius_moments")
VIZ_POSE_TOL = 0.05   # m, the golden corrected_t
VIZ_SIZE_SHARE = 0.01  # of a cloud's or a map's rows: the hough order


def dtoh_per_frame(torch, step, frames: int) -> float:
    """Device-to-host copies per call of `step` under torch.profiler."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    from portbench.trace import load

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(frames):
            step()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        events = load(path).device
    assert events, "the profiler recorded no device events"
    return sum(1 for e in events
               if e.cat == "gpu_memcpy" and "DtoH" in e.name) / frames


def frame_publishes(vis, utime: int) -> dict:
    """Every publish of one frame in a RecordingVisualizer, by hook."""
    out = {hook: [a for u, a in getattr(vis, hook) if u == utime]
           for hook in ("clouds", "maps", "poses", "prior_poses",
                        "odom_poses", "odom_to_map")}
    out.update({name: [v for u, v in series if u == utime]
                for name, series in vis.metrics.items()})
    return out


def publishes_agree(got: dict, want: dict, what: str,
                    clouds: bool = True) -> None:
    """One frame's publishes on the card against the CPU App's: the same
    hooks and metric names, poses within 0.05 m, clouds and maps within 1 %
    of their rows, metrics within the golden tolerances."""
    assert got.keys() == want.keys(), (what, got.keys(), want.keys())
    tol = {"octree_overlap": TOL_OVERLAP, "fov_overlap": TOL_RISK[
        "fov_overlap"], "alignability": TOL_RISK["alignability"],
        "alignment_risk": TOL_RISK["risk"]}
    for hook, series in got.items():
        if hook in ("clouds", "maps") and not clouds:
            continue
        assert len(series) == len(want[hook]), (what, hook)
        for a, b in zip(series, want[hook]):
            if hook in tol:
                assert abs(a - b) <= tol[hook], (what, hook, a, b)
            elif hook in ("clouds", "maps"):
                assert abs(len(a) - len(b)) <= VIZ_SIZE_SHARE * len(b), (
                    what, hook, len(a), len(b))
            else:
                assert np.abs(a[:3, 3] - b[:3, 3]).max() <= VIZ_POSE_TOL, (
                    what, hook, a, b)


def viz_bench(torch) -> dict:
    """(1) The bench point with failure prediction and the shipped
    classifier, a reference update every 2 frames: one App with a
    RecordingVisualizer and one with none on the card, frame by frame in
    turns (which goes first alternates), their results equal bit for bit;
    each frame's publishes against a CPU App's (with its own sink, started
    from the card App's state); ms/frame of both (frames 2 on, each
    synchronised); then device-to-host copies per frame of both under
    torch.profiler."""
    from aicp_mapping_tpu_torch import AlignedCloud, App, Cloud
    from aicp_mapping_tpu_torch.convert import (app_state_from_numpy,
                                                app_state_to_numpy)
    from aicp_mapping_tpu_torch.pipeline.sequence import synthetic_sequence
    from aicp_mapping_tpu_torch.utils.visualizer import RecordingVisualizer

    cfg = bench_config()
    cfg.failure_prediction_mode = True
    cfg.classifier_path = CLASSIFIER
    # a reference update every 2 frames: the sink then reads the new
    # reference cloud and the map on the card in the compared and in the
    # profiled frames
    cfg.reference_update_frequency = 2
    items, _ = synthetic_sequence(n_frames=VIZ_FRAMES + VIZ_PROFILED,
                                  **SCAN_ARGS)
    vis, cpu_vis = RecordingVisualizer(), RecordingVisualizer()
    apps = {"sink": App(cfg, device="cuda", visualizer=vis),
            "none": App(cfg, device="cuda")}
    cpu = App(cfg, device="cpu", visualizer=cpu_vis)
    ms = {k: [] for k in apps}
    for i, (utime, pts, pose) in enumerate(items[:VIZ_FRAMES]):
        if i > 0:
            app_state_from_numpy(cpu, **app_state_to_numpy(apps["none"]))
        res = {}
        turns = list(apps.items())       # in turns: sink first every 2nd
        for name, app in turns if i % 2 == 0 else turns[::-1]:
            cloud = Cloud.from_numpy(pts, capacity=cfg.raw_capacity)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res[name] = app.process_cloud(AlignedCloud.create(utime, cloud,
                                                              pose))
            torch.cuda.synchronize()
            ms[name].append((time.perf_counter() - t0) * 1e3)
        for k, v in vars(res["sink"]).items():
            w = getattr(res["none"], k)
            assert (np.array_equal(v, w) if isinstance(v, np.ndarray)
                    else v == w), (i, k, v, w)
        rc = cpu.process_cloud(AlignedCloud.create(utime, Cloud.from_numpy(
            pts, capacity=cfg.raw_capacity), pose))
        rg = res["sink"]
        # a risk at the threshold may gate on one device only: then the
        # reference (cloud, map) publishes part by design
        marginal = (rg.registered != rc.registered and max(
            abs(rg.risk - cfg.risk_threshold),
            abs(rc.risk - cfg.risk_threshold)) <= TOL_RISK["risk"])
        published = frame_publishes(vis, utime)
        publishes_agree(published, frame_publishes(cpu_vis, utime),
                        f"viz frame {i}", clouds=not marginal)
        log(f"viz frame {i}: sink {ms['sink'][-1]:.1f} ms, none "
            f"{ms['none'][-1]:.1f} ms; registered {rg.registered} (cpu "
            f"{rc.registered}), risk {rg.risk:.4f} (cpu {rc.risk:.4f}); "
            f"publishes {[len(v) for v in published.values()]}"
            f"{' (risk at the threshold)' if marginal else ''}")
    assert len(vis.clouds) >= 2 and len(vis.maps) >= 2, vis.clouds
    assert sorted(vis.metrics) == ["alignability", "alignment_risk",
                                   "fov_overlap", "octree_overlap"]
    reads = {}
    for name, app in apps.items():
        def step(frames=iter(items[VIZ_FRAMES:]), app=app):
            utime, pts, pose = next(frames)
            app.process_cloud(AlignedCloud.create(utime, Cloud.from_numpy(
                pts, capacity=cfg.raw_capacity), pose))
        reads[name] = dtoh_per_frame(torch, step, VIZ_PROFILED)
    for a, b in zip(apps["sink"].frames, apps["none"].frames):
        assert np.array_equal(a.corrected_pose, b.corrected_pose)
        assert (a.risk, a.octree_overlap) == (b.risk, b.octree_overlap)
    cpu.close()
    return dict(sink_ms=float(np.mean(ms["sink"][2:])),
                none_ms=float(np.mean(ms["none"][2:])), reads=reads)


def viz_pipelined(torch) -> int:
    """(1b) The sink under pipelining with async finalize, where its reads
    of the new reference cloud and the map run on the finalizer thread:
    the bench point's first 7 frames at depth 4 (a reference update every
    2 frames) through an App with a RecordingVisualizer and one without,
    their results bit for bit, every frame accepted (a rejection inside
    the window would make results depend on thread timing), the publishes
    in frame order, one cloud per reference."""
    from aicp_mapping_tpu_torch import App
    from aicp_mapping_tpu_torch.pipeline import SequenceRunner
    from aicp_mapping_tpu_torch.pipeline.sequence import synthetic_sequence
    from aicp_mapping_tpu_torch.utils.visualizer import RecordingVisualizer

    cfg = bench_config()
    cfg.pipeline_depth = 4
    cfg.async_finalize = True
    cfg.reference_update_frequency = 2
    items, _ = synthetic_sequence(n_frames=VIZ_FRAMES + VIZ_PROFILED,
                                  **SCAN_ARGS)
    vis = RecordingVisualizer()
    runs = {}
    for name, sink in (("sink", vis), ("none", None)):
        app = App(cfg, device="cuda", visualizer=sink)
        try:
            runs[name] = SequenceRunner(app, pipelined=True).run_clouds(items)
        finally:
            app.close()
    assert len(runs["sink"]) == len(runs["none"]) == len(items)
    for a, b in zip(runs["sink"], runs["none"]):
        for k, v in vars(a).items():
            w = getattr(b, k)
            assert (np.array_equal(v, w) if isinstance(v, np.ndarray)
                    else v == w), (k, v, w)
    assert all(r.accepted for r in runs["sink"]), runs["sink"]
    utimes = [u for u, _ in vis.metrics["octree_overlap"]]
    assert utimes == [r.utime for r in runs["sink"][1:]], utimes
    for series in (vis.clouds, vis.maps, vis.poses):
        assert [u for u, _ in series] == sorted(u for u, _ in series)
    assert len(vis.clouds) == len(vis.maps) == 1 + (len(items) - 1) // 2
    return len(vis.clouds)


def viz_file_sink(torch, d: str) -> int:
    """(2) FileVisualizer through an App on the card (the golden
    scenario's first 6 frames, a reference update every 2): each published
    cloud and the last map read back from their PCD files."""
    from aicp_mapping_tpu_torch import (AlignedCloud, App, Cloud,
                                        PipelineConfig)
    from aicp_mapping_tpu_torch.io.pcd import read_pcd
    from aicp_mapping_tpu_torch.pipeline.sequence import synthetic_sequence
    from aicp_mapping_tpu_torch.utils.visualizer import FileVisualizer

    cfg = PipelineConfig(raw_capacity=8192, downsample_capacity=4096,
                         filtered_capacity=2048, min_cluster_size=20,
                         reference_update_frequency=2)
    vis = FileVisualizer(os.path.join(d, "file_sink"))
    app = App(cfg, device="cuda", visualizer=vis)
    items, _ = synthetic_sequence(n_frames=6, n_points=5000, seed=11)
    for utime, pts, pose in items:
        app.process_cloud(AlignedCloud.create(utime, Cloud.from_numpy(
            pts, capacity=cfg.raw_capacity), pose))
    assert len(vis.clouds) >= 3, len(vis.clouds)
    for utime, pts in vis.clouds:
        got, _ = read_pcd(os.path.join(vis.directory,
                                       f"cloud_0_{utime}.pcd"))
        assert np.array_equal(got, pts), utime
    got, _ = read_pcd(os.path.join(vis.directory, "aligned_map.pcd"))
    assert np.array_equal(got, vis.maps[-1][1])
    assert np.array_equal(got, app.aligned_map_np)
    return len(vis.clouds)


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def viz_live(torch, d: str) -> dict:
    """(3) `replay --live-viz PORT` on the card over a recorded sequence
    (the golden scenario's 8 frames, a reference update every 2), with a
    viewer thread that connects as soon as the command listens."""
    import socket
    import threading

    from aicp_mapping_tpu_torch.pipeline import SequenceRecorder
    from aicp_mapping_tpu_torch.pipeline.sequence import synthetic_sequence
    from aicp_mapping_tpu_torch.utils.live_viz import read_frames

    seq = os.path.join(d, "seq")
    rec = SequenceRecorder(seq)
    for utime, pts, pose in synthetic_sequence(n_frames=8, n_points=5000,
                                               seed=11)[0]:
        rec.record(utime, pts, pose)
    yaml = os.path.join(d, "live.yaml")
    with open(yaml, "w") as f:
        f.write("AICP:\n  Pipeline:\n    rawCapacity: 8192\n"
                "    downsampleCapacity: 4096\n    filteredCapacity: 2048\n"
                "    minClusterSize: 20\n    referenceUpdateFrequency: 2\n")
    port = free_port()
    got: dict = {}

    def viewer():
        deadline = time.time() + 120
        while True:
            try:
                sock = socket.create_connection(("127.0.0.1", port),
                                                timeout=120)
                break
            except OSError:
                if time.time() > deadline:
                    raise
                time.sleep(0.002)
        with sock:
            for h, a in read_frames(sock):
                got[h["type"]] = got.get(h["type"], 0) + 1

    th = threading.Thread(target=viewer, daemon=True)
    th.start()
    summary = cli_json(["replay", seq, "--config", yaml, "--live-viz",
                        str(port), "--device", "cuda"])
    th.join(timeout=30)
    assert not th.is_alive(), "the viewer never saw the stream end"
    assert summary["frames"] == 8 and summary["accepted"] >= 1, summary
    assert {"cloud", "map", "pose", "metric"} <= set(got), got
    return got


def viz_draw(torch, d: str) -> dict:
    """(4) `draw` (both modes) and `vtk-to-octree` on the card against
    `--device cpu`: the octree outputs byte for byte; the normal whiskers
    from the same points, their directions within 1e-4 of the CPU's up to
    sign for >= 99 % of the points."""
    from aicp_mapping_tpu_torch.io.pcd import write_pcd
    from aicp_mapping_tpu_torch.io.vtk import read_vtk, write_vtk
    from aicp_mapping_tpu_torch.tools.synthetic import room_cloud
    from aicp_mapping_tpu_torch.utils.visualizer import occupied_cells

    pts = room_cloud(n=8192, size=12.0, seed=4, noise=0.01)
    cloud = os.path.join(d, "room.pcd")
    write_pcd(cloud, pts)
    out = {}
    for key, dev in (("card", "cuda"), ("cpu", "cpu")):
        out[key] = os.path.join(d, f"normals_{key}.vtk")
        sync(torch)
        t0 = time.perf_counter()
        cli_json(["draw", cloud, out[key], "--mode", "normals",
                  "--device", dev])
        out[key + "_s"] = time.perf_counter() - t0
    got = read_vtk(out["card"]).reshape(-1, 2, 3)
    want = read_vtk(out["cpu"]).reshape(-1, 2, 3)
    assert got.shape == want.shape == (len(pts), 2, 3)
    assert np.array_equal(got[:, 0], want[:, 0])
    dg, dw = got[:, 1] - got[:, 0], want[:, 1] - want[:, 0]
    off = np.minimum(np.abs(dg - dw).max(1), np.abs(dg + dw).max(1))
    share = float((off <= 0.2 * 1e-4 + 2e-6).mean())
    assert share >= 0.99, share
    octree = cli_json(["draw", cloud, os.path.join(d, "octree.vtk")])
    assert octree["segments"] == 12 * len(occupied_cells(pts, 0.2))
    src = os.path.join(d, "room.vtk")
    write_vtk(src, pts, binary=True)
    cells_info = cli_json(["vtk-to-octree", src,
                           os.path.join(d, "cells.vtk"), "--resolution",
                           "0.5"])
    assert np.array_equal(read_vtk(os.path.join(d, "cells.vtk")),
                          occupied_cells(pts, 0.5))
    return dict(share=share, max_off=float(off.max()),
                card_s=out["card_s"], cpu_s=out["cpu_s"],
                cells=cells_info["occupied_cells"])


def viz_planar(torch) -> list:
    """(5) The planar 2D chain (configs/icp/icp_2d_testing.yaml, padded to
    1,024 points, K1 at 1,024^2) on the card against the CPU (T within 2 mm
    and 0.05 deg): tests/test_chain.py's pair of synthetic room scans,
    recovered to 3 cm / 0.01 rad of the truth as that test asserts, and
    each shipped scan data/scan_0*.csv against itself moved by 0.12 m,
    -0.08 m and 2 deg (its distance from the truth printed: how far the
    chain gets is the algorithm's, held to JAX's on the CPU by
    tests/test_torch_icp.py)."""
    import glob

    from aicp_mapping_tpu_torch.io.planar import (planar_to_cloud,
                                                  read_planar_csv,
                                                  synthetic_room_scan)
    from aicp_mapping_tpu_torch.pipeline.config import load_icp_chain_yaml
    from aicp_mapping_tpu_torch.registration import point_to_plane_icp

    cfg = load_icp_chain_yaml(os.path.join(
        ROOT, "configs", "icp", "icp_2d_testing.yaml"))[0]

    def angle_deg(A, B) -> float:
        """The angle between two rotations, from |A - B|_F = 2 sqrt(2)
        sin(angle / 2) (precise at small angles)."""
        f = np.linalg.norm(A.astype(np.float64) - B) / (2 * np.sqrt(2))
        return float(np.degrees(2 * np.arcsin(min(f, 1.0))))

    def planar_T(x, y, theta):
        T = np.eye(4, dtype=np.float32)
        c, s = np.cos(theta), np.sin(theta)
        T[:2, :2] = [[c, -s], [s, c]]
        T[:2, 3] = [x, y]
        return T

    def pad(p2):
        out = np.zeros((1024, 3), np.float32)
        pts = planar_to_cloud(p2)
        assert len(pts) <= 1024, len(pts)
        out[:len(pts)] = pts
        return out, np.arange(1024) < len(pts)

    def solve(read, ref, dev):
        t = [torch.as_tensor(a, device=dev) for a in (*read, *ref)]
        res = point_to_plane_icp(t[0], t[1], t[2],
                                 torch.zeros(1024, 3, device=dev), t[3],
                                 torch.eye(4, device=dev),
                                 torch.tensor(cfg.trim_ratio, device=dev),
                                 cfg)
        return res.T.cpu().numpy()

    pose_b = (0.25, -0.15, 0.06)
    pairs = [("synthetic room", pad(synthetic_room_scan(
        pose_b, n_beams=720, seed=1)), pad(synthetic_room_scan(
            (0.0, 0.0, 0.0), n_beams=720, seed=0)), planar_T(*pose_b))]
    move = planar_T(0.12, -0.08, np.radians(2.0))
    for path in sorted(glob.glob(os.path.join(ROOT, "data",
                                              "scan_0*.csv"))):
        scan = read_planar_csv(path)
        moved = scan @ move[:2, :2].T + move[:2, 3]
        pairs.append((os.path.basename(path), pad(moved), pad(scan),
                      np.linalg.inv(move)))
    assert len(pairs) == 4, pairs
    rows = []
    for name, read, ref, T_gt in pairs:
        Tg, Tc = solve(read, ref, "cuda"), solve(read, ref, "cpu")
        dt = float(np.linalg.norm(Tg[:3, 3] - Tc[:3, 3]))
        dr = angle_deg(Tg[:3, :3], Tc[:3, :3])
        et = float(np.linalg.norm(Tg[:3, 3] - T_gt[:3, 3]))
        er = angle_deg(Tg[:3, :3], T_gt[:3, :3])
        assert dt <= 2e-3 and dr <= 0.05, (name, dt, dr)
        if name == "synthetic room":
            assert et < 0.03 and np.radians(er) < 0.01, (name, et, er)
        rows.append((name, et, er, dt))
    return rows


def run_viz(torch) -> dict:
    """The "viz" phase: the visualizer sinks at the bench point (1), the
    file sink (2), `replay --live-viz` with a viewer (3), `draw` and
    `vtk-to-octree` (4), the planar 2D chain (5) and `tools/drive_demo.py`'s
    flow (6), all on the card."""
    import tempfile

    from aicp_mapping_tpu_torch.tools import drive_demo

    t_phase = time.perf_counter()
    out = viz_bench(torch)
    log(f"viz (1) bench point with failure prediction ({gpu_line()}): "
        f"{out['sink_ms']:.2f} ms/frame with a RecordingVisualizer, "
        f"{out['none_ms']:.2f} without (frames 2-{VIZ_FRAMES - 1}), results "
        f"bit for bit; device-to-host copies per frame "
        f"{out['reads']['sink']:.1f} with the sink, "
        f"{out['reads']['none']:.1f} without")
    n = viz_pipelined(torch)
    log(f"viz (1b) pipelined at depth 4 with async finalize: the sink's "
        f"{n} cloud reads on the finalizer thread; frames bit for bit the "
        "App's without a sink, publishes in frame order")
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as d:
        n = viz_file_sink(torch, d)
        log(f"viz (2) FileVisualizer: {n} clouds and the map read back "
            "equal from their PCD files")
        got = viz_live(torch, d)
        log(f"viz (3) replay --live-viz: the viewer received {got}")
        draw = viz_draw(torch, d)
        log(f"viz (4) draw --mode normals: {draw['share']:.4f} of the "
            f"whiskers within 1e-4 of the CPU's (max {draw['max_off']:.3g}),"
            f" card {draw['card_s']:.2f} s, CPU {draw['cpu_s']:.2f} s; "
            f"octree and vtk-to-octree ({draw['cells']} cells) equal")
    for name, et, er, dt in viz_planar(torch):
        log(f"viz (5) 2D chain, {name}: {et * 1e3:.2f} mm and {er:.4f} deg "
            f"from the truth, {dt * 1e3:.3f} mm from the CPU's T")
    demo = drive_demo.run("cuda")
    log(f"viz (6) drive_demo on the card: {len(demo['frames'])} frames "
        f"accepted, corrected end {demo['corr_err'][-1] * 100:.1f} cm "
        f"(odometry {demo['odom_err'][-1] * 100:.1f} cm), "
        f"{(len(demo['frames']) - 2) / demo['t_rest']:.1f} frames/s")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"viz phase: {out['phase_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Distribution: ranks on the card (processes started by parallel.launch)
# ---------------------------------------------------------------------------

DIST_RANKS = 2
DIST_TIMEOUT_S = 600.0
DIST_KERNELS = ("nn_payload", "banded_nn_payload_stream", "banded_moments")
DIST_PERT = ([0.01, -0.015, 0.03], [0.08, -0.05, 0.04])


@contextlib.contextmanager
def not_path(skip: dict):
    """Kernel launches made inside (a rank's inputs, its single-device and
    unsharded references) are not the distributed path's: they are added
    to `skip`, which `run_distributed` takes out of the rank's counts."""
    from aicp_mapping_tpu_torch import _kernels

    before = _kernels.launch_counts()
    try:
        yield
    finally:
        after = _kernels.launch_counts()
        for k in after:
            skip[k] = skip.get(k, 0) + after[k] - before[k]


def dist_scene(torch, n: int, seed: int, dev):
    """A 12 m room of `n` points with kNN normals, and the reading: the room
    moved by DIST_PERT, with the perturbation."""
    from aicp_mapping_tpu_torch.cloud import Cloud
    from aicp_mapping_tpu_torch.geometry import se3
    from aicp_mapping_tpu_torch.ops.normals import estimate_normals
    from aicp_mapping_tpu_torch.tools.synthetic import room_cloud

    ref = Cloud.from_numpy(room_cloud(n=n, size=12.0, seed=seed,
                                      noise=0.005), n, dev)
    normals, _, _ = estimate_normals(ref.points, ref.mask, k=12)
    T = se3.make_transform(se3.so3_exp(torch.tensor(DIST_PERT[0])),
                           torch.tensor(DIST_PERT[1])).to(dev)
    return ref, normals, ref.transform(T), T


def recovered(T, T_pert) -> tuple:
    """(m, deg) left of the perturbation after the correction T."""
    err = (T @ T_pert).cpu().numpy().astype(np.float64)
    c = np.clip((np.trace(err[:3, :3]) - 1) / 2, -1.0, 1.0)
    return float(np.linalg.norm(err[:3, 3])), float(np.degrees(np.arccos(c)))


def sync(torch) -> None:
    """Wait for the card (the phase rehearses on CPU ranks too)."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def host_ms(torch, fn, reps: int = 5) -> float:
    """Mean wall ms of `fn` after a warm-up, the card synchronised: a
    sharded solve waits on host collectives, so its time is the wall's."""
    fn()
    sync(torch)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sync(torch)
    return (time.perf_counter() - t0) * 1e3 / reps


def dist_reading(torch, mesh, tag: str, skip: dict) -> dict:
    """(a): the reading-sharded ICP at the bench shape against the card's
    single-device solve, T within 1e-4; the collectives of one solve from
    the mesh's counters."""
    from aicp_mapping_tpu_torch.eval.multichip import collective_stats
    from aicp_mapping_tpu_torch.parallel import sharded_point_to_plane_icp
    from aicp_mapping_tpu_torch.registration.icp import (point_to_plane_icp,
                                                         solver_plan)

    cfg = bench_config().icp
    dev = mesh.device
    with not_path(skip):
        ref, normals, reading, T_pert = dist_scene(torch, 8192, 3, dev)
    args = (reading.points, reading.mask, ref.points, normals, ref.mask,
            torch.eye(4, device=dev), torch.tensor(0.7, device=dev))
    D = mesh.shape["points"]
    matcher = "kernel" if dev.type == "cuda" else "plain"
    assert solver_plan(cfg, 8192 // D, 8192, dev) == {
        "nn": matcher, "coarse": True}

    def sharded():
        return sharded_point_to_plane_icp(mesh, *args, cfg)

    mesh.reset_counts()
    res = sharded()
    stats = collective_stats(mesh.counts(), res.n_iterations)
    out = dict(ms=host_ms(torch, sharded), iterations=res.n_iterations,
               stats=stats, recovered=recovered(res.T, T_pert))
    if mesh.rank == 0:
        with not_path(skip):
            one = point_to_plane_icp(*args, cfg)
            out["single_ms"] = host_ms(torch, lambda: point_to_plane_icp(
                *args, cfg))
        out["dT"] = float((res.T - one.T).abs().max())
        out["single_iterations"] = one.n_iterations
        log(f"distributed ({tag}) (a) reading-sharded ICP 8,192 x 8,192 "
            f"over {D} rank(s), backend {mesh.backend}: {out['ms']:.2f} ms "
            f"per solve ({res.n_iterations} iterations; single-device "
            f"{out['single_ms']:.2f} ms, {one.n_iterations}); max |T - "
            f"T_single| {out['dT']:.3g}; collectives {stats['ops']}, "
            f"{stats['bytes_per_iteration']:.0f} B per iteration, "
            f"{stats['bytes_per_solve']} B per solve")
        assert out["dT"] <= 1e-4, out
        assert stats["bytes_per_iteration"] == 1208, stats
    return out


def dist_map(torch, mesh, map_np, skip: dict) -> dict:
    """(b): the map-sharded ICP, exhaustive blocks against the card's
    single-device solve, then banded blocks of the localization map."""
    from aicp_mapping_tpu_torch.cloud import Cloud
    from aicp_mapping_tpu_torch.eval.multichip import collective_stats
    from aicp_mapping_tpu_torch.geometry import se3
    from aicp_mapping_tpu_torch.ops.normals import radius_normals
    from aicp_mapping_tpu_torch.parallel import (
        map_sharded_point_to_plane_icp, morton_argsort_np)
    from aicp_mapping_tpu_torch.registration.icp import (point_to_plane_icp,
                                                         solver_plan)

    cfg = bench_config().icp
    dev = mesh.device
    eye, ratio = torch.eye(4, device=dev), torch.tensor(0.7, device=dev)
    with not_path(skip):
        ref, normals, moved, T_pert = dist_scene(torch, 16384, 9, dev)
    rp, rm = moved.points[::2].contiguous(), moved.mask[::2].contiguous()
    args = (rp, rm, ref.points, normals, ref.mask, eye, ratio)
    assert solver_plan(cfg, 8192, 8192, dev)["nn"] == (
        "kernel" if dev.type == "cuda" else "plain")
    mesh.reset_counts()
    res = map_sharded_point_to_plane_icp(mesh, *args, cfg)
    stats = collective_stats(mesh.counts(), res.n_iterations)
    out = dict(ms=host_ms(torch, lambda: map_sharded_point_to_plane_icp(
        mesh, *args, cfg)), stats=stats)
    # the localization map, Morton-ordered as the localizer holds it, its
    # normals by K2; the reading 8,192 of its points, moved
    pts = map_np[morton_argsort_np(map_np)]
    cap = -(-len(pts) // 1024) * 1024
    big = Cloud.from_numpy(pts, cap, dev)
    with not_path(skip):
        big_n, _, _ = radius_normals(big.points, big.mask, 0.4)
    step = cap // 8192
    T2 = se3.make_transform(se3.so3_exp(torch.tensor([0.0, 0.0, 0.02])),
                            torch.tensor([0.1, -0.06, 0.02])).to(dev)
    q = se3.transform_points(T2, big.points[::step][:8192].contiguous())
    qm = big.mask[::step][:8192].contiguous()
    assert solver_plan(cfg, 8192, cap // mesh.shape["points"], dev)[
        "nn"] == "banded"
    bargs = (q, qm, big.points, big_n, big.mask, eye, ratio)
    mesh.reset_counts()
    bres = map_sharded_point_to_plane_icp(mesh, *bargs, cfg)
    bstats = collective_stats(mesh.counts(), bres.n_iterations)
    out.update(banded_ms=host_ms(torch, lambda: map_sharded_point_to_plane_icp(
        mesh, *bargs, cfg), reps=3), banded_stats=bstats,
        banded_recovered=recovered(bres.T, T2))
    if mesh.rank == 0:
        with not_path(skip):
            one = point_to_plane_icp(*args, cfg)
        dd = float((res.match_dist2 - one.match_dist2).abs().max())
        dT = float((res.T - one.T).abs().max())
        bit = bool(torch.equal(res.match_dist2, one.match_dist2)
                   and torch.equal(res.T, one.T))
        log(f"distributed (b) map-sharded ICP 8,192 x 16,384 in 2 exhaustive "
            f"blocks (K1): {out['ms']:.2f} ms per solve, max |d2 - "
            f"d2_single| {dd:.3g}, max |T - T_single| {dT:.3g}, bit for "
            f"bit: {bit}; {stats['bytes_per_iteration']:.0f} B per "
            f"iteration ({stats['bytes_per_iteration'] / 8192:.1f} per "
            f"reading point)")
        t_err, r_err = out["banded_recovered"]
        log(f"distributed (b) map-sharded ICP 8,192 x {cap:,} in 2 banded "
            f"blocks of {cap // 2:,} (K5): {out['banded_ms']:.2f} ms per "
            f"solve, {bres.n_iterations} iterations, left of the "
            f"perturbation {t_err * 100:.3f} cm / {r_err:.4f} deg; "
            f"{bstats['bytes_per_iteration']:.0f} B per iteration")
        assert dd <= 1e-5 and dT <= 1e-4, (dd, dT)
        assert t_err < 0.02 and r_err < 0.5, (t_err, r_err)
        out.update(dd=dd, dT=dT, bit=bit)
    return out


def dist_localizer(torch, mesh, scene) -> dict:
    """(c): `ShardedMapLocalizer` over the ranks at the 65,536 crop, each
    pose within GT_TOL of the ground truth."""
    from aicp_mapping_tpu_torch.parallel import ShardedMapLocalizer

    map_np, items, gts = scene
    cfg = bench_config()
    sync(torch)
    t0 = time.perf_counter()
    loc = ShardedMapLocalizer(map_np, cfg.icp, mesh=mesh,
                              pipeline_config=cfg,
                              crop_radius=CROP_RADIUS,
                              out_capacity=65536)
    sync(torch)
    out = {"load_ms": (time.perf_counter() - t0) * 1e3,
           "block": loc.map_points.shape[0]}
    if mesh.rank != 0:
        loc.serve()
        return out
    frame_ms = []
    for i, ((_, pts, odom), gt) in enumerate(zip(items, gts)):
        local = sensor_frame(pts, odom)
        sync(torch)
        t0 = time.perf_counter()
        pose = loc.localize(local, odom, capacity=cfg.raw_capacity)
        sync(torch)
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        err = float(np.linalg.norm(pose[:3, 3] - gt[:3, 3]))
        res = loc.last_result
        log(f"distributed (c) localize frame {i}: {frame_ms[-1]:.1f} ms, "
            f"iters {res.n_iterations}, |t - gt| {err:.4f} m")
        assert res.registered and res.accepted, res
        assert err < GT_TOL, (i, err)
    pose = loc.total_correction @ np.asarray(items[-1][2], np.float32)
    out["crop_ms"] = host_ms(torch, lambda: loc.provide_reference(pose))
    loc.stop_serving()
    out["frame_ms"] = float(np.mean(frame_ms[1:]))
    return out


def dist_backend(torch, mesh, snapshot: str, skip: dict) -> dict:
    """(d): the SLAM back-end from the fixed seed-0 keyframes with its PGO
    edge-sharded and its BA observation-sharded; rank 0 then solves each
    of those graphs and problems unsharded on the card (PGO within rtol
    1e-3 / atol 1e-4, BA within rtol 1e-4 / atol 1e-5), and runs the
    unsharded back-end for its time and ATE."""
    from aicp_mapping_tpu_torch.eval import slam_accuracy as sa
    from aicp_mapping_tpu_torch.pipeline import mapper
    ba = importlib.import_module("aicp_mapping_tpu_torch.parallel.ba")

    if mesh.rank != 0:
        mapper.serve_backend(mesh, "graph")
        return {}
    pgo_calls, ba_calls = [], []

    def record(fn, sink):
        def run(*args, **kwargs):
            out = fn(*args, **kwargs)
            sink.append((args, kwargs, out))
            return out
        return run

    saved = [(mapper, "optimize_pose_graph_sharded", pgo_calls),
             (ba, "optimize_plane_ba_sharded", ba_calls)]
    originals = [getattr(m, n) for m, n, _ in saved]
    for m, n, sink in saved:
        setattr(m, n, record(getattr(m, n), sink))
    try:
        app, gt, meta = sa.load_frontend_snapshot(snapshot, device=mesh.device)
        sync(torch)
        t0 = time.perf_counter()
        sharded = sa.run_backend(app, gt, meta, mesh=mesh)
        sync(torch)
        backend_s = time.perf_counter() - t0
    finally:
        for (m, n, _), fn in zip(saved, originals):
            setattr(m, n, fn)
    mesh.stop_serving()
    with not_path(skip):
        dpgo, dba, plain, plain_s = backend_references(
            torch, mesh, snapshot, pgo_calls, ba_calls)
    log(f"distributed (d) SLAM back-end at seed 0 from fixed keyframes, PGO "
        f"and BA sharded over {mesh.shape['graph']} ranks: {backend_s:.2f} s "
        f"(unsharded {plain_s:.2f} s); {len(pgo_calls)} PGO solves, max "
        f"|pose - unsharded| {max(dpgo):.3g}; {len(ba_calls)} BA solves, "
        f"{max(dba):.3g}; ATE post-PGO {sharded['ate_post_pgo_m']} "
        f"(unsharded {plain['ate_post_pgo_m']}), post-BA "
        f"{sharded.get('ate_post_ba_m')} ({plain.get('ate_post_ba_m')})")
    return {"backend_s": backend_s, "plain_s": plain_s, "pgo": dpgo,
            "ba": dba}


def backend_references(torch, mesh, snapshot, pgo_calls, ba_calls):
    """(d)'s references on rank 0: each recorded sharded PGO and BA solve
    against its unsharded solve, then the unsharded back-end (its time)."""
    from aicp_mapping_tpu_torch.eval import slam_accuracy as sa
    ba = importlib.import_module("aicp_mapping_tpu_torch.parallel.ba")
    pg = importlib.import_module("aicp_mapping_tpu_torch.parallel.posegraph")

    dpgo = []
    for (graph, _), kw, (opt, _) in pgo_calls:
        kw = {k: v for k, v in kw.items() if k != "axis"}
        want, _ = pg.optimize_pose_graph(graph, **kw)
        dpgo.append(float((opt - want).abs().max()))
        torch.testing.assert_close(opt, want, rtol=1e-3, atol=1e-4)
    dba = []
    for (prob, _), kw, (opt, lms, _) in ba_calls:
        kw = {k: v for k, v in kw.items() if k != "axis"}
        want, wlms, _ = ba.optimize_plane_ba(prob, **kw)
        dba.append(float((opt - want).abs().max()))
        torch.testing.assert_close(opt, want, rtol=1e-4, atol=1e-5)
        torch.testing.assert_close(lms, wlms, rtol=1e-4, atol=1e-5)
    assert pgo_calls and ba_calls, (len(pgo_calls), len(ba_calls))
    app, gt, meta = sa.load_frontend_snapshot(snapshot, device=mesh.device)
    sync(torch)
    t0 = time.perf_counter()
    plain = sa.run_backend(app, gt, meta)
    sync(torch)
    return dpgo, dba, plain, time.perf_counter() - t0


def dist_rank(scene, snapshot: str, device: str = "cuda") -> dict:
    """One of the DIST_RANKS ranks of the distributed phase, (a)-(d); its
    "skip" holds the launches that were not the sharded path's."""
    import torch

    sys.path.insert(0, ROOT)
    from aicp_mapping_tpu_torch.parallel import make_mesh

    points = make_mesh(DIST_RANKS, "points", device=device)
    graph = make_mesh(DIST_RANKS, "graph", device=device)
    skip: dict = {}
    return {"backend": points.backend,
            "a": dist_reading(torch, points, "gloo", skip),
            "b": dist_map(torch, points, scene[0], skip),
            "c": dist_localizer(torch, points, scene),
            "d": dist_backend(torch, graph, snapshot, skip),
            "skip": skip}


def nccl_rank() -> dict:
    """(e): one rank on an NCCL mesh running (a)."""
    import torch

    sys.path.insert(0, ROOT)
    from aicp_mapping_tpu_torch.parallel import make_mesh

    mesh = make_mesh(1, "points")
    assert mesh.backend == "nccl", mesh.backend
    skip: dict = {}
    return dict(dist_reading(torch, mesh, "nccl", skip), skip=skip)


def frontend_snapshot(directory: str) -> str:
    """The seed-0 SLAM front-end's keyframes, saved for (d)'s ranks: made
    before the distributed path's counts start, as its input."""
    from aicp_mapping_tpu_torch.eval import slam_accuracy as sa

    snapshot = os.path.join(directory, "slam_seed0.npz")
    app, gt, meta = sa.run_frontend(seed=0, device="cuda")
    sa.save_frontend_snapshot(app, gt, meta, snapshot)
    return snapshot


def run_distributed(torch, scene, one_rank: dict, snapshot: str) -> dict:
    """The distributed phase; returns the launch counts of its ranks'
    sharded work (each rank's inputs and references taken out)."""
    from aicp_mapping_tpu_torch.parallel import launch

    t0 = time.perf_counter()
    ranks = launch(dist_rank, DIST_RANKS, scene, snapshot,
                   device="cuda", timeout_s=DIST_TIMEOUT_S)
    wall_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    nccl = launch(nccl_rank, 1, device="cuda", timeout_s=300.0)
    nccl_s = time.perf_counter() - t0
    r0 = ranks[0].value
    assert r0["backend"] == "gloo", r0["backend"]
    a, b, c, d = r0["a"], r0["b"], r0["c"], r0["d"]
    per_rank = [{k: r.launches[k] - r.value["skip"].get(k, 0)
                 for k in r.launches} for r in ranks + nccl]
    launches = {k: sum(r[k] for r in per_rank) for k in per_rank[0]}
    per_rank, nccl_launches = per_rank[:-1], per_rank[-1]
    log(f"distributed phase on the card ({gpu_line()}): {DIST_RANKS} ranks "
        f"share it over gloo ({wall_s:.1f} s, rank start-up included), 1 "
        f"rank on NCCL ({nccl_s:.1f} s); sharded-path launches per rank "
        f"{per_rank}, NCCL rank {nccl_launches}")
    log(f"distributed (a): {a['ms']:.2f} ms per solve on 2 ranks (gloo), "
        f"{nccl[0].value['ms']:.2f} on 1 rank (NCCL), single-device "
        f"{a['single_ms']:.2f}; {a['stats']['ops']} collectives per solve "
        f"of {a['iterations']} iterations, "
        f"{a['stats']['bytes_per_iteration']:.0f} B per iteration; NCCL "
        f"rank max |T - T_single| {nccl[0].value['dT']:.3g}")
    log(f"distributed (c) localizer: load {c['load_ms']:.1f} ms (blocks of "
        f"{c['block']:,} rows, K2 normals per rank), crop {c['crop_ms']:.2f} "
        f"ms, {c['frame_ms']:.2f} ms/frame over 2 ranks; 1-rank localizer "
        f"load {one_rank['load_ms']:.1f} ms, {one_rank['frame_ms']:.2f} "
        f"ms/frame (two ranks on one card share its SMs: these times "
        f"record the path, not scaling)")
    log(f"distributed (d) back-end: {d['backend_s']:.2f} s sharded, "
        f"{d['plain_s']:.2f} s unsharded")
    # every kernel of the path ran on the ranks' card
    assert all(sum(r[k] for r in per_rank) > 0 for k in DIST_KERNELS), \
        per_rank
    return launches


def drive(name: str, fn, expect, ranks: bool = False) -> dict:
    """Run one main path with the launch counts set to 0 just before it;
    returns its counts and fails if a kernel of the path never launched.
    With `ranks`, `fn` returns the launch counts of the ranks it started
    (each a process of its own, whose counts began at 0), and they are
    added to this process's."""
    from aicp_mapping_tpu_torch import _kernels

    _kernels.reset_launch_counts()
    extra = fn()
    counts = _kernels.launch_counts()
    if ranks:
        counts = {k: counts[k] + extra[k] for k in counts}
    log(f"launches on the {name} path: {counts}")
    assert all(counts[k] > 0 for k in expect), (name, counts)
    return counts


def main() -> int:
    import tempfile

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
    scene = map_scene()
    nn = nn_api_scenes(torch)
    check_kernels(torch, results)
    check_propagation(torch, results)
    check_banded_kernels(torch, results, scene)
    check_nn_api_kernels(torch, results, nn)
    check_tie_scenes(torch)

    # 4-17. the main paths, each with its own launch counts
    bench_ms, stream, one_rank, viz = {}, {}, {}, {}
    paths = [
        drive("frame", lambda: bench_ms.update(
            off=run_bench_slice(torch)), ("nn_payload", "banded_moments")),
        drive("icp graph", lambda: bench_ms.update(run_icp_graph(torch)),
              ("nn_payload", "banded_moments")),
        drive("golden", lambda: run_golden(torch),
              ("nn_payload", "radius_moments")),
        drive("localization", lambda: (
            one_rank.update(run_localization(torch, scene, 65536)),
            run_localization(torch, scene, 131072)),
            ("banded_nn_payload_stream", "banded_moments")),
        drive("golden map modes", lambda: run_golden_maps(torch),
              ("nn_payload", "radius_moments")),
        drive("golden risk", lambda: run_golden_risk(torch),
              ("nn_payload", "radius_moments")),
        drive("frame with failure prediction", lambda: bench_ms.update(
            on=run_bench_slice(torch, risk=True)),
            ("nn_payload", "banded_moments", "label_propagation")),
        drive("register", lambda: run_register(torch),
              ("nn_argmin", "banded_nn_payload_stream", "nn_payload")),
        drive("nn api", lambda: run_nn_api(torch, nn),
              ("nn_payload", "banded_nn_payload_stream", "banded_nn_argmin")),
        drive("slam", lambda: run_slam(torch),
              ("nn_payload", "radius_moments")),
        drive("stream", lambda: stream.update(run_stream(torch)),
              ("nn_payload", "banded_moments")),
        drive("kitti", lambda: run_kitti(torch),
              ("nn_payload", "banded_moments")),
        drive("accuracy", lambda: run_accuracy_phase(torch),
              ("nn_payload",)),
        drive("pairs and checkpoints", lambda: run_pairs_and_checkpoints(
            torch), ("nn_payload", "radius_moments")),
        drive("viz", lambda: viz.update(run_viz(torch)), VIZ_KERNELS),
    ]
    dist_dir = tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build"))
    snapshot = frontend_snapshot(dist_dir.name)   # an input, not counted
    paths.append(drive("distributed", lambda: run_distributed(
        torch, scene, one_rank, snapshot), DIST_KERNELS, ranks=True))
    dist_dir.cleanup()
    log(f"bench operating point on the card: {bench_ms['off']:.2f} ms/frame"
        f" without failure prediction, {bench_ms['on']:.2f} with it")
    log(f"stream cell on the card ({gpu_line()}): "
        f"{stream['scans_per_s']:.2f} scans/s pipelined, "
        f"{stream['sync_ms']:.2f} ms/frame synchronous, "
        f"{stream['prep_ms']:.2f} ms wire preparation per cloud, "
        f"{sum(stream['launches_per_frame'].values()):.1f} port kernel "
        "launches per frame")
    log(f"viz phase on the card ({gpu_line()}): {viz['sink_ms']:.2f} "
        f"ms/frame with a sink, {viz['none_ms']:.2f} without; "
        f"{viz['reads']['sink']:.1f} and {viz['reads']['none']:.1f} "
        f"device-to-host copies per frame; {viz['phase_s']:.1f} s")
    counts = {k: sum(c[k] for c in paths) for k in KERNELS}

    # 18. the main paths went through every kernel
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
