"""Profile the App's frame at the bench operating point on one NVIDIA GPU,
without and with failure prediction, the streaming front-end, or the
KITTI frame.

    python3 -m aicp_mapping_tpu_torch.tools.profile_frame [--frames 8]
    python3 -m aicp_mapping_tpu_torch.tools.profile_frame --pipelined
    python3 -m aicp_mapping_tpu_torch.tools.profile_frame --kitti

The cell is `chip_smoke.py`'s bench slice: 60,000-point scans of the bench
sequence (`profile_localize.SCAN_ARGS`), 65,536 raw / 16,384 voxels /
8,192 filtered points, coarse-to-fine ICP; with `failure_prediction_mode`
and the shipped classifier `data/classification/risk_classifier.npz` in
the second row. For each row one App processes the bootstrap and 2
warm-up frames, then

1. `--frames` synchronous `process_cloud` calls, timed by the host clock;
2. as many again with each stage synchronised and timed on its own: the
   prefilter (voxel + hough), the risk stage (FOV overlap, alignability,
   classifier) and ICP; with the label-propagation rounds per frame (each a
   host read) and the port's kernel launches per frame;
3. `--frames` calls under `torch.profiler`: device time per frame (CUDA
   kernels, copies and fills), the kernels that take most of it, and all
   device kernel launches per frame, and the port's own kernels' device
   ms and launches per frame by launch grid (K1's coarse and fine ICP
   launches apart). The busy share is that device time over the mean wall
   time of step 1.

`--pipelined` profiles the stream cell instead (`profile_localize.
stream_config`, bench.py's own operating point): the 40 frames of the
bench sequence through `SequenceRunner(pipelined=True).run_clouds(...,
batch_h2d=16)` as `bench.py:bench_app` drives them — a warm-up pass, then
3 timed passes over frames 2-39 on the same App (scans/s, their median),
the port's kernel launches per frame, and one more pass under
`torch.profiler`: device time per frame, the busy share (that device time
over the timed passes' median wall time per frame; the profiler slows the
pass it records), kernel launches and host reads (device-to-host copies)
per frame.

`--kitti` profiles the KITTI frame as `eval.kitti_runner` runs it: the
KITTI default config (131,072 raw / 32,768 voxels / 16,384 filtered
points, normal-space trim), scans of `make_urban_world(seed=0)` by the
64-beam scanner at 2,048 azimuths along `drive_trajectory(speed=10.0)`,
each uploaded, its ground removed on the device (0.5 m cells, 256 x 256)
and moved to a GPS-grade prior (the truth with 0.2 m of noise), through
the same three steps; the staged pass also times the ground removal.

Prints one JSON object per row and writes them to `--out`. Exits non-zero
without a result when CUDA is unavailable.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

from .profile_localize import (SCAN_ARGS, _device_events, _port_kernels,
                               bench_config)

WARMUP = 2
CLASSIFIER = os.path.join(os.path.dirname(__file__), "..", "..", "data",
                          "classification", "risk_classifier.npz")


def _staged(torch, stage_ms):
    """Synchronise and time the frame step's prefilter, risk stage and ICP
    (module globals it looks up at each call); returns the undo."""
    from ..pipeline import fused

    def timed(name, fn):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            stage_ms[name] += (time.perf_counter() - t0) * 1e3
            return out
        return run

    names = ("_prefilter", "risk_stage", "point_to_plane_icp")
    saved = {n: getattr(fused, n) for n in names}
    for n in names:
        setattr(fused, n, timed(n, saved[n]))

    def undo():
        for n in names:
            setattr(fused, n, saved[n])
    return undo


def kitti_items(n: int) -> list:
    """(utime, sensor-frame scan, prior pose) of the KITTI cell's `n`
    frames: the drive relative to its first pose, priors 0.2 m off in x
    and y."""
    from .urban import drive_trajectory, make_urban_world, velodyne_scan

    world = make_urban_world(seed=0)
    gt = drive_trajectory(n, world, speed=10.0)
    rel = np.linalg.inv(gt[0])[None] @ gt
    rng = np.random.default_rng(0)
    priors = rel.astype(np.float32)
    priors[:, :2, 3] += rng.normal(0, 0.2, (n, 2)).astype(np.float32)
    return [(i * 100_000, velodyne_scan(world, T, n_azimuth=2048, seed=i),
             priors[i]) for i, T in enumerate(gt)]


def profile_row(torch, items, frames: int, risk: bool = False,
                kitti: bool = False) -> dict:
    from .. import _kernels
    from ..cloud import AlignedCloud, Cloud
    from ..eval.kitti_runner import kitti_config
    from ..ops import segmentation
    from ..ops.ground import GroundFilterConfig, remove_ground
    from ..pipeline.app import App

    cfg = kitti_config() if kitti else bench_config()
    if risk:
        cfg.failure_prediction_mode = True
        cfg.classifier_path = CLASSIFIER
    app = App(cfg, device="cuda")
    frames_left = iter(items)
    gcfg = GroundFilterConfig(cell_size=0.5, grid_dim=256)
    stage_ms = collections.defaultdict(float)
    staged = []

    def step():
        utime, pts, pose = next(frames_left)
        if not kitti:
            app.process_cloud(AlignedCloud.create(utime, Cloud.from_numpy(
                pts, capacity=cfg.raw_capacity), pose))
            return
        cloud = Cloud.from_numpy(pts, capacity=cfg.raw_capacity,
                                 device="cuda")
        if staged:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        non_ground, _ = remove_ground(cloud.points, cloud.mask, gcfg)
        if staged:
            torch.cuda.synchronize()
            stage_ms["remove_ground"] += (time.perf_counter() - t0) * 1e3
        cloud = Cloud(cloud.points, non_ground).transform(
            torch.as_tensor(pose, device="cuda"))
        app.process_cloud(AlignedCloud.create(utime, cloud, pose))

    for _ in range(1 + WARMUP):
        step()
    wall = []
    for _ in range(frames):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)

    undo = _staged(torch, stage_ms)
    segmentation.reset_propagation_rounds()
    _kernels.reset_launch_counts()
    staged.append(True)
    try:
        for _ in range(frames):
            step()
    finally:
        staged.clear()
        undo()
    rounds = segmentation.propagation_rounds()
    port_launches = _kernels.launch_counts()

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(frames):
            step()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        events = _device_events(path)
    if not events:
        raise RuntimeError("the profiler recorded no device events")
    by_name = collections.defaultdict(float)
    for _, name, us, _ in events:
        by_name[name] += us
    device_ms = sum(by_name.values()) / 1e3 / frames
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return dict(
        cell="kitti" if kitti else "bench",
        failure_prediction=risk, frames=frames, frame_ms=wall,
        frame_ms_mean=float(np.mean(wall)),
        stage_ms_per_frame={k: v / frames for k, v in stage_ms.items()},
        propagation_rounds_per_frame=rounds["rounds"] / frames,
        port_kernel_launches_per_frame={k: v / frames for k, v in
                                        port_launches.items() if v},
        registered=sum(1 for r in app.frames[-3 * frames:] if r.registered),
        device_ms_per_frame=device_ms,
        busy_share=device_ms / float(np.mean(wall)),
        kernel_launches_per_frame=sum(
            1 for cat, _, _, _ in events if cat == "kernel") / frames,
        top_device_ms_per_frame={name[:80]: us / 1e3 / frames
                                 for name, us in top},
        port_kernels_per_frame=_port_kernels(events, frames))


STREAM_FRAMES = 40      # bench.py --frames
STREAM_PASSES = 3       # bench.py's trials


def profile_stream(torch, items) -> dict:
    """The streaming front-end at bench.py's operating point: scans/s of
    the timed passes over frames 2-39, launches, device time and host reads
    per frame."""
    from .. import _kernels
    from ..ops import segmentation
    from ..pipeline.app import App
    from ..pipeline.sequence import SequenceRunner
    from .profile_localize import stream_config

    cfg = stream_config()
    batch = cfg.pipeline_depth // 2
    app = App(cfg, device="cuda")
    try:
        runner = SequenceRunner(app, pipelined=True)
        runner.run_clouds(items[:2])
        runner.run_clouds(items[2:], batch_h2d=batch)
        n = len(items) - 2
        _kernels.reset_launch_counts()
        segmentation.reset_propagation_rounds()
        rates, walls = [], []
        for _ in range(STREAM_PASSES):
            t0 = time.perf_counter()
            runner.run_clouds(items[2:], batch_h2d=batch)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            rates.append(n / walls[-1])
        launches = _kernels.launch_counts()
        rounds = segmentation.propagation_rounds()

        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            runner.run_clouds(items[2:], batch_h2d=batch)
            torch.cuda.synchronize()
            profiled_s = time.perf_counter() - t0
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            events = _device_events(path)
    finally:
        app.close()
    if not events:
        raise RuntimeError("the profiler recorded no device events")
    by_name = collections.defaultdict(float)
    for _, name, us, _ in events:
        by_name[name] += us
    device_ms = sum(by_name.values()) / 1e3 / n
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return dict(
        cell="stream", pipeline_depth=cfg.pipeline_depth, batch_h2d=batch,
        frames_per_pass=n, passes=STREAM_PASSES, scans_per_s=rates,
        scans_per_s_median=float(np.median(rates)),
        port_kernel_launches_per_frame={
            k: v / (STREAM_PASSES * n) for k, v in launches.items() if v},
        propagation_rounds_per_frame=rounds["rounds"] / (STREAM_PASSES * n),
        accepted_last_pass=sum(1 for r in app.frames[-n:] if r.accepted),
        profiled_pass_s=profiled_s, device_ms_per_frame=device_ms,
        busy_share=device_ms * float(np.median(rates)) / 1e3,
        kernel_launches_per_frame=sum(
            1 for cat, _, _, _ in events if cat == "kernel") / n,
        host_reads_per_frame=sum(
            1 for cat, name, _, _ in events
            if cat == "gpu_memcpy" and "DtoH" in name) / n,
        top_device_ms_per_frame={name[:80]: us / 1e3 / n
                                 for name, us in top},
        port_kernels_per_frame=_port_kernels(events, n))


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--pipelined", action="store_true",
                    help="profile the streaming front-end (the stream cell)")
    ap.add_argument("--kitti", action="store_true",
                    help="profile the KITTI frame (the KITTI default "
                         "config, ground removal on the card)")
    ap.add_argument("--out", default=None,
                    help="default chiprun_out/profile_frame.json, "
                         "profile_stream.json with --pipelined, "
                         "profile_kitti.json with --kitti")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_frame: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    from .. import _kernels
    from ..pipeline.sequence import synthetic_sequence

    torch.zeros(1, device="cuda")
    _kernels.library()
    rows = []
    if args.pipelined:
        items, _ = synthetic_sequence(n_frames=STREAM_FRAMES, **SCAN_ARGS)
        rows.append(dict(device=gpu, **profile_stream(torch, items)))
        print(json.dumps(rows[-1]), flush=True)
    elif args.kitti:
        items = kitti_items(1 + WARMUP + 3 * args.frames)
        rows.append(dict(device=gpu, **profile_row(
            torch, items, args.frames, kitti=True)))
        print(json.dumps(rows[-1]), flush=True)
    else:
        items, _ = synthetic_sequence(n_frames=1 + WARMUP + 3 * args.frames,
                                      **SCAN_ARGS)
        for risk in (False, True):
            rows.append(dict(device=gpu, **profile_row(
                torch, items, args.frames, risk)))
            print(json.dumps(rows[-1]), flush=True)
    out = args.out or ("chiprun_out/profile_stream.json" if args.pipelined
                       else "chiprun_out/profile_kitti.json" if args.kitti
                       else "chiprun_out/profile_frame.json")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
