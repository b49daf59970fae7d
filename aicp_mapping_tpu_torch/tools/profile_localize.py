"""Profile map-scale localization on one NVIDIA GPU.

    python3 -m aicp_mapping_tpu_torch.tools.profile_localize [--frames 8]

The cells are `chip_smoke.py`'s map-scale localization, defined here for
both: a 60 m room mapped at 262,140 points (padded to 262,144), scans of
the same room along the bench sequence localized at the bench operating
point, the map cropped to 65,536 and to 131,072 points. For each crop the
localizer localizes 2 warm-up frames, then

1. `--frames` synchronised `localize` calls, timed by the host clock;
2. as many again with each stage synchronised and timed on its own: the
   crop (`provide_reference`), the prefilter (voxel + hough, `_prefilter`)
   and ICP (`point_to_plane_icp`);
3. `--frames` calls under `torch.profiler`: device time per frame (CUDA
   kernels, copies and fills, from the exported trace), the kernels that
   take most of it, kernel launches per frame, and the port's own kernels'
   device ms and launches per frame by launch grid. The busy share is that
   device time over the mean wall time of step 1.

Prints one JSON object per crop and writes them to `--out`. Exits non-zero
without a result when CUDA is unavailable.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

# Map-scale localization: a 60 m room mapped at 262,140 points (padded to
# 262,144) and scans of the same room (other samples) at the bench size.
MAP_ARGS = dict(n=262144, size=60.0, seed=1, noise=0.01)
SCAN_ARGS = dict(n_points=60000, step=1.2, seed=0, world_size=60.0,
                 sensor_range=40.0, noise=0.02)
CROP_RADIUS = 40.0                # the sensor range
CROPS = (65536, 131072)
WARMUP = 2


def bench_config():
    """The benchmark's operating point (bench.py:260-281) on the raw path."""
    from ..pipeline.config import PipelineConfig

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
    from ..pipeline.sequence import synthetic_sequence
    from .synthetic import room_cloud

    items, gts = synthetic_sequence(n_frames=n_frames, **SCAN_ARGS)
    return room_cloud(**MAP_ARGS), items, gts


def sensor_frame(pts, odom):
    """Odometry-frame points back to the sensor frame."""
    odom = np.asarray(odom, np.float32)
    return ((pts - odom[:3, 3]) @ odom[:3, :3]).astype(np.float32)


def _staged(torch, loc, stage_ms):
    """Wrap the localizer's crop and the frame step's prefilter and ICP so
    that each call is synchronised and its host time added to
    `stage_ms[name]`; returns a function that undoes the wrapping."""
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

    saved = (fused._prefilter, fused.point_to_plane_icp)
    loc.provide_reference = timed("crop", loc.provide_reference)
    fused._prefilter = timed("prefilter", fused._prefilter)
    fused.point_to_plane_icp = timed("icp", fused.point_to_plane_icp)

    def undo():
        del loc.provide_reference
        fused._prefilter, fused.point_to_plane_icp = saved
    return undo


def _device_events(trace_path):
    """(category, name, µs, grid) of every device event — kernel, copy or
    fill — in an exported profiler trace; grid is a kernel's launch grid
    (x, y, z), () for the others."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    return [(e["cat"], e["name"], float(e["dur"]),
             tuple(e.get("args", {}).get("grid", ())))
            for e in events if e.get("ph") == "X"
            and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]


def _port_kernels(events, frames: int) -> dict:
    """Device ms and launches per frame of the port's own kernels (namespace
    aicp), by kernel and launch grid: a 1-NN scan's grid is query blocks x
    splits, so the coarse and fine ICP phases' launches show apart."""
    rows = collections.defaultdict(lambda: [0.0, 0])
    for cat, name, us, grid in events:
        m = re.search(r"aicp::(?:\(anonymous namespace\)::)?(\w+(<[^>]*>)?)",
                      name)
        if cat == "kernel" and m:
            row = rows[f"{m.group(1)} grid {'x'.join(map(str, grid))}"]
            row[0] += us
            row[1] += 1
    return {k: dict(ms=ms / 1e3 / frames, launches=n / frames)
            for k, (ms, n) in sorted(rows.items())}


def profile_crop(torch, scene, out_capacity: int, frames: int) -> dict:
    from ..parallel import ShardedMapLocalizer

    map_np, items, _ = scene
    cfg = bench_config()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loc = ShardedMapLocalizer(map_np, cfg.icp, device="cuda",
                              pipeline_config=cfg, crop_radius=CROP_RADIUS,
                              out_capacity=out_capacity)
    torch.cuda.synchronize()
    load_ms = (time.perf_counter() - t0) * 1e3
    frames_left = iter(items)

    def localize():
        _, pts, odom = next(frames_left)
        loc.localize(sensor_frame(pts, odom), odom,
                     capacity=cfg.raw_capacity)

    for _ in range(WARMUP):
        localize()
    wall = []
    for _ in range(frames):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        localize()
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)

    stage_ms = collections.defaultdict(float)
    undo = _staged(torch, loc, stage_ms)
    staged = []
    try:
        for _ in range(frames):
            t0 = time.perf_counter()
            localize()
            staged.append((time.perf_counter() - t0) * 1e3)
    finally:
        undo()

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(frames):
            localize()
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
        crop=out_capacity, frames=frames, load_ms=load_ms,
        localize_ms=wall, localize_ms_mean=float(np.mean(wall)),
        staged_ms_mean=float(np.mean(staged)),
        stage_ms_per_frame={k: v / frames for k, v in stage_ms.items()},
        device_ms_per_frame=device_ms,
        busy_share=device_ms / float(np.mean(wall)),
        kernel_launches_per_frame=sum(
            1 for cat, _, _, _ in events if cat == "kernel") / frames,
        top_device_ms_per_frame={name[:80]: us / 1e3 / frames
                                 for name, us in top},
        port_kernels_per_frame=_port_kernels(events, frames))


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--out", default="chiprun_out/profile_localize.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_localize: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    from .. import _kernels

    # start the CUDA context and load the kernels before any load is timed
    torch.zeros(1, device="cuda")
    _kernels.library()
    scene = map_scene(n_frames=WARMUP + 3 * args.frames)
    rows = []
    for crop in CROPS:
        row = dict(device=gpu, **profile_crop(torch, scene, crop,
                                              args.frames))
        print(json.dumps(row), flush=True)
        rows.append(row)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
