"""Profile the SLAM accuracy drive on one NVIDIA GPU.

    python3 -m aicp_mapping_tpu_torch.tools.profile_slam [--seed 0]

The cell is `chip_smoke.py`'s "slam" phase: `eval.slam_accuracy`'s urban
drive (44 frames, 34 delivered; region growing at 16,384 raw / 8,192
voxels / 4,096 filtered / 65,536 map points), the front-end through
`frontend_on` and the back-end through `run_backend` (two rounds of
closure proposal + PGO, then plane BA). The drive runs three times — the
card's runs are deterministic, so each does the same work: once to warm
up (first-use costs), then

1. each part timed by the host clock, the device synchronised before and
   after it: front-end and back-end wall seconds;
2. under `torch.profiler` (device activity only): each part's device
   time, its busy share (that device time over step 1's wall time), its
   device kernel launches, the kernels that take most of its device time,
   and the port's own kernels by launch grid.

Prints one JSON object and writes it to `--out`. Exits non-zero without a
result when CUDA is unavailable.
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

from .profile_localize import _device_events, _port_kernels


def _drive(torch, seed: int, profiled: bool) -> dict:
    """The drive once; per part its wall seconds, and with `profiled` its
    device events."""
    from ..eval import slam_accuracy as sa

    items, gt, meta = sa.urban_drive(seed=seed)
    parts = {}

    def part(name, fn):
        if not profiled:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            parts[name] = dict(wall_s=time.perf_counter() - t0)
            return out
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            out = fn()
            torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            parts[name] = dict(events=_device_events(path))
        return out

    app, gt, meta = part("frontend", lambda: sa.frontend_on(items, gt, meta))
    out = part("backend", lambda: sa.run_backend(app, gt, meta))
    return dict(parts=parts, result=out, frames=len(items))


def _summary(events, wall_s: float) -> dict:
    if not events:
        raise RuntimeError("the profiler recorded no device events")
    by_name = collections.defaultdict(float)
    for _, name, us, _ in events:
        by_name[name] += us
    device_ms = sum(by_name.values()) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return dict(
        wall_s=wall_s, device_ms=device_ms,
        busy_share=device_ms / 1e3 / wall_s,
        kernel_launches=sum(1 for cat, _, _, _ in events if cat == "kernel"),
        top_device_ms={name[:80]: us / 1e3 for name, us in top},
        port_kernels=_port_kernels(events, 1))


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="chiprun_out/profile_slam.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_slam: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    from .. import _kernels

    torch.zeros(1, device="cuda")
    _kernels.library()
    _drive(torch, args.seed, profiled=False)
    plain = _drive(torch, args.seed, profiled=False)
    prof = _drive(torch, args.seed, profiled=True)
    assert prof["result"] == plain["result"], (prof["result"],
                                               plain["result"])
    row = dict(device=gpu, seed=args.seed, frames=plain["frames"],
               result=plain["result"])
    for name in ("frontend", "backend"):
        row[name] = _summary(prof["parts"][name]["events"],
                             plain["parts"][name]["wall_s"])
    row["frontend"]["ms_per_frame"] = (row["frontend"]["wall_s"] * 1e3
                                       / plain["frames"])
    print(json.dumps(row), flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(row, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
