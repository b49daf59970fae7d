"""Time the plane BA solve of the urban drive on one NVIDIA GPU.

    python3 -m aicp_mapping_tpu_torch.tools.profile_ba [--seed 0] [--reps 20]

The problem is the one `eval.slam_accuracy.run_backend` gives
`parallel.ba.optimize_plane_ba` after its two PGO rounds (`chip_smoke.py`'s
"slam" phase, 4 Gauss-Newton steps). The solve runs once to warm up, then
`--reps` times with the device synchronised around each. Prints one JSON
object: the package timed, the problem's sizes, each solve's ms and their
median, and the card's name and power limit. Exits non-zero without a
result when CUDA is unavailable.

The imports are absolute, so the script also runs as a file and then times
the package that comes first on `PYTHONPATH`: another checkout's, for a
comparison in one session on one card.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("profile_ba: CUDA is not available", file=sys.stderr)
        return 1
    import aicp_mapping_tpu_torch
    from aicp_mapping_tpu_torch.eval import slam_accuracy as sa
    from aicp_mapping_tpu_torch.parallel import ba

    solve, calls = ba.optimize_plane_ba, []

    def record(*a, **kw):
        calls.append((a, kw))
        return solve(*a, **kw)

    ba.optimize_plane_ba = record
    try:
        app, gt, meta = sa.run_frontend(seed=args.seed, device="cuda")
        sa.run_backend(app, gt, meta)
    finally:
        ba.optimize_plane_ba = solve
    if len(calls) != 1:
        raise RuntimeError(f"the back-end made {len(calls)} BA solves")
    (a, kw), = calls

    def once() -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solve(*a, **kw)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    once()
    ms = [once() for _ in range(args.reps)]
    problem = a[0]
    out = dict(
        package=os.path.dirname(aicp_mapping_tpu_torch.__file__),
        seed=args.seed, n_poses=problem.n_poses,
        n_landmarks=problem.n_landmarks,
        n_observations=int(problem.obs_k.shape[0]),
        gn_iters=kw.get("gn_iters"), solve_ms=ms,
        median_ms=statistics.median(ms),
        gpu=subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, check=True).stdout.strip())
    print(json.dumps(out))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
