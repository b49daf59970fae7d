"""Trajectory-accuracy regression on the outdoor-scale synthetic drive,
PyTorch port of `aicp_mapping_tpu.eval.accuracy`.

The raycast urban drive (`tools.urban.urban_sequence`: a 64-beam scanner
at road speed with 90-degree turns and drifting odometry) runs through the
App; reported are the KITTI segment errors (t_err %, r_err deg/m), ATE
RMSE and RPE of the pipeline's corrected trajectory and of odometry alone,
so the result shows how much of the injected drift the pipeline removes.
Runs on the card unless the caller asks for the CPU.

    python -m aicp_mapping_tpu_torch.eval.accuracy --frames 200 --out r.json
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np

from .kitti import ate_rmse, average_errors, calc_sequence_errors, rpe


def accuracy_config():
    """The outdoor operating point: debug working mode (open-loop replay
    integrates the accumulated correction into each reading), kNN
    region-growing segmentation at 65,536 raw / 16,384 voxels / 8,192
    filtered points, and normal-space trimming (on the ground-dominated
    scene a global trim quantile eats the facade correspondences under
    horizontal drift)."""
    from ..pipeline.config import PipelineConfig

    cfg = PipelineConfig(
        working_mode="debug",
        segmentation_method="region_growing",
        raw_capacity=65536,
        downsample_capacity=16384,
        filtered_capacity=8192,
    )
    cfg.icp = dataclasses.replace(cfg.icp, trim_normal_space=True)
    return cfg


def trajectory_metrics(gt: np.ndarray, traj: np.ndarray) -> dict:
    """KITTI segment errors over 50-200 m, ATE (aligned and not) and RPE
    over 10 frames of `traj` against `gt`."""
    out = average_errors(calc_sequence_errors(gt, traj,
                                              lengths=(50, 100, 150, 200)))
    out["ate_rmse_m"] = ate_rmse(gt, traj)
    out["ate_rmse_noalign_m"] = ate_rmse(gt, traj, align=False)
    out.update(rpe(gt, traj, delta=10))
    return out


def run_accuracy(n_frames: int = 200, seed: int = 0, cfg=None,
                 seq_kwargs: dict | None = None, device="cuda") -> dict:
    from ..pipeline.app import App, check_device
    from ..pipeline.sequence import SequenceRunner
    from ..tools.urban import urban_sequence

    dev = check_device(device, "run_accuracy")
    cfg = cfg or accuracy_config()
    items, gt = urban_sequence(n_frames=n_frames, seed=seed,
                               **(seq_kwargs or {}))
    app = App(cfg, device=dev)
    try:
        frames = SequenceRunner(app).run_clouds(items)
    finally:
        app.close()

    est = np.stack([np.asarray(f.corrected_pose) for f in frames])
    odom = np.stack([it[2] for it in items])
    n = min(len(est), len(gt))
    est, odom, gtp = est[:n], odom[:n], gt[:n]
    dist = float(np.sum(np.linalg.norm(
        np.diff(gtp[:, :3, 3], axis=0), axis=1)))
    return {
        "n_frames": n,
        "track_length_m": round(dist, 1),
        "dropped_frames": sum(1 for f in frames if not f.accepted),
        "pipeline": trajectory_metrics(gtp, est),
        "odometry_only": trajectory_metrics(gtp, odom),
    }


def main(argv=None) -> int:
    import argparse
    import time

    p = argparse.ArgumentParser(description="trajectory accuracy regression")
    p.add_argument("--frames", type=int, default=200)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="")
    p.add_argument("--device", default="cuda",
                   help="torch device (default: the card)")
    args = p.parse_args(argv)

    t0 = time.perf_counter()
    result = run_accuracy(n_frames=args.frames, seed=args.seed,
                          device=args.device)
    result["wall_seconds"] = round(time.perf_counter() - t0, 1)
    text = json.dumps(result, indent=1)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
