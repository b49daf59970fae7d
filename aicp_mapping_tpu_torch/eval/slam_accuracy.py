"""SLAM back-end accuracy regression, PyTorch port of
`aicp_mapping_tpu.eval.slam_accuracy` on its overlap-gate path: a drifted
urban circuit with a sensor outage and an odometry fault through the whole
stack (AICP front-end with region growing -> keyframes -> relative-frame
loop closures -> PGO -> plane BA), scored by keyframe ATE against ground
truth before and after the back-end.

The front-end and the back-end are separate entry points: `run_frontend`
can snapshot its keyframes (`--snapshot out.npz`) and
`run_backend_from_snapshot` replays the back-end on one. The snapshot
format is the JAX package's, so a snapshot written by either package
replays in the other. The classifier-gate variant (`--classifier-gate`)
needs `data/classification/risk_classifier_urban.npz`, which the
repository does not hold; it raises.

    python -m aicp_mapping_tpu_torch.eval.slam_accuracy --out result.json \\
        [--device cpu]
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np

URBAN_CLASSIFIER = "data/classification/risk_classifier_urban.npz"
# The back-end's closure proposal on this drive (`run_backend`).
MAPPER_KW = dict(min_keyframe_gap=2, min_loop_overlap=20.0,
                 max_loop_distance=8.0)


def _keyframe_ate(kfs, gt_poses: np.ndarray,
                  utime_step: int = 100_000) -> float:
    """Umeyama-aligned RMS translation error of keyframe poses against
    ground truth, keyframes matched to ground truth by utime."""
    from .kitti import ate_rmse

    gt_k = np.stack([gt_poses[kf.utime // utime_step] for kf in kfs])
    est = np.stack([np.asarray(kf.pose) for kf in kfs])
    return float(ate_rmse(gt_k, est, align=True))


def loop_circuit_poses(world, lap_frames: int, n_frames: int,
                       step: float) -> np.ndarray:
    """Closed square circuit around one city block: 4 equal legs with 90
    deg corner turns, repeated until n_frames. Returns (n, 4, 4) float32
    ground-truth poses."""
    leg = lap_frames // 4
    turn_frames = max(2, leg // 4)
    poses = []
    T = np.eye(4, dtype=np.float64)
    k = int(np.floor(2 * world.extent / world.pitch))
    T[:2, 3] = [-world.extent + world.pitch,
                -world.extent + (k // 2) * world.pitch]
    for i in range(n_frames):
        poses.append(T.astype(np.float32).copy())
        phase = i % leg
        yaw = (np.pi / 2) / turn_frames if phase >= leg - turn_frames else 0.0
        c, s = np.cos(yaw), np.sin(yaw)
        dR = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
        T[:3, :3] = T[:3, :3] @ dR
        T[:3, 3] += T[:3, :3] @ np.array([step, 0.0, 0.0])
    return np.stack(poses)


def _check_gate(failure_prediction_mode: bool) -> None:
    if failure_prediction_mode:
        raise NotImplementedError(
            "the classifier gate loads the urban risk classifier "
            f"{URBAN_CLASSIFIER}, which the repository does not hold "
            "(ROADMAP Q3); run the overlap gate")


def scenario_config(failure_prediction_mode: bool = False):
    """The drive's PipelineConfig, shared by the live front-end and the
    snapshot loader: region growing, 16,384 raw / 8,192 voxels / 4,096
    filtered / 65,536 map, and the direct overlap gate (overlap < 20 %
    skips registration and forces a reference update, so the faulted
    odometry across the outage persists in the front-end)."""
    from ..pipeline.config import PipelineConfig

    _check_gate(failure_prediction_mode)
    cfg = PipelineConfig(
        working_mode="debug", segmentation_method="region_growing",
        raw_capacity=16384, downsample_capacity=8192,
        filtered_capacity=4096, map_capacity=65536, min_cluster_size=30,
        reference_update_frequency=2, max_correction_magnitude=1.5,
        failure_prediction_mode=False, risk_threshold=0.5,
        min_overlap_percent=20.0)
    cfg.icp = dataclasses.replace(cfg.icp, trim_normal_space=True)
    return cfg


def urban_drive(n_frames: int = 44, n_points: int = 14000,
                seed: int = 0, drift_per_m: float = 0.012,
                drift_yaw_deg_per_m: float = 0.10,
                step: float = 3.0,
                dropout_at: int = 14, dropout_len: int = 10,
                fault_t: float = 0.35, fault_yaw_deg: float = 2.0):
    """The drive's inputs: (items, gt, meta) with items (utime, points in
    the odometry frame, odometry pose) for the frames the sensor delivers;
    `meta` lacks the App's counts."""
    from ..tools.urban import make_urban_world, velodyne_scan

    rng = np.random.default_rng(seed + 1)
    world = make_urban_world(seed=seed, extent=60.0, pitch=28.0,
                             street=12.0)
    lap = max(int(round(4 * world.pitch / step)), 8)   # frames per circuit
    gt = loop_circuit_poses(world, lap_frames=lap, n_frames=n_frames,
                            step=step).astype(np.float64)

    items = []
    T_odom = gt[0].copy()
    for i in range(n_frames):
        in_outage = dropout_at <= i < dropout_at + dropout_len
        if i > 0:
            delta = np.linalg.inv(gt[i - 1]) @ gt[i]
            dist = float(np.linalg.norm(delta[:3, 3]))
            dt = rng.normal(0, drift_per_m * dist, 3)
            dt[2] *= 0.2
            dyaw = np.deg2rad(rng.normal(0, drift_yaw_deg_per_m) * dist
                              + 0.03 * dist)          # deg: yaw bias
            if i == dropout_at:
                # wheel slip while the lidar is down
                dt = dt + np.array([fault_t, -0.4 * fault_t, 0.0])
                dyaw += np.deg2rad(fault_yaw_deg)
            c, s = np.cos(dyaw), np.sin(dyaw)
            drift = np.eye(4)
            drift[:3, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
            drift[:3, 3] = dt
            T_odom = T_odom @ delta @ drift
        if in_outage:
            continue                                   # no sensor data
        scan = velodyne_scan(world, gt[i], n_beams=48, n_azimuth=384,
                             max_range=25.0, noise=0.02, seed=seed + 10 + i)
        if len(scan) > n_points:
            sel = rng.choice(len(scan), n_points, replace=False)
            scan = scan[sel]
        in_odom = scan @ T_odom[:3, :3].T + T_odom[:3, 3]
        items.append((i * 100_000, in_odom.astype(np.float32),
                      T_odom.astype(np.float32).copy()))
    odo_errs = [np.linalg.norm(np.asarray(it[2])[:3, 3]
                               - gt[it[0] // 100_000][:3, 3])
                for it in items]
    meta = {
        "n_frames": n_frames,
        "seed": seed,
        "dropout_at": dropout_at,
        "ate_odometry_m": float(np.sqrt(np.mean(np.square(odo_errs)))),
    }
    return items, gt, meta


def run_frontend(n_frames: int = 44, n_points: int = 14000,
                 seed: int = 0, failure_prediction_mode: bool = False,
                 device="cuda", **drive_kwargs):
    """The drifted multi-loop urban drive with a mid-drive failure stretch
    (`urban_drive`) through the AICP front-end on `device`. Returns
    (app, gt, meta)."""
    items, gt, meta = urban_drive(n_frames=n_frames, n_points=n_points,
                                  seed=seed, **drive_kwargs)
    return frontend_on(items, gt, meta, failure_prediction_mode, device)


def frontend_on(items, gt, meta, failure_prediction_mode: bool = False,
                device="cuda"):
    """`urban_drive`'s output through the scenario's App on `device`:
    (app, gt, meta with the App's accept and registration counts)."""
    from ..pipeline.app import App
    from ..pipeline.sequence import SequenceRunner

    cfg = scenario_config(failure_prediction_mode)
    app = App(cfg, device=device)
    SequenceRunner(app).run_clouds(items)
    meta.update(
        frames_accepted=sum(1 for f in app.frames if f.accepted),
        frames_registered=sum(1 for f in app.frames if f.registered),
        failure_prediction_mode=False)
    return app, gt, meta


# ---------------------------------------------------------------------------
# Front-end snapshots: iterate the back-end without re-running the App
# ---------------------------------------------------------------------------

class _SnapshotCloudRecord:
    """AlignedCloud stand-in carrying exactly what PoseGraphMapper reads."""

    def __init__(self, utime, corrected_pose, cloud):
        self.utime = int(utime)
        self.corrected_pose = corrected_pose
        self.cloud = cloud
        self.is_reference = True


class _SnapshotApp:
    """App stand-in for snapshot replay (graph + cfg + device + map sink)."""

    def __init__(self, cfg, records, device):
        self.cfg = cfg
        self.device = device
        self.graph = type("G", (), {"clouds": records})()
        self.aligned_map_np = None


def save_frontend_snapshot(app, gt, meta, path: str) -> None:
    """Keyframes, ground truth and meta in the JAX package's `.npz`
    layout."""
    from ..pipeline.mapper import PoseGraphMapper, _read

    kfs = PoseGraphMapper(app).keyframes()
    clouds = [_read(k.cloud.points, k.cloud.mask) for k in kfs]
    np.savez_compressed(
        path,
        gt=np.asarray(gt, np.float64),
        meta=json.dumps(meta),
        utimes=np.asarray([k.utime for k in kfs], np.int64),
        poses=np.stack([k.pose for k in kfs]).astype(np.float64),
        points=np.stack([c[0] for c in clouds]),
        masks=np.stack([c[1] for c in clouds]),
    )


def load_frontend_snapshot(path: str, device="cuda"):
    """Returns (app_like, gt, meta) replaying a saved front-end run (by
    either package) on `device`."""
    from ..cloud import Cloud
    from ..pipeline.app import check_device

    dev = check_device(device, "load_frontend_snapshot")
    z = np.load(path, allow_pickle=False)
    meta = json.loads(str(z["meta"]))
    cfg = scenario_config(meta.get("failure_prediction_mode", False))
    records = []
    for u, p, pts, m in zip(z["utimes"], z["poses"], z["points"],
                            z["masks"]):
        cloud = Cloud.from_numpy_padded(pts.astype(np.float32), m,
                                        device=dev)
        records.append(_SnapshotCloudRecord(u, p.astype(np.float32), cloud))
    return _SnapshotApp(cfg, records, dev), z["gt"], meta


def run_backend(app, gt, meta, use_plane_ba: bool = True,
                mesh=None) -> dict:
    """Loop closures + PGO (+ plane BA) on a completed front-end, on the
    App's device; returns the regression record. With `mesh` (rank 0 of a
    1-D "graph" mesh whose other ranks run `mapper.serve_backend`) the PGO
    and BA are sharded over it."""
    from ..pipeline.mapper import PoseGraphMapper

    mapper = PoseGraphMapper(app, mesh=mesh, **MAPPER_KW)
    kfs_pre = mapper.keyframes()
    ate_pre = _keyframe_ate(kfs_pre, gt)

    # two back-end rounds: after the first PGO the poses are closer, so a
    # second proposal finds pairs the seam pushed past the distance gate
    lcs = mapper.propose_loop_closures()
    mapper.optimize()
    lcs = mapper.propose_loop_closures()
    mapper.optimize()
    ate_pgo = _keyframe_ate(mapper.keyframes(), gt)
    out = {
        "n_frames": meta["n_frames"],
        "seed": meta.get("seed"),
        "n_keyframes": len(kfs_pre),
        "n_loop_closures": len(lcs),
        "ate_odometry_m": round(meta["ate_odometry_m"], 4),
        "ate_frontend_m": round(ate_pre, 4),
        "ate_post_pgo_m": round(ate_pgo, 4),
        "frames_accepted": meta["frames_accepted"],
        "frames_registered": meta["frames_registered"],
        "keyframe_frames": [kf.utime // 100_000 for kf in kfs_pre],
        "closure_spans": [(lc.i, lc.j) for lc in lcs],
    }
    if use_plane_ba:
        mapper.run_plane_ba(gn_iters=4, min_points=30)
        out["ate_post_ba_m"] = round(_keyframe_ate(mapper.keyframes(), gt), 4)
        out["plane_ba_ran"] = bool(mapper.last_ba_summary.get("ran", True))
    return out


def run_backend_from_snapshot(path: str, use_plane_ba: bool = True,
                              device="cuda") -> dict:
    app, gt, meta = load_frontend_snapshot(path, device=device)
    return run_backend(app, gt, meta, use_plane_ba=use_plane_ba)


def run_slam_accuracy(n_frames: int = 44, n_points: int = 14000,
                      seed: int = 0, use_plane_ba: bool = True,
                      failure_prediction_mode: bool = False,
                      device="cuda", **drive_kwargs) -> dict:
    app, gt, meta = run_frontend(
        n_frames=n_frames, n_points=n_points, seed=seed,
        failure_prediction_mode=failure_prediction_mode, device=device,
        **drive_kwargs)
    return run_backend(app, gt, meta, use_plane_ba=use_plane_ba)


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser()
    # no default: the repository's ACCURACY_SLAM.json is the JAX package's
    # record, never overwritten by the port's numbers
    p.add_argument("--out", default=None,
                   help="write the result record here (JSON; required "
                        "unless --snapshot)")
    p.add_argument("--frames", type=int, default=44)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--snapshot", default=None,
                   help="run the front-end only and save keyframes here")
    p.add_argument("--from-snapshot", default=None,
                   help="replay the back-end on a saved snapshot")
    p.add_argument("--classifier-gate", action="store_true",
                   help="gate with the urban risk classifier (not in the "
                        "repository: raises)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default: the card)")
    args = p.parse_args(argv)
    if args.out is None and (args.from_snapshot or not args.snapshot):
        p.error("--out is required unless --snapshot is given")
    if args.from_snapshot:
        result = run_backend_from_snapshot(args.from_snapshot,
                                           device=args.device)
    elif args.snapshot:
        app, gt, meta = run_frontend(
            n_frames=args.frames, seed=args.seed,
            failure_prediction_mode=args.classifier_gate, device=args.device)
        save_frontend_snapshot(app, gt, meta, args.snapshot)
        print(json.dumps(meta))
        return 0
    else:
        result = run_slam_accuracy(
            n_frames=args.frames, seed=args.seed,
            failure_prediction_mode=args.classifier_gate, device=args.device)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
