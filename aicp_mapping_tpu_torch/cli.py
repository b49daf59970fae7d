"""Command-line tools of the port.

    python -m aicp_mapping_tpu_torch register READING REFERENCE [--device cpu]
    python -m aicp_mapping_tpu_torch slam [DIRECTORY] [--plane-ba] [--pipelined]
    python -m aicp_mapping_tpu_torch replay DIRECTORY [--config YAML]
    python -m aicp_mapping_tpu_torch accumulate DIRECTORY -o OUT.pcd
    python -m aicp_mapping_tpu_torch localize DIRECTORY --map MAP.pcd
    python -m aicp_mapping_tpu_torch kitti-run SCAN_DIR -o POSES.txt
    python -m aicp_mapping_tpu_torch kitti-eval GT.txt RESULT.txt [--plot P]
    python -m aicp_mapping_tpu_torch draw CLOUD OUT.vtk [--mode normals]
    python -m aicp_mapping_tpu_torch vtk-to-octree IN.vtk OUT.pcd

register   register one reading/reference scan pair: octree overlap, kNN
           normals, FOV overlap, alignability, the risk classifier,
           auto-tuned ICP and the Hausdorff quality check, printed as JSON
           (the JAX package's `register`, the reference's aicp-registration
           pair tool).
slam       end-to-end SLAM over a recorded sequence directory or a
           synthetic loop: AICP front-end (`--pipelined`: through the
           submission pipeline) -> overlap-ranked, ICP-verified loop
           closures -> pose-graph optimization -> optional plane BA;
           prints the JAX package's `slam` summary as JSON. With
           `--mesh-devices N` > 1 the PGO is edge-sharded and the plane BA
           observation-sharded over N ranks.
replay     replay a recorded sequence directory through the App; prints
           frame counts, writes the trajectory; `--live-viz PORT` streams
           the App's clouds, maps, poses and metrics to TCP viewers
           (`utils.live_viz`; 0 picks a free port, printed on stderr).
accumulate concatenate a recorded sequence's scans into one odom-frame
           cloud (range crop, optional voxel grid) and write it as PCD.
localize   localize a recorded sequence against a prior map, split into
           one Morton block per rank with `--mesh-devices N`.
overlap    voxel-occupancy overlap of two clouds.
classifier train (`--train`) and test (`--test`) the alignment-risk
           classifier on labelled files (`id overlap alignability label`);
           prints the confusion statistics, AUC and best F1.
kitti-run  run a KITTI velodyne sequence (`.bin` scans) end to end at the
           HDL-64 widths, optionally removing the ground first; with
           `--ground-truth` also the devkit errors and the ATE.
kitti-eval the KITTI devkit segment errors, ATE and RPE of a trajectory;
           `--plot P.png` also draws the paths and, beside them,
           `P_err.png` the segment errors (matplotlib).
draw       a cloud as VTK line geometry: the occupied octree cells'
           wireframes (`--mode octree`) or kNN normal whiskers
           (`--mode normals`, on the device).
vtk-to-octree   a VTK cloud's occupied voxel cells, one point per cell, as
           PCD or VTK.
remove-ground   the progressive morphological ground filter of one cloud.
oxts-to-kitti   a KITTI trajectory from raw OXTS (GPS/IMU) records.
make-cube  the synthetic cube cloud; concat: concatenate clouds.

The commands that touch the device run on the card unless `--device cpu`
is given. `--mesh-devices N` > 1 starts N ranks (processes) itself — rank r
on card r % cards, NCCL when each rank has a card of its own, else gloo —
or, under `torchrun` with N processes, joins that group; rank 0 runs the
command, writes its outputs and prints the summary, which carries
`mesh_devices` and the backend.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def _cmd_register(args) -> int:
    import torch

    from .classification.classifier import RiskClassifier
    from .cloud import Cloud
    from .geometry import se3
    from .io.pcd import read_cloud, viewpoint_to_pose, write_pcd
    from .ops.normals import estimate_normals
    from .overlap.alignability import alignability_filter
    from .overlap.fov import fov_overlap
    from .overlap.voxel_overlap import compute_overlap
    from .pipeline.app import check_device
    from .registration.icp import clamp_trim_ratio, point_to_plane_icp
    from .registration.monitor import hausdorff_distance

    dev = check_device(args.device, "register")
    read_np, read_vp = read_cloud(args.reading)
    ref_np, ref_vp = read_cloud(args.reference)
    cap = 1 << int(np.ceil(np.log2(max(len(read_np), len(ref_np), 1024))))
    reading = Cloud.from_numpy(read_np, capacity=cap, device=dev)
    reference = Cloud.from_numpy(ref_np, capacity=cap, device=dev)
    read_pose = torch.as_tensor(viewpoint_to_pose(read_vp), device=dev)
    ref_pose = torch.as_tensor(viewpoint_to_pose(ref_vp), device=dev)

    # a named ICP chain: its solver settings and point filters
    icp_cfg = None
    read_mask, ref_mask = reading.mask, reference.mask
    if args.icp_config:
        from .pipeline.config import load_icp_chain_yaml
        from .registration.chain import apply_chain_filters

        icp_cfg, read_filt, ref_filt = load_icp_chain_yaml(args.icp_config)
        read_mask = apply_chain_filters(reading.points, read_mask,
                                        read_pose[:3, 3], read_filt,
                                        seed=args.seed)
        ref_mask = apply_chain_filters(reference.points, ref_mask,
                                       ref_pose[:3, 3], ref_filt,
                                       seed=args.seed + 1)

    init_T = se3.identity(device=dev)
    if args.perturb_sigma_t > 0 or args.perturb_sigma_deg > 0:
        # random Gaussian initial perturbation for validation runs
        rng = np.random.default_rng(args.seed)
        t = rng.normal(0, args.perturb_sigma_t, 3)
        w = np.deg2rad(rng.normal(0, args.perturb_sigma_deg, 3))
        init_T = se3.make_transform(
            se3.so3_exp(torch.as_tensor(w, dtype=torch.float32)),
            torch.as_tensor(t, dtype=torch.float32)).to(dev)

    overlap = float(compute_overlap(reference.points, ref_mask,
                                    reading.points, read_mask
                                    ).overlap_percent)
    normals, _, _ = estimate_normals(reference.points, ref_mask,
                                     k=args.normal_k)
    fov = float(fov_overlap(reference.points, ref_mask, ref_pose,
                            reading.points, read_mask, read_pose)[0])
    align = float(alignability_filter(reference.points, ref_mask, ref_pose,
                                      reading.points, read_mask,
                                      read_pose)[0])
    risk = -1.0
    if args.classifier:
        clf = RiskClassifier()
        clf.load(args.classifier)
        risk = float(clf.test(np.array([[overlap, align]],
                                       np.float32)).reshape(-1)[0])

    # the chain's fixed trim ratio when it pins one, else the auto-tune clamp
    if icp_cfg is not None and icp_cfg.trim_ratio > 0:
        ratio = torch.tensor(icp_cfg.trim_ratio, dtype=torch.float32)
    else:
        ratio = clamp_trim_ratio(torch.tensor(overlap, dtype=torch.float32))
    result = point_to_plane_icp(
        reading.points, read_mask, reference.points, normals, ref_mask,
        init_T, ratio.to(dev), *((icp_cfg,) if icp_cfg is not None else ()))
    aligned = reading.transform(result.T)
    haus = float(hausdorff_distance(aligned.points, aligned.mask,
                                    reference.points, reference.mask))
    out = {
        "overlap_percent": overlap,
        "fov_overlap": fov,
        "alignability": align,
        "risk": risk,
        "trim_ratio": float(ratio),
        "n_iterations": int(result.n_iterations),
        "inlier_rms": float(result.inlier_rms),
        "hausdorff": haus,
        "correction": result.T.cpu().numpy().tolist(),
    }
    print(json.dumps(out, indent=2))
    if args.output:
        write_pcd(args.output, aligned.to_numpy())
    return 0


def _cmd_slam(args) -> int:
    if args.mesh_devices > 1:
        return _on_ranks(_slam_rank, args)
    print(json.dumps(_slam(args), indent=2))
    return 0


def _slam_rank(args):
    """One rank of `slam --mesh-devices N`: rank 0 runs the command over a
    1-D "graph" mesh, the others serve its back-end solves."""
    from .parallel.mesh import make_mesh
    from .pipeline.mapper import serve_backend

    mesh = make_mesh(args.mesh_devices, axis="graph", device=args.device)
    if mesh.rank != 0:
        serve_backend(mesh, "graph")
        return None
    summary = _slam(args, mesh)
    mesh.stop_serving()
    return dict(summary, mesh_devices=args.mesh_devices,
                backend=mesh.backend)


def _on_ranks(fn, args) -> int:
    """Run `fn(args)` on `--mesh-devices` ranks (stopped after
    `mesh.DEFAULT_TIMEOUT_S`); print rank 0's summary."""
    from .parallel.mesh import launch

    summary = launch(fn, args.mesh_devices, args,
                     device=args.device)[0].value
    if summary is not None:
        print(json.dumps(summary, indent=2))
    return 0


def _slam(args, mesh=None) -> dict:
    from .eval.kitti import ate_rmse
    from .io.pcd import write_pcd
    from .io.poses import write_kitti_poses
    from .pipeline.app import App
    from .pipeline.config import PipelineConfig, load_yaml_config
    from .pipeline.mapper import PoseGraphMapper
    from .pipeline.sequence import SequenceRunner, synthetic_sequence

    if args.config:
        cfg = load_yaml_config(args.config)
    elif args.directory:
        cfg = PipelineConfig()
    else:
        # synthetic demo loop: compact capacities, keyframe every 2 frames
        cfg = PipelineConfig(
            working_mode="debug", raw_capacity=8192,
            downsample_capacity=4096, filtered_capacity=2048,
            map_capacity=16384, min_cluster_size=30,
            reference_update_frequency=2)
    app = App(cfg, device=args.device if mesh is None else mesh.device)
    runner = SequenceRunner(app, pipelined=args.pipelined)
    gt = None
    if args.directory:
        results = runner.run_directory(args.directory)
    else:
        items, gt = synthetic_sequence(
            n_frames=args.synthetic, n_points=6000, seed=args.seed,
            yaw_rate_deg=360.0 / max(args.synthetic, 1), step=1.0)
        results = runner.run_clouds(items)

    mapper = PoseGraphMapper(
        app, mesh=mesh, min_loop_overlap=args.min_loop_overlap,
        min_keyframe_gap=args.min_keyframe_gap,
        max_loop_distance=args.max_loop_distance)
    kfs_pre = mapper.keyframes()
    pre_poses = np.stack([k.pose for k in kfs_pre]) if kfs_pre else None
    lcs = mapper.propose_loop_closures()
    kfs = mapper.optimize(gn_iters=args.gn_iters)
    if args.plane_ba:
        kfs = mapper.run_plane_ba(gn_iters=args.ba_iters)

    summary = {
        "frames": len(results),
        "accepted": sum(1 for r in results if r and r.accepted),
        "keyframes": len(kfs),
        "loop_closures": [
            {"i": lc.i, "j": lc.j, "overlap": round(lc.overlap, 2),
             "inlier_rms": round(lc.inlier_rms, 4)} for lc in lcs],
    }
    if gt is not None and kfs:
        gt_k = np.stack([gt[min(k.index, len(gt) - 1)] for k in kfs])
        summary["ate_pre_m"] = round(ate_rmse(gt_k, pre_poses), 4)
        summary["ate_post_m"] = round(
            ate_rmse(gt_k, np.stack([k.pose for k in kfs])), 4)
    if args.output_map:
        write_pcd(args.output_map, app.aligned_map_np)
    if args.output_poses and kfs:
        write_kitti_poses(args.output_poses,
                          np.stack([k.pose for k in kfs]))
    return summary


def _cmd_replay(args) -> int:
    from .io.poses import write_kitti_poses
    from .pipeline.app import App
    from .pipeline.config import PipelineConfig, load_yaml_config
    from .pipeline.sequence import SequenceRunner

    cfg = load_yaml_config(args.config) if args.config else PipelineConfig()
    vis = None
    if args.live_viz is not None:
        from .utils.live_viz import LiveVisualizer

        vis = LiveVisualizer(port=args.live_viz)
        print(f"live viz streaming on {vis.address[0]}:{vis.address[1]}",
              file=sys.stderr)
    try:
        app = App(cfg, device=args.device, visualizer=vis)
        try:
            results = SequenceRunner(app).run_directory(args.directory)
        finally:
            app.close()
    finally:
        if vis is not None:
            vis.close()
    ok = [r for r in results if r is not None]
    print(json.dumps({
        "frames": len(results),
        "accepted": sum(1 for r in ok if r.accepted),
        "registered": sum(1 for r in ok if r.registered),
    }, indent=2))
    if args.output_poses:
        write_kitti_poses(args.output_poses,
                          np.stack([r.corrected_pose for r in ok]))
    return 0


def _cmd_accumulate(args) -> int:
    from .io.pcd import read_cloud, write_pcd
    from .io.poses import read_pose_csv
    from .native import ScanAccumulator, voxel_downsample

    poses = read_pose_csv(os.path.join(args.directory,
                                       "aicp_input_poses.csv"))
    if args.max_scans:
        poses = poses[:args.max_scans]
    acc = ScanAccumulator(capacity=args.capacity, batch_size=len(poses),
                          min_range=args.min_range, max_range=args.max_range)
    used = 0
    for p in poses:
        path = os.path.join(args.directory,
                            f"cloud_{p.counter}_{p.sec}_{p.nsec}.pcd")
        if not os.path.exists(path):
            continue
        pts, _ = read_cloud(path)
        acc.push(pts, p.pose)
        used += 1
    merged = acc.take()
    if args.voxel > 0:
        merged = voxel_downsample(merged, args.voxel)
    write_pcd(args.output, merged)
    print(json.dumps({"scans": used, "points": len(merged),
                      "output": args.output}))
    return 0


def _cmd_localize(args) -> int:
    if args.mesh_devices > 1:
        return _on_ranks(_localize_rank, args)
    print(json.dumps(_localize(args)))
    return 0


def _localize_rank(args):
    """One rank of `localize --mesh-devices N`: every rank holds one block
    of the map; rank 0 localizes, the others serve its crops."""
    from .parallel.mesh import make_mesh

    mesh = make_mesh(args.mesh_devices, axis="points", device=args.device)
    summary = _localize(args, mesh)
    return None if summary is None else dict(summary, backend=mesh.backend)


def _localize(args, mesh=None):
    from .io.pcd import read_cloud
    from .io.poses import read_pose_csv, write_kitti_poses
    from .parallel import ShardedMapLocalizer

    map_pts, _ = read_cloud(args.map)
    loc = ShardedMapLocalizer(map_pts, trim_ratio=args.trim_ratio,
                              max_correction_magnitude=args.max_correction,
                              device=args.device, mesh=mesh)
    if mesh is not None and mesh.rank != 0:
        loc.serve()
        return None
    poses = read_pose_csv(os.path.join(args.directory,
                                       "aicp_input_poses.csv"))
    out = []
    for p in poses:
        pts, _ = read_cloud(os.path.join(
            args.directory, f"cloud_{p.counter}_{p.sec}_{p.nsec}.pcd"))
        # recorded clouds are in the odom frame; the localizer takes the
        # sensor frame
        pose = np.asarray(p.pose, np.float64)
        local = (pts - pose[:3, 3]) @ pose[:3, :3]
        out.append(loc.localize(local.astype(np.float32), p.pose))
    loc.stop_serving()
    if args.output_poses:
        write_kitti_poses(args.output_poses, np.stack(out))
    return {
        "frames": len(out),
        "map_points": int(len(map_pts)),
        "mesh_devices": args.mesh_devices,
        "final_pose_t": [round(float(v), 4) for v in out[-1][:3, 3]],
        "output": args.output_poses or "",
    }


def _pow2_capacity(*counts: int) -> int:
    return 1 << int(np.ceil(np.log2(max(*counts, 1024))))


def _cmd_overlap(args) -> int:
    from .cloud import Cloud
    from .io.pcd import read_cloud
    from .overlap.voxel_overlap import compute_overlap
    from .pipeline.app import check_device

    dev = check_device(args.device, "overlap")
    a_np, _ = read_cloud(args.cloud_a)
    b_np, _ = read_cloud(args.cloud_b)
    cap = _pow2_capacity(len(a_np), len(b_np))
    a = Cloud.from_numpy(a_np, capacity=cap, device=dev)
    b = Cloud.from_numpy(b_np, capacity=cap, device=dev)
    ov = compute_overlap(a.points, a.mask, b.points, b.mask,
                         resolution=args.resolution)
    mn, spread, ra, rb = (float(x) for x in ov.loop_closure_tuple())
    print(json.dumps({
        "overlap_percent": float(ov.overlap_percent),
        "ratio_a": ra, "ratio_b": rb, "spread": spread,
        "n_common": int(ov.n_common),
    }, indent=2))
    return 0


def _cmd_classifier(args) -> int:
    from .classification.classifier import RiskClassifier, load_label_file
    from .eval.analysis import confusion_stats, f_scores, roc_curve

    clf = RiskClassifier(threshold=args.threshold, device=args.device)
    if args.train:
        feats, labels = load_label_file(args.train)
        clf.train(feats, labels)
        if args.model:
            clf.save(args.model)
    elif args.model:
        clf.load(args.model)
    else:
        print("classifier: need --train or --model", file=sys.stderr)
        return 2

    if args.test:
        feats, labels = load_label_file(args.test)
        probs = clf.test(feats).numpy().reshape(-1)
        stats = confusion_stats(probs, labels, threshold=args.threshold)
        auc, _, _ = roc_curve(probs, labels)
        stats["auc"] = auc
        best_t, best_f1, _, _ = f_scores(probs, labels)
        stats["best_f1"] = best_f1
        stats["best_f1_threshold"] = best_t
        if args.compare_probs:
            # another classifier's per-sample probabilities (`id prob` per
            # row) scored on the same labelled test set
            ref = np.loadtxt(args.compare_probs)
            ref = ref[:, 1] if ref.ndim == 2 else ref
            r_auc, _, _ = roc_curve(ref, labels)
            _, r_f1, _, _ = f_scores(ref, labels)
            stats["compare"] = {
                "auc": r_auc, "best_f1": r_f1,
                **confusion_stats(ref, labels, threshold=args.threshold),
            }
        print(json.dumps(stats, indent=2))
        if args.save_probs:
            np.savetxt(args.save_probs, probs, fmt="%.6f")
        if args.save_eval:
            with open(args.save_eval, "w") as f:
                json.dump({"train": args.train, "test": args.test,
                           "threshold": args.threshold, **stats}, f, indent=1)
    return 0


def _cmd_kitti_run(args) -> int:
    from .eval.kitti import ate_rmse, average_errors, calc_sequence_errors
    from .eval.kitti_runner import run_kitti_sequence
    from .io.poses import read_kitti_poses, write_kitti_poses
    from .pipeline.config import load_yaml_config

    cfg = load_yaml_config(args.config) if args.config else None
    traj, results, app = run_kitti_sequence(
        args.scan_dir, config=cfg, max_frames=args.max_frames,
        remove_ground=args.remove_ground, frame_stride=args.stride,
        device=args.device)
    app.close()
    write_kitti_poses(args.output_poses, traj)
    ok = [r for r in results if r is not None]
    summary = {
        "frames": len(results),
        "registered": sum(1 for r in ok if r.registered),
        "accepted": sum(1 for r in ok if r.accepted),
        "output": args.output_poses,
    }
    if args.ground_truth:
        gt = read_kitti_poses(args.ground_truth)
        n = min(len(gt), len(traj))
        summary.update(average_errors(calc_sequence_errors(gt[:n], traj[:n])))
        summary["ate_rmse"] = ate_rmse(gt[:n], traj[:n], align=True)
    print(json.dumps(summary, indent=2))
    return 0


def _cmd_kitti_eval(args) -> int:
    from .eval.kitti import (ate_rmse, average_errors, calc_sequence_errors,
                             rpe)
    from .io.poses import read_kitti_poses

    gt = read_kitti_poses(args.ground_truth)
    res = read_kitti_poses(args.result)
    n = min(len(gt), len(res))
    errors = calc_sequence_errors(gt[:n], res[:n])
    summary = average_errors(errors)
    summary["ate_rmse"] = ate_rmse(gt[:n], res[:n], align=args.align)
    r = rpe(gt[:n], res[:n])
    summary["rpe_trans"] = r["rpe_trans_rmse_m"]
    summary["rpe_rot"] = r["rpe_rot_rmse_deg"]
    if args.plot:
        from .eval.plots import plot_segment_errors, plot_trajectories

        plot_trajectories(args.plot, gt[:n], res[:n])
        if errors:
            plot_segment_errors(args.plot.replace(".png", "_err.png"),
                                errors)
        summary["plot"] = args.plot
    print(json.dumps(summary, indent=2))
    return 0


def _cmd_remove_ground(args) -> int:
    from .cloud import Cloud
    from .io.pcd import read_cloud, write_pcd
    from .ops.ground import GroundFilterConfig, remove_ground
    from .pipeline.app import check_device

    dev = check_device(args.device, "remove-ground")
    pts, vp = read_cloud(args.infile)
    cloud = Cloud.from_numpy(pts, capacity=_pow2_capacity(len(pts)),
                             device=dev)
    cfg = GroundFilterConfig(cell_size=args.cell_size,
                             max_window_size=args.max_window,
                             slope=args.slope,
                             initial_distance=args.initial_distance,
                             max_distance=args.max_distance)
    non_ground, ground = remove_ground(cloud.points, cloud.mask, cfg)
    points = cloud.points.cpu().numpy()
    obj = points[non_ground.cpu().numpy()]
    grd = points[ground.cpu().numpy()]
    write_pcd(args.outfile, obj, viewpoint=vp)
    if args.ground_out:
        write_pcd(args.ground_out, grd, viewpoint=vp)
    print(json.dumps({"input": len(pts), "object": len(obj),
                      "ground": len(grd)}))
    return 0


def _cmd_make_cube(args) -> int:
    from .io.pcd import write_pcd
    from .tools.synthetic import cube_cloud

    pts = cube_cloud(n_per_face=args.n_per_face, size=args.size,
                     seed=args.seed, noise=args.noise)
    write_pcd(args.output, pts)
    print(json.dumps({"points": len(pts), "output": args.output}))
    return 0


def _cmd_concat(args) -> int:
    from .io.pcd import read_cloud, write_pcd
    from .native import voxel_downsample

    merged = np.concatenate([read_cloud(p)[0] for p in args.inputs])
    if args.voxel > 0:
        merged = voxel_downsample(merged, args.voxel)
    write_pcd(args.output, merged)
    print(json.dumps({"points": len(merged), "output": args.output}))
    return 0


def _cmd_oxts_to_kitti(args) -> int:
    from .io.oxts import read_oxts_directory
    from .io.poses import write_kitti_poses

    poses = read_oxts_directory(args.oxts_dir)
    write_kitti_poses(args.output, poses)
    print(json.dumps({"poses": len(poses), "output": args.output}))
    return 0


def _cmd_draw(args) -> int:
    from .io.pcd import read_cloud
    from .io.vtk import write_vtk_lines
    from .utils.drawing import normals_segments, octree_wireframe

    pts, _ = read_cloud(args.infile)
    if args.mode == "octree":
        segs = octree_wireframe(pts, args.resolution)
    else:
        from .cloud import Cloud
        from .ops import estimate_normals
        from .pipeline.app import check_device

        dev = check_device(args.device, "draw")
        cap = 1 << max(int(np.ceil(np.log2(max(len(pts), 2)))), 6)
        cloud = Cloud.from_numpy(pts, capacity=cap, device=dev)
        normals, _, _ = estimate_normals(cloud.points, cloud.mask, k=12)
        m = cloud.mask.cpu().numpy()
        segs = normals_segments(cloud.points.cpu().numpy()[m],
                                normals.cpu().numpy()[m],
                                scale=args.scale, stride=args.stride)
    write_vtk_lines(args.outfile, segs)
    print(json.dumps({"points": len(pts), "segments": int(len(segs)),
                      "mode": args.mode, "output": args.outfile}))
    return 0


def _cmd_vtk_to_octree(args) -> int:
    from .io.pcd import write_pcd
    from .io.vtk import read_vtk, write_vtk
    from .utils.visualizer import occupied_cells

    pts = read_vtk(args.infile)
    cells = occupied_cells(pts, args.resolution)
    if args.outfile.endswith(".vtk"):
        write_vtk(args.outfile, cells)
    else:
        write_pcd(args.outfile, cells)
    print(json.dumps({"points": len(pts), "occupied_cells": len(cells),
                      "resolution": args.resolution,
                      "output": args.outfile}))
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="aicp_mapping_tpu_torch", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="command", required=True)

    r = sub.add_parser("register", help="register a reading/reference pair")
    r.add_argument("reading")
    r.add_argument("reference")
    r.add_argument("-o", "--output", help="write aligned reading PCD")
    r.add_argument("--classifier", help="trained risk-classifier file")
    r.add_argument("--icp-config",
                   help="named ICP-chain YAML (configs/icp/*.yaml)")
    r.add_argument("--normal-k", type=int, default=12)
    r.add_argument("--perturb-sigma-t", type=float, default=0.0)
    r.add_argument("--perturb-sigma-deg", type=float, default=0.0)
    r.add_argument("--seed", type=int, default=0)
    r.add_argument("--device", default="cuda",
                   help="torch device (default: the card)")
    r.set_defaults(func=_cmd_register)

    sl = sub.add_parser(
        "slam", help="end-to-end SLAM: front-end + loop closures + PGO + BA")
    sl.add_argument("directory", nargs="?",
                    help="recorded sequence dir; omit for a synthetic loop")
    sl.add_argument("--synthetic", type=int, default=12,
                    help="synthetic loop length when no directory given")
    sl.add_argument("--seed", type=int, default=2)
    sl.add_argument("--config", help="AICP YAML config")
    sl.add_argument("--pipelined", action="store_true",
                    help="drive the front-end through the submission "
                         "pipeline")
    sl.add_argument("--mesh-devices", type=int, default=1,
                    help=">1: edge-shard the PGO and observation-shard the "
                         "plane BA over this many ranks")
    sl.add_argument("--min-loop-overlap", type=float, default=30.0)
    sl.add_argument("--min-keyframe-gap", type=int, default=2)
    sl.add_argument("--max-loop-distance", type=float, default=15.0)
    sl.add_argument("--gn-iters", type=int, default=8)
    sl.add_argument("--plane-ba", action="store_true",
                    help="refine with plane-landmark bundle adjustment")
    sl.add_argument("--ba-iters", type=int, default=4)
    sl.add_argument("--output-map", help="write the final map PCD")
    sl.add_argument("--output-poses", help="write keyframe poses (KITTI)")
    sl.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    sl.set_defaults(func=_cmd_slam)

    rp = sub.add_parser("replay", help="replay a recorded sequence directory")
    rp.add_argument("directory")
    rp.add_argument("--config", help="AICP YAML config")
    rp.add_argument("--output-poses", help="write KITTI-format trajectory")
    rp.add_argument("--live-viz", type=int, default=None, metavar="PORT",
                    help="stream clouds/poses/metrics to TCP viewers "
                         "(0 = ephemeral port; utils.live_viz protocol)")
    rp.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    rp.set_defaults(func=_cmd_replay)

    ac = sub.add_parser("accumulate",
                        help="accumulate a recorded sequence into one cloud")
    ac.add_argument("directory", help="record/replay sequence directory")
    ac.add_argument("-o", "--output", required=True)
    ac.add_argument("--max-scans", type=int, default=0)
    ac.add_argument("--capacity", type=int, default=1 << 21)
    ac.add_argument("--min-range", type=float, default=0.5)
    ac.add_argument("--max-range", type=float, default=30.0)
    ac.add_argument("--voxel", type=float, default=0.0)
    ac.set_defaults(func=_cmd_accumulate)

    lz = sub.add_parser(
        "localize", help="localize a recorded sequence against a prior map")
    lz.add_argument("directory", help="recorded sequence dir")
    lz.add_argument("--map", required=True, help="prior map (.pcd/.bin)")
    lz.add_argument("--mesh-devices", type=int, default=1,
                    help=">1: one Morton block of the map per rank")
    lz.add_argument("--trim-ratio", type=float, default=0.7)
    lz.add_argument("--max-correction", type=float, default=0.5)
    lz.add_argument("--output-poses", default="")
    lz.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    lz.set_defaults(func=_cmd_localize)
    o = sub.add_parser("overlap", help="voxel-occupancy overlap of two clouds")
    o.add_argument("cloud_a")
    o.add_argument("cloud_b")
    o.add_argument("--resolution", type=float, default=0.2)
    o.add_argument("--device", default="cuda",
                   help="torch device (default: the card)")
    o.set_defaults(func=_cmd_overlap)

    c = sub.add_parser("classifier", help="train/test the risk classifier")
    c.add_argument("--train", help="labelled training file (id ov align label)")
    c.add_argument("--test", help="labelled testing file")
    c.add_argument("--model", help="model path to save (with --train) or load")
    c.add_argument("--save-probs", help="write per-sample probabilities")
    c.add_argument("--save-eval", help="write the test metrics as JSON")
    c.add_argument("--compare-probs",
                   help="score another classifier's `id prob` file on the "
                        "same test set")
    c.add_argument("--threshold", type=float, default=0.5)
    c.add_argument("--device", default="cuda",
                   help="torch device of the training (default: the card)")
    c.set_defaults(func=_cmd_classifier)

    kr = sub.add_parser("kitti-run",
                        help="run a KITTI velodyne sequence end-to-end")
    kr.add_argument("scan_dir", help="directory of velodyne .bin scans")
    kr.add_argument("-o", "--output-poses", required=True,
                    help="write KITTI-format trajectory")
    kr.add_argument("--config", help="AICP YAML config")
    kr.add_argument("--max-frames", type=int)
    kr.add_argument("--stride", type=int, default=1)
    kr.add_argument("--remove-ground", action="store_true")
    kr.add_argument("--ground-truth", help="evaluate against this poses file")
    kr.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    kr.set_defaults(func=_cmd_kitti_run)

    k = sub.add_parser("kitti-eval", help="KITTI segment errors + ATE/RPE")
    k.add_argument("ground_truth")
    k.add_argument("result")
    k.add_argument("--align", action="store_true",
                   help="Umeyama-align before ATE")
    k.add_argument("--plot", help="write a trajectory plot PNG here")
    k.set_defaults(func=_cmd_kitti_eval)

    g = sub.add_parser("remove-ground", help="progressive morphological filter")
    g.add_argument("-i", "--infile", required=True)
    g.add_argument("-o", "--outfile", required=True)
    g.add_argument("--ground-out", help="also write the extracted ground")
    g.add_argument("--cell-size", type=float, default=0.33)
    g.add_argument("--max-window", type=int, default=33)
    g.add_argument("--slope", type=float, default=0.1)
    g.add_argument("--initial-distance", type=float, default=0.1)
    g.add_argument("--max-distance", type=float, default=2.0)
    g.add_argument("--device", default="cuda",
                   help="torch device (default: the card)")
    g.set_defaults(func=_cmd_remove_ground)

    m = sub.add_parser("make-cube", help="synthetic cube-cloud generator")
    m.add_argument("output")
    m.add_argument("--n-per-face", type=int, default=2000)
    m.add_argument("--size", type=float, default=4.0)
    m.add_argument("--noise", type=float, default=0.0)
    m.add_argument("--seed", type=int, default=0)
    m.set_defaults(func=_cmd_make_cube)

    ox = sub.add_parser("oxts-to-kitti",
                        help="KITTI trajectory from raw OXTS/GPS records")
    ox.add_argument("oxts_dir", help="directory of per-frame OXTS .txt files")
    ox.add_argument("-o", "--output", required=True,
                    help="KITTI-format poses output")
    ox.set_defaults(func=_cmd_oxts_to_kitti)

    cc = sub.add_parser("concat", help="concatenate clouds")
    cc.add_argument("output")
    cc.add_argument("inputs", nargs="+")
    cc.add_argument("--voxel", type=float, default=0.0,
                    help="optional voxel downsample of the result")
    cc.set_defaults(func=_cmd_concat)

    dr = sub.add_parser("draw", help="cloud -> octree wireframe / normal "
                                     "whiskers as VTK lines")
    dr.add_argument("infile", help=".pcd/.bin cloud")
    dr.add_argument("outfile", help=".vtk LINES output")
    dr.add_argument("--mode", choices=("octree", "normals"),
                    default="octree")
    dr.add_argument("--resolution", type=float, default=0.2,
                    help="octree cell size (octree mode)")
    dr.add_argument("--scale", type=float, default=0.2,
                    help="whisker length (normals mode)")
    dr.add_argument("--stride", type=int, default=1,
                    help="subsample normals by this stride")
    dr.add_argument("--device", default="cuda",
                    help="torch device of the normals (default: the card)")
    dr.set_defaults(func=_cmd_draw)

    vo = sub.add_parser("vtk-to-octree",
                        help="VTK cloud -> occupancy-voxel cell cloud")
    vo.add_argument("infile")
    vo.add_argument("outfile", help=".pcd or .vtk output of cell centers")
    vo.add_argument("--resolution", type=float, default=0.2)
    vo.set_defaults(func=_cmd_vtk_to_octree)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
