"""Command-line tools of the port.

    python -m aicp_mapping_tpu_torch register READING REFERENCE [--device cpu]

register   register one reading/reference scan pair: octree overlap, kNN
           normals, FOV overlap, alignability, the risk classifier,
           auto-tuned ICP and the Hausdorff quality check, printed as JSON
           (the JAX package's `register`, the reference's aicp-registration
           pair tool). Runs on the card unless `--device cpu` is given.

The JAX package's other subcommands are not ported yet (ROADMAP Q1 #14).
"""
from __future__ import annotations

import argparse
import json
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
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
