"""One distributed SLAM step on small shapes over a 2-D ("graph",
"points") mesh of ranks — the port's analog of the JAX package's
`__graft_entry__.dryrun_multichip`.

    python -m aicp_mapping_tpu_torch.parallel.dryrun N [--device cpu]

Phases, each with a sanity check: reading-sharded ICP over "points"
(4,096 reading points per rank, the reference replicated), map-block-
sharded ICP over "points" (8,192 map points per rank), edge-sharded PGO of
a 64-keyframe chain over "graph", and observation-sharded plane BA over
"graph". Every "points" row of the mesh solves the same registration.
"""
from __future__ import annotations

import sys

import numpy as np


def mesh_shape(n: int) -> tuple:
    """(graph, points) for `n` ranks, as JAX's dryrun factors it."""
    gdim = 1
    for f in (4, 2):
        if n % f == 0 and n // f > 1:
            gdim = n // f
            break
    return gdim, n // gdim


def _dryrun_rank(n: int, device: str) -> dict:
    import torch

    from ..cloud import Cloud
    from ..geometry import se3
    from ..ops.normals import estimate_normals
    from ..registration.icp import ICPConfig
    from ..tools.synthetic import room_cloud
    from . import (PlaneBA, PoseGraph, make_mesh_2d,
                   map_sharded_point_to_plane_icp,
                   optimize_plane_ba_sharded, optimize_pose_graph_sharded,
                   pad_edges, pad_observations, sharded_point_to_plane_icp)

    torch.set_num_threads(1)
    gdim, pdim = mesh_shape(n)
    mesh = make_mesh_2d((gdim, pdim), ("graph", "points"), device=device)
    dev = mesh.device

    def cloud(pts, cap):
        return Cloud.from_numpy(pts, capacity=cap, device=dev)

    T_pert = se3.make_transform(se3.so3_exp(torch.tensor([0.0, 0.0, 0.03])),
                                torch.tensor([0.05, 0.0, 0.0])).to(dev)
    eye = se3.identity(device=dev)

    # ---- phase 1: reading-sharded ICP ----
    n_pts = 4096 * pdim
    ref = cloud(room_cloud(n=n_pts, size=10.0, seed=0, noise=0.005), n_pts)
    normals, _, _ = estimate_normals(ref.points, ref.mask, k=8)
    reading = ref.transform(T_pert)
    res = sharded_point_to_plane_icp(
        mesh, reading.points, reading.mask, ref.points, normals, ref.mask,
        eye, 0.7, ICPConfig(max_iterations=5), axis="points")

    # ---- phase 1b: map-block-sharded ICP ----
    map_np = room_cloud(n=8192 * pdim, size=12.0, seed=1, noise=0.005)
    mcl = cloud(map_np, 8192 * pdim)
    mnormals, _, _ = estimate_normals(mcl.points, mcl.mask, k=8)
    mread = cloud(map_np[::2 * pdim][:4096], 4096).transform(T_pert)
    mres = map_sharded_point_to_plane_icp(
        mesh, mread.points, mread.mask, mcl.points, mnormals, mcl.mask,
        eye, 0.7, ICPConfig(max_iterations=5), axis="points")

    # ---- phase 2: edge-sharded PGO over 64 keyframes ----
    K = 64
    poses = torch.eye(4, device=dev).repeat(K, 1, 1)
    poses[:, 0, 3] = torch.arange(K, dtype=torch.float32, device=dev)
    i = torch.arange(K - 1, device=dev)
    edges = torch.stack([i, i + 1], dim=1)
    Z = torch.eye(4, device=dev).repeat(K - 1, 1, 1)
    Z[:, 0, 3] = 1.0
    w = torch.tensor([100.0] * 3 + [400.0] * 3, device=dev).repeat(K - 1, 1)
    e, z, ww, m = pad_edges(edges, Z, w, gdim)
    _, chi2 = optimize_pose_graph_sharded(PoseGraph(poses, e, z, ww, m),
                                          mesh, axis="graph", gn_iters=2,
                                          cg_iters=8)

    # ---- phase 3: observation-sharded plane BA ----
    rng = np.random.default_rng(0)
    L, Kb = 6, 4
    nrm = rng.normal(size=(L, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    lms = np.concatenate([nrm, rng.uniform(-3, 3, (L, 1)).astype(
        np.float32)], axis=1)
    bposes = np.tile(np.eye(4, dtype=np.float32), (Kb, 1, 1))
    bposes[:, 0, 3] = np.arange(Kb)
    ok, ol, op = [], [], []
    for k in range(Kb):
        R, t = bposes[k][:3, :3], bposes[k][:3, 3]
        for j in range(L):
            ok.append(k)
            ol.append(j)
            op.append(np.r_[R.T @ lms[j, :3], lms[j, 3] - lms[j, :3] @ t])

    def t_(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    prob = pad_observations(PlaneBA(
        t_(bposes), t_(lms), t_(ok, torch.int64), t_(ol, torch.int64),
        t_(np.stack(op)), torch.ones(len(ok), device=dev),
        torch.ones(len(ok), dtype=torch.bool, device=dev)), gdim)
    _, _, bchi2 = optimize_plane_ba_sharded(prob, mesh, axis="graph",
                                            gn_iters=2)

    # sanity: both ICP layouts recovered the small perturbation; PGO / BA
    # chi2 finite
    err = float(torch.linalg.norm((res.T @ T_pert)[:3, 3]))
    merr = float(torch.linalg.norm((mres.T @ T_pert)[:3, 3]))
    assert err < 0.05 and merr < 0.05, (err, merr)
    assert bool(torch.isfinite(chi2).all()) and bool(torch.isfinite(bchi2))
    return {"mesh": mesh.shape, "icp_t_err_m": err, "map_icp_t_err_m": merr,
            "pgo_chi2": chi2.tolist(), "ba_chi2": float(bchi2),
            "counts": mesh.counts()}


def dryrun_multichip(n_devices: int, device="cuda",
                     timeout_s: float = 900.0) -> dict:
    """Run the distributed step on `n_devices` ranks (rank r on card
    r % cards, or the CPU); returns rank 0's report."""
    import torch

    from .mesh import launch

    return launch(_dryrun_rank, n_devices, n_devices,
                  torch.device(device).type, device=device,
                  timeout_s=timeout_s)[0].value


def main(argv=None) -> int:
    import argparse
    import json

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("n", type=int, nargs="?", default=4)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    print(json.dumps(dryrun_multichip(args.n, args.device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
