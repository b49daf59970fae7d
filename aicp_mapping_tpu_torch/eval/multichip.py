"""Scaling of the distributed registration path over ranks, PyTorch port
of `aicp_mapping_tpu.eval.multichip`.

`run_scaling` solves the same registration on one device and sharded over
N ranks (`parallel.launch`), for both layouts: the reading sharded
(`sharded_point_to_plane_icp`) and the map sharded in blocks
(`map_sharded_point_to_plane_icp`). The collective traffic comes from the
mesh's own counters (`Mesh.counts`), not from a compiled program: the
reading layout's target is O(1) bytes per iteration (two 128-bin trim
histograms, the 6x6 system, the 6-vector, the inlier sums: 1,208 B), the
map layout's 32 B per reading point per iteration. Ranks that share one
card (or the CPU) share its compute, so their times record the path and
say nothing about scaling across cards; no projection to other hardware
is made (JAX's `project_ici_efficiency` is not ported).

    python -m aicp_mapping_tpu_torch.eval.multichip --devices 2 \\
        [--device cpu] [--out result.json]
"""
from __future__ import annotations

import json
import time

_REDUCTIONS = ("psum", "pmin", "pmax")


def collective_stats(counts: dict, iterations: int) -> dict:
    """Collective calls and bytes from a mesh's counters (`Mesh.counts()`
    after `reset_counts()` and one solve of `iterations` ICP iterations):
    {"ops": {op: calls}, "bytes_per_solve": all bytes, and
    "bytes_per_iteration": the reductions' bytes (psum, pmin, pmax; not the
    all-gather of the per-point outputs) per iteration}."""
    ops: dict = {}
    total = reduced = 0
    for per_axis in counts.values():
        for op, c in per_axis.items():
            ops[op] = ops.get(op, 0) + c["calls"]
            total += c["bytes"]
            if op in _REDUCTIONS:
                reduced += c["bytes"]
    return {"ops": ops, "bytes_per_solve": total,
            "bytes_per_iteration": reduced / max(iterations, 1)}


def _scaling_rank(p: dict) -> dict | None:
    """One rank of `run_scaling`: both layouts sharded over all ranks,
    timed by rank 0 beside its single-device solves."""
    import numpy as np
    import torch

    from ..cloud import Cloud
    from ..geometry import se3
    from ..ops.normals import estimate_normals
    from ..parallel import (make_mesh, map_sharded_point_to_plane_icp,
                            sharded_point_to_plane_icp)
    from ..registration.icp import ICPConfig, point_to_plane_icp
    from ..tools.synthetic import room_cloud

    mesh = make_mesh(p["n_devices"], axis="points", device=p["device"])
    dev = mesh.device

    def cloud(pts, n):
        c = Cloud.from_numpy(pts, capacity=n, device=dev)
        return c.points, c.mask

    T_pert = se3.make_transform(
        se3.so3_exp(torch.tensor([0.01, -0.015, 0.03])),
        torch.tensor([0.08, -0.05, 0.04])).to(dev)
    # fixed iteration count: one device and N ranks do the same work
    cfg = ICPConfig(max_iterations=8, min_diff_trans=0.0, min_diff_rot=0.0)
    ratio = torch.tensor(0.7, device=dev)
    eye = se3.identity(device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def timed(fn):
        """(result, mean ms of `iters` calls after one warm-up)."""
        out = fn()
        sync()
        t0 = time.perf_counter()
        for _ in range(p["iters"]):
            out = fn()
        sync()
        return out, (time.perf_counter() - t0) * 1e3 / p["iters"]

    rp, rm = cloud(room_cloud(n=p["n_points"], size=12.0, seed=3,
                              noise=0.005), p["n_points"])
    fp, fm = cloud(room_cloud(n=p["ref_points"], size=12.0, seed=3,
                              noise=0.005), p["ref_points"])
    fn_, _, _ = estimate_normals(fp, fm, k=12)
    rp = se3.transform_points(T_pert, rp)
    mp, mm = cloud(room_cloud(n=p["map_points"], size=16.0, seed=4,
                              noise=0.005), p["map_points"])
    mn, _, _ = estimate_normals(mp, mm, k=12)
    step = p["map_points"] // p["map_reading"]
    qp = se3.transform_points(T_pert, mp[::step][:p["map_reading"]]
                              .contiguous())
    qm = mm[::step][:p["map_reading"]].contiguous()

    out = {}
    for name, fn_one, fn_n, q in (
            ("reading", lambda: point_to_plane_icp(
                rp, rm, fp, fn_, fm, eye, ratio, cfg),
             lambda: sharded_point_to_plane_icp(
                mesh, rp, rm, fp, fn_, fm, eye, ratio, cfg), p["n_points"]),
            ("map", lambda: point_to_plane_icp(
                qp, qm, mp, mn, mm, eye, ratio, cfg),
             lambda: map_sharded_point_to_plane_icp(
                mesh, qp, qm, mp, mn, mm, eye, ratio, cfg),
             p["map_reading"])):
        res1, t1 = timed(fn_one) if mesh.rank == 0 else (None, None)
        resN, tN = timed(fn_n)
        mesh.reset_counts()
        resN = fn_n()
        stats = collective_stats(mesh.counts(), resN.n_iterations)
        if mesh.rank == 0:
            t_err = float(torch.linalg.norm((resN.T @ T_pert)[:3, 3]))
            out[name] = {
                "single_device_ms": t1, "sharded_ms": tN,
                "icp_iterations": resN.n_iterations,
                "collectives": stats["ops"],
                "collective_bytes_per_iteration":
                    stats["bytes_per_iteration"],
                "collective_bytes_per_solve": stats["bytes_per_solve"],
                "collective_bytes_per_point":
                    stats["bytes_per_iteration"] / q,
                "sharded_T_error_m": t_err,
                "sharded_matches_single": bool(np.allclose(
                    resN.T.cpu().numpy(), res1.T.cpu().numpy(),
                    atol=1e-3))}
    return out or None


def run_scaling(n_devices: int = 2, n_points: int = 32768,
                ref_points: int = 8192, iters: int = 10,
                map_points: int = 65536, map_reading: int = 8192,
                device="cuda", timeout_s: float = 1800.0) -> dict:
    """Both ICP layouts on one device and over `n_devices` ranks (rank r on
    card r % cards, or the CPU); returns rank 0's measurements, with the
    backend and the device."""
    import torch

    from ..parallel.mesh import choose_backend, launch

    kind = torch.device(device).type
    params = dict(n_devices=n_devices, n_points=n_points,
                  ref_points=ref_points, iters=iters, map_points=map_points,
                  map_reading=map_reading, device=kind)
    res = launch(_scaling_rank, n_devices, params, device=kind,
                 timeout_s=timeout_s)[0].value
    return {"n_devices": n_devices, "device": (
        torch.cuda.get_device_name(0) if kind == "cuda" else "cpu"),
        "backend": choose_backend(kind, n_devices, torch.cuda.device_count()
                                  if kind == "cuda" else 0),
        "reading_points": n_points, "reference_points": ref_points,
        "map_points": map_points, "map_reading_points": map_reading,
        "reading_sharded": res["reading"], "map_sharded": res["map"]}


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description="distributed ICP over ranks")
    p.add_argument("--devices", type=int, default=2)
    p.add_argument("--points", type=int, default=32768)
    p.add_argument("--ref-points", type=int, default=8192)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    text = json.dumps(run_scaling(n_devices=args.devices,
                                  n_points=args.points,
                                  ref_points=args.ref_points,
                                  device=args.device), indent=1)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
