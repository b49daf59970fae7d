"""The port's process mesh (`aicp_mapping_tpu_torch.parallel.mesh`) on CPU
ranks over gloo: the backend rule, the collectives and their counters on
1-D and 2-D meshes, rank 0's commands to serving ranks, the launcher's
failure handling (a rank that raises, a deadline that passes), and the
two-process bring-up through `initialize_distributed` running the real
solvers (as tests/test_distributed.py does for the JAX package).

The rank functions live here and import nothing of JAX: the spawned ranks
import this module to find them. Every launch has a deadline that kills
its ranks."""
import multiprocessing
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from aicp_mapping_tpu_torch.parallel import launch, make_mesh, make_mesh_2d
from aicp_mapping_tpu_torch.parallel.mesh import RankFailed, choose_backend

torch.set_num_threads(1)
DEADLINE_S = 120.0


def _collectives_rank() -> dict:
    """Every collective on a 1-D mesh of 4 and on both axes of a 2 x 2
    mesh, and one command from rank 0 to the serving ranks."""
    torch.set_num_threads(1)
    line = make_mesh(4, "points", device="cpu")
    grid = make_mesh_2d((2, 2), ("graph", "points"), device="cpu")
    r = line.rank
    x = torch.tensor([float(r + 1), -float(r)])
    out = dict(
        psum=line.psum(x, "points").tolist(),
        pmin=line.pmin(x, "points").tolist(),
        pmax=line.pmax(x, "points").tolist(),
        gather=line.all_gather(torch.tensor([r, 10 + r]), "points").tolist(),
        gather_bool=line.all_gather(torch.tensor([r == 2]),
                                    "points").tolist(),
        gather_zero=line.all_gather(torch.tensor([-0.0]), "points")
        .view(torch.int32).tolist(),
        broadcast=line.broadcast(torch.tensor([7 * r + 1])).tolist(),
        psum_graph=grid.psum(torch.tensor([float(r)]), "graph").tolist(),
        psum_points=grid.psum(torch.tensor([float(r)]), "points").tolist(),
        coords=grid.coords,
        shard=(line.shard(8, "points"), grid.shard(8, "points")),
        counts=line.counts())
    if r == 0:
        line.send("echo", [torch.arange(5), torch.ones(2, 2,
                                                       dtype=torch.bool)],
                  k=3)
        line.stop_serving()
    else:
        got = []
        line.serve({"echo": lambda t, o: got.append(
            ([a.tolist() for a in t], o))})
        out["served"] = got
    return out


def _failing_rank() -> int:
    """Rank 1 raises; rank 0 waits in a psum that can never finish."""
    mesh = make_mesh(2, "points", device="cpu")
    if mesh.rank == 1:
        raise ValueError("rank 1 fails on purpose")
    mesh.psum(torch.ones(1), "points")
    return 0


def _sleeping_rank() -> int:
    time.sleep(600)
    return 0


def test_backend_rule_and_single_process_mesh():
    """NCCL only when every rank has a card of its own; a mesh of one
    process without a process group reduces to the identity."""
    assert choose_backend("cuda", 1, 1) == "nccl"
    assert choose_backend("cuda", 2, 4) == "nccl"
    assert choose_backend("cuda", 2, 1) == "gloo"       # ranks share a card
    assert choose_backend("cpu", 4, 8) == "gloo"
    mesh = make_mesh(1, "edges", device="cpu")
    assert mesh.shape == {"edges": 1} and mesh.index("edges") == 0
    x = torch.tensor([1.5, -2.0])
    for op in (mesh.psum, mesh.pmin, mesh.pmax):
        assert torch.equal(op(x, "edges"), x)
    assert torch.equal(mesh.all_gather(x, "edges"), x[None])
    assert mesh.counts()["edges"]["psum"] == {"calls": 1, "bytes": 8}
    with pytest.raises(ValueError, match="world of 1"):
        make_mesh(2, "points", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_mesh(1, "points")
        with pytest.raises(RuntimeError, match="CUDA"):
            launch(_sleeping_rank, 2)


def test_collectives_on_four_ranks():
    results = launch(_collectives_rank, 4, device="cpu",
                     timeout_s=DEADLINE_S)
    for r, res in enumerate(results):
        v = res.value
        assert v["psum"] == [10.0, -6.0]
        assert v["pmin"] == [1.0, -3.0]
        assert v["pmax"] == [4.0, 0.0]
        assert v["gather"] == [[0, 10], [1, 11], [2, 12], [3, 13]]
        assert v["gather_bool"] == [[False], [False], [True], [False]]
        assert v["gather_zero"] == [[-2 ** 31]] * 4      # -0.0, bit for bit
        assert v["broadcast"] == [1]
        # row-major coordinates; "graph" groups columns, "points" rows
        assert v["coords"] == {"graph": r // 2, "points": r % 2}
        assert v["psum_graph"] == [float(2 + 2 * (r % 2))]
        assert v["psum_points"] == [float(1 + 4 * (r // 2))]
        assert v["shard"] == (slice(2 * r, 2 * r + 2),
                              slice(4 * (r % 2), 4 * (r % 2) + 4))
        c = v["counts"]["points"]
        assert c["psum"] == {"calls": 1, "bytes": 8}
        assert c["all_gather"] == {"calls": 3, "bytes": 4 * 16 + 4 + 16}
        if r:
            assert v["served"] == [([[0, 1, 2, 3, 4],
                                     [[True, True], [True, True]]],
                                    {"k": 3})]
        assert all(n == 0 for n in res.launches.values())


def test_failing_rank_raises_within_deadline():
    """A rank that raises makes the launcher kill the rank left waiting in
    a collective and raise that rank's exception at once; ranks that
    outlive the deadline are killed and reported. No process is left."""
    t0 = time.monotonic()
    with pytest.raises(RankFailed, match="rank 1 of 2") as info:
        launch(_failing_rank, 2, device="cpu", timeout_s=DEADLINE_S)
    assert isinstance(info.value.__cause__, ValueError)
    assert time.monotonic() - t0 < DEADLINE_S / 2
    t0 = time.monotonic()
    with pytest.raises(RankFailed, match="did not finish within 20"):
        launch(_sleeping_rank, 2, device="cpu", timeout_s=20)
    assert time.monotonic() - t0 < 40
    assert multiprocessing.active_children() == []


_BRINGUP = r"""
import json, sys
import numpy as np
import torch
torch.set_num_threads(1)
from aicp_mapping_tpu_torch.cloud import Cloud
from aicp_mapping_tpu_torch.geometry import se3
from aicp_mapping_tpu_torch.ops.normals import estimate_normals
from aicp_mapping_tpu_torch.parallel import (
    PoseGraph, initialize_distributed, make_mesh, make_odometry_edges,
    optimize_pose_graph, optimize_pose_graph_sharded,
    sharded_point_to_plane_icp)
from aicp_mapping_tpu_torch.registration.icp import point_to_plane_icp
from aicp_mapping_tpu_torch.tools.synthetic import room_cloud

store, pid, out_path = sys.argv[1], int(sys.argv[2]), sys.argv[3]
backend = initialize_distributed(store, num_processes=2, process_id=pid,
                                 device="cpu", timeout_s=120)
mesh = make_mesh(2, "points", device="cpu")
report = {"backend": backend, "world": torch.distributed.get_world_size()}
# each process contributes its slice of a global (2, 4) array
got = mesh.psum(torch.full((4,), float(pid + 1)), "points")
report["psum"] = got.tolist()

# the real solvers: sharded ICP and edge-sharded PGO
pts = Cloud.from_numpy(room_cloud(n=2300, seed=5, noise=0.005)[:2048],
                       capacity=2048, device="cpu")
normals, _, _ = estimate_normals(pts.points, pts.mask, k=12)
T_pert = se3.make_transform(se3.so3_exp(torch.tensor([0.01, -0.02, 0.05])),
                            torch.tensor([0.1, -0.08, 0.05]))
reading = se3.transform_points(T_pert, pts.points)
mesh.reset_counts()
res = sharded_point_to_plane_icp(mesh, reading, pts.mask, pts.points,
                                 normals, pts.mask, se3.identity(), 0.7)
one = point_to_plane_icp(reading, pts.mask, pts.points, normals, pts.mask,
                         se3.identity(), torch.tensor(0.7))
report["icp_T"] = res.T.tolist()
report["icp_matches_single"] = bool(torch.allclose(res.T, one.T,
                                                   atol=1e-4))
report["icp_recovers_pert_m"] = float(torch.linalg.norm(
    (res.T @ T_pert)[:3, 3]))
report["icp_bytes"] = sum(c["bytes"] for a in mesh.counts().values()
                          for c in a.values())

rng = np.random.default_rng(11)
K = 8
step = se3.make_transform(se3.so3_exp(torch.tensor([0.0, 0.0, 2 * np.pi / K])),
                          torch.tensor([1.0, 0.0, 0.0]))
gt = [torch.eye(4)]
for _ in range(K - 1):
    gt.append(gt[-1] @ step)
gt = torch.stack(gt)
noisy = gt.clone()
for i in range(1, K):
    noisy[i] = noisy[i] @ se3.se3_exp(torch.as_tensor(
        rng.normal(0, 0.02, 6), dtype=torch.float32))
edges, Z, w = make_odometry_edges(gt)
# one loop edge 0 -> K-1 closes the ring (E = 8, divisible by 2)
edges = torch.cat([edges, torch.tensor([[0, K - 1]])])
Z = torch.cat([Z, (se3.inverse(gt[0]) @ gt[-1])[None]])
w = torch.cat([w, w[:1]])
g = PoseGraph(noisy, edges, Z, w, torch.ones(K, dtype=torch.bool))
opt_sh, chi2 = optimize_pose_graph_sharded(g, mesh, axis="points")
opt_1p, _ = optimize_pose_graph(g)
report["pgo_matches_single"] = bool(torch.allclose(opt_sh, opt_1p,
                                                   atol=1e-3))
report["pgo_ate_before_m"] = float(
    (noisy[:, :3, 3] - gt[:, :3, 3]).norm(dim=1).mean())
report["pgo_ate_after_m"] = float(
    (opt_sh[:, :3, 3] - gt[:, :3, 3]).norm(dim=1).mean())
with open(out_path, "w") as f:
    json.dump(report, f)
print(f"WORKER{pid} OK")
"""


def test_two_process_bringup_and_real_solvers(tmp_path):
    """Two OS processes rendezvous through `initialize_distributed` (a
    file:// store), psum across the processes, and run the sharded ICP
    and the edge-sharded PGO, each agreeing with the single-process
    solve."""
    import json

    script = tmp_path / "worker.py"
    script.write_text(_BRINGUP)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))
    store = f"file://{tmp_path / 'store'}"
    outs = [tmp_path / f"report{i}.json" for i in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, str(script), store, str(i), str(outs[i])],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=DEADLINE_S)[0])
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for i, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"worker {i} failed:\n{log}"
        assert f"WORKER{i} OK" in log, log
    reports = [json.loads(o.read_text()) for o in outs]
    for r in reports:
        assert r["backend"] == "gloo" and r["world"] == 2
        assert r["psum"] == [3.0] * 4
        assert r["icp_matches_single"], r
        assert r["icp_recovers_pert_m"] < 0.02, r
        assert r["pgo_matches_single"], r
        assert r["pgo_ate_after_m"] < r["pgo_ate_before_m"] * 0.5, r
        # O(1) collective volume (the all-gather of the per-point outputs
        # aside): histograms and the normal equations, not the points
        assert r["icp_bytes"] < 65536, r
    np.testing.assert_array_equal(reports[0]["icp_T"], reports[1]["icp_T"])
