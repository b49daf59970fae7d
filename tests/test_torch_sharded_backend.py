"""The port's edge-sharded PGO and observation-sharded plane BA on gloo CPU
ranks, against the JAX package's sharded solves on meshes of 2 and 4 (of
the 8 virtual CPU devices), and `parallel.dryrun.dryrun_multichip` on a
2 x 2 mesh of ranks.

One launch of 4 ranks serves both solvers at both sizes: a 1-D mesh of 4
("graph") and the "graph" axis of a 2 x 2 mesh. Inputs and results cross
as .npz files; the ranks import nothing of JAX."""
import os

import numpy as np
import pytest
import torch

from aicp_mapping_tpu_torch.parallel import launch

torch.set_num_threads(1)
DEADLINE_S = 240.0
SIZES = (2, 4)
PGO_FIELDS = ("poses", "edges", "measurements", "weights", "edge_mask")
BA_FIELDS = ("poses", "landmarks", "obs_k", "obs_l", "obs_plane", "obs_w",
             "obs_mask")


def _backend_rank(inputs: str, out_dir: str) -> None:
    from aicp_mapping_tpu_torch.parallel import (
        PlaneBA, PoseGraph, make_mesh, make_mesh_2d,
        optimize_plane_ba_sharded, optimize_pose_graph_sharded)

    torch.set_num_threads(1)
    x = {k: torch.as_tensor(v) for k, v in np.load(inputs).items()}
    meshes = {4: make_mesh(4, "graph", device="cpu"),
              2: make_mesh_2d((2, 2), ("points", "graph"), device="cpu")}
    graph = PoseGraph(*(x[f"pgo_{f}"] for f in PGO_FIELDS))
    prob = PlaneBA(*(x[f"ba_{f}"] for f in BA_FIELDS))
    out = {}
    for D, mesh in meshes.items():
        out[f"pgo{D}"], out[f"chi2_{D}"] = (t.numpy() for t in
                                            optimize_pose_graph_sharded(
                                                graph, mesh, axis="graph",
                                                gn_iters=8))
        poses, lms, chi2 = optimize_plane_ba_sharded(prob, mesh,
                                                     axis="graph",
                                                     gn_iters=5)
        out[f"ba{D}"], out[f"lms{D}"] = poses.numpy(), lms.numpy()
    np.savez(os.path.join(out_dir, f"rank{meshes[4].rank}.npz"), **out)


@pytest.fixture(scope="module")
def problems(tmp_path_factory):
    """tests/test_parallel.py's noisy loop (16 poses, one loop closure) and
    tests/test_ba.py's random plane problem, padded for 4 shards."""
    from aicp_mapping_tpu.parallel import pad_edges, pad_observations
    from test_ba import _random_problem
    from test_parallel import noisy_loop_trajectory

    gt, init, edges, Z, w = noisy_loop_trajectory(K=16, seed=1)
    e, z, ww, mask = pad_edges(edges, Z, w, 4)
    prob = pad_observations(_random_problem(seed=5)[0], 4)
    x = {f"pgo_{f}": np.asarray(a) for f, a in zip(PGO_FIELDS,
                                                   (init, e, z, ww, mask))}
    x["pgo_edges"] = x["pgo_edges"].astype(np.int64)
    x.update({f"ba_{f}": np.asarray(getattr(prob, f)) for f in BA_FIELDS})
    for f in ("ba_obs_k", "ba_obs_l"):
        x[f] = x[f].astype(np.int64)
    root = tmp_path_factory.mktemp("sharded_backend")
    np.savez(root / "inputs.npz", **x)
    return root, x, np.asarray(gt)


@pytest.fixture(scope="module")
def port(problems):
    root, _, _ = problems
    launch(_backend_rank, 4, str(root / "inputs.npz"), str(root),
           device="cpu", timeout_s=DEADLINE_S)
    return [dict(np.load(root / f"rank{r}.npz")) for r in range(4)]


@pytest.mark.parametrize("D", SIZES)
def test_pgo_sharded_matches_jax(problems, port, D):
    """Edge-sharded Gauss-Newton + PCG (tests/test_parallel.py:81-95):
    poses within rtol 1e-3 / atol 1e-4 of JAX's sharded solve on a mesh of
    D, equal on every rank, the loop error and chi2 reduced."""
    import jax.numpy as jnp

    from aicp_mapping_tpu.parallel import (PoseGraph, make_mesh,
                                           optimize_pose_graph_sharded)

    _, x, gt = problems
    g = PoseGraph(*(jnp.asarray(x[f"pgo_{f}"].astype(np.int32)
                                if f == "edges" else x[f"pgo_{f}"])
                    for f in PGO_FIELDS))
    want, _ = optimize_pose_graph_sharded(g, make_mesh(D, axis="edges"),
                                          axis="edges", gn_iters=8)
    for r in port:
        np.testing.assert_allclose(r[f"pgo{D}"], np.asarray(want),
                                   rtol=1e-3, atol=1e-4)
        np.testing.assert_array_equal(r[f"pgo{D}"], port[0][f"pgo{D}"])
    chi2 = port[0][f"chi2_{D}"]
    assert chi2[-1] < chi2[0]

    def err(p):
        return np.linalg.norm(p[:, :3, 3] - gt[:, :3, 3], axis=1).mean()

    assert err(port[0][f"pgo{D}"]) < err(x["pgo_poses"])


@pytest.mark.parametrize("D", SIZES)
def test_ba_sharded_matches_jax(problems, port, D):
    """Observation-sharded plane BA (tests/test_ba.py:109-125): poses and
    landmarks within rtol 1e-4 / atol 1e-5 of JAX's sharded solve."""
    import jax.numpy as jnp

    from aicp_mapping_tpu.parallel import (PlaneBA, make_mesh,
                                           optimize_plane_ba_sharded)

    _, x, _ = problems
    prob = PlaneBA(*(jnp.asarray(x[f"ba_{f}"].astype(np.int32)
                                 if f in ("obs_k", "obs_l") else
                                 x[f"ba_{f}"]) for f in BA_FIELDS))
    p, lms, _ = optimize_plane_ba_sharded(prob, make_mesh(D, axis="graph"),
                                          axis="graph", gn_iters=5)
    for r in port:
        np.testing.assert_allclose(r[f"ba{D}"], np.asarray(p), rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(r[f"lms{D}"], np.asarray(lms), rtol=1e-4,
                                   atol=1e-5)


def test_dryrun_multichip_on_a_2x2_mesh():
    """`dryrun_multichip(4)` on CPU ranks: both ICP layouts over "points",
    PGO and BA over "graph" of a 2 x 2 mesh, each phase's sanity check."""
    from aicp_mapping_tpu_torch.parallel.dryrun import (dryrun_multichip,
                                                        mesh_shape)

    assert mesh_shape(4) == (2, 2) and mesh_shape(8) == (2, 4)
    report = dryrun_multichip(4, device="cpu", timeout_s=DEADLINE_S)
    assert report["mesh"] == {"graph": 2, "points": 2}
    assert report["icp_t_err_m"] < 0.05 and report["map_icp_t_err_m"] < 0.05
    assert np.isfinite(report["pgo_chi2"]).all()
    counts = report["counts"]
    pmins = counts["points"]["pmin"]["calls"]       # two per map iteration
    assert pmins > 0 and pmins % 2 == 0
    assert counts["graph"]["psum"]["calls"] > 0
