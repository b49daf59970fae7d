"""The two back-ends side by side: JAX's and the port's (on the CPU)
replayed on the keyframes of one front-end snapshot, round by round, and
on copies of it moved by one ulp. As a script it compares them on an
urban-drive snapshot (`eval.slam_accuracy --snapshot`), as it is or
("ULP_SEED" integers) on copies moved by one ulp, one JSON line each:

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_slam_replay.py \\
        SNAPSHOT.npz [ULP_SEED ...]
"""
import os

import numpy as np

from aicp_mapping_tpu.eval import slam_accuracy as jslam
from aicp_mapping_tpu.pipeline import mapper as jmapper
from aicp_mapping_tpu_torch.eval import slam_accuracy
from aicp_mapping_tpu_torch.pipeline import mapper
from test_torch_slam import (MAPPER_KW, TOL_POSE, _backend_rounds,  # noqa: F401
                             chip_smoke, jax_snapshot)


def perturbed_snapshot(path: str, seed: int, out: str) -> str:
    """A copy of snapshot `path` at `out` whose keyframe points each moved
    by one ulp, up or down at random (`seed`) in every coordinate."""
    z = dict(np.load(path))
    rng = np.random.default_rng(seed)
    p = z["points"].astype(np.float32)
    to = rng.choice([-np.inf, np.inf], size=p.shape).astype(np.float32)
    z["points"] = np.nextafter(p, to)
    np.savez_compressed(out, **z)
    return out


def compare_backends(path: str, mapper_kw: dict) -> dict:
    """JAX's back-end and the port's, on the CPU, replayed on the keyframes
    of one snapshot as `run_backend` runs them: each round's proposed and
    kept closures, whether a closure found by one package only sits at a
    gate edge (`chip_smoke.near_gate`), and the keyframe ATE after the
    front-end, each round and BA."""
    japp, gt, _ = jslam.load_frontend_snapshot(path)
    papp, _, _ = slam_accuracy.load_frontend_snapshot(path, device="cpu")
    mappers = {"jax": jmapper.PoseGraphMapper(japp, **mapper_kw),
               "port": mapper.PoseGraphMapper(papp, **mapper_kw)}
    utimes = [k.utime for k in mappers["port"].keyframes()]

    def ate(poses):
        return round(float(slam_accuracy._keyframe_ate(
            [mapper.Keyframe(0, u, p, None) for u, p in zip(utimes, poses)],
            gt)), 4)

    got = {}
    for name, m in mappers.items():
        front = np.stack([k.pose for k in m.keyframes()])
        got[name] = _backend_rounds(m)
        got[name]["ate"] = [ate(front)] + [ate(got[name][k])
                                           for k in ("pgo1", "pgo2", "ba")]
    out = {"ate": {n: g["ate"] for n, g in got.items()},
           "ba": {n: g["ba_summary"] for n, g in got.items()}}
    for r in (1, 2):
        for stage in ("proposed", "kept"):
            lists = {n: {(lc.i, lc.j): lc for lc in g[f"{stage}{r}"]}
                     for n, g in got.items()}
            only = []
            for n, other in (("jax", "port"), ("port", "jax")):
                for pair in sorted(set(lists[n]) - set(lists[other])):
                    edge = chip_smoke.near_gate(
                        mappers[n], lists[n][pair], got[n][f"pre{r}"],
                        got[n][f"pgo{r}"])
                    only.append(dict(pair=pair, found_by=n,
                                     near_gate=bool(edge)))
            out[f"round{r}_{stage}"] = dict(
                {n: sorted(v) for n, v in lists.items()}, only=only)
    return out


def test_compare_backends_on_jax_keyframes(jax_snapshot, tmp_path):
    """`compare_backends` on JAX's snapshot of the 8-frame loop and on a
    copy moved by one ulp: both packages replay it, and their post-PGO
    keyframes agree within the replay tolerance."""
    path = jax_snapshot[0]
    moved = perturbed_snapshot(path, 1, str(tmp_path / "moved.npz"))
    a, b = np.load(path)["points"], np.load(moved)["points"]
    assert np.all(a != b) and np.all(np.abs(a - b) <= np.spacing(
        np.abs(a)))
    out = compare_backends(moved, MAPPER_KW)
    for key in ("round1_proposed", "round2_kept"):
        assert all(x["near_gate"] for x in out[key]["only"]), out[key]
    assert abs(out["ate"]["jax"][2] - out["ate"]["port"][2]) <= TOL_POSE


if __name__ == "__main__":
    import json
    import sys
    import tempfile

    snap = sys.argv[1]
    with tempfile.TemporaryDirectory() as d:
        for seed in [int(s) for s in sys.argv[2:]] or [None]:
            path = snap if seed is None else perturbed_snapshot(
                snap, seed, os.path.join(d, f"ulp{seed}.npz"))
            print(json.dumps(dict(snapshot=snap, ulp_seed=seed,
                                  **compare_backends(
                                      path, slam_accuracy.MAPPER_KW))),
                  flush=True)
