"""The port's map-sharded localizer on two gloo CPU ranks against the JAX
package's `ShardedMapLocalizer` on a mesh of two devices: the same Morton
blocks, per-block normals (seams included), the same crop rows every
frame, the blocked state carried across by `convert`, and the drifting
walk of tests/test_parallel.py:277-309 locked to ground truth.

One launch of 2 ranks: rank 0 holds the App and localizes, rank 1 serves
its crops. Inputs and results cross as .npz files; the ranks import nothing
of JAX."""
import os

import numpy as np
import pytest
import torch

from aicp_mapping_tpu_torch.parallel import launch

torch.set_num_threads(1)
DEADLINE_S = 300.0
FRAMES = 5
KW = dict(trim_ratio=0.7, max_correction_magnitude=0.3, out_capacity=4096)
ICP = dict(nn_mode="banded", nn_cell_size=2.0)


def _world():
    """tests/test_torch_localizer.py's room below 16,384 points: both
    packages take exhaustive normals on the CPU, blocks of 8,192 rows."""
    from aicp_mapping_tpu_torch.tools.synthetic import room_cloud

    return room_cloud(n=15000, size=10.0, seed=13, noise=0.005)


def _walk(world, n_frames):
    """(sensor-frame scan, odometry pose, ground truth) per frame: 0.4 m
    steps, odometry drifting 2 cm per frame on top of a first-frame offset
    beyond the correction gate."""
    rng = np.random.default_rng(4)
    gt = np.eye(4, dtype=np.float32)
    offset = np.array([0.6, -0.5, 0.0], np.float32)
    drift = np.zeros(3, np.float32)
    for _ in range(n_frames):
        gt = gt.copy()
        gt[:3, 3] += [0.4, 0.1, 0.0]
        near = world[np.linalg.norm(world - gt[:3, 3], axis=1) < 6.0]
        sel = near[rng.choice(len(near), 4000, replace=False)]
        local = (sel - gt[:3, 3]) @ gt[:3, :3]
        drift += rng.normal(0, 0.02, 3).astype(np.float32)
        odom = gt.copy()
        odom[:3, 3] += drift + offset
        yield local.astype(np.float32), odom, gt


def _localizer_rank(inputs: str, out_dir: str) -> None:
    from aicp_mapping_tpu_torch import convert
    from aicp_mapping_tpu_torch.parallel import (ShardedMapLocalizer,
                                                 make_mesh)
    from aicp_mapping_tpu_torch.registration.icp import ICPConfig

    torch.set_num_threads(1)
    x = dict(np.load(inputs))
    mesh = make_mesh(2, "points", device="cpu")
    world = _world()
    out = {}
    own = ShardedMapLocalizer(world, ICPConfig(**ICP), mesh=mesh, **KW)
    out["normals"] = own.map_normals.numpy()
    out["points"] = own.map_points.numpy()
    jax_state = dict(map_points=x["map_points"], map_mask=x["map_mask"],
                     map_normals=x["map_normals"],
                     block_size=int(x["block_size"]),
                     rev_bits=int(x["rev_bits"]), app=None, frame_idx=0)
    if mesh.rank != 0:
        own.serve()
        convert.localizer_from_state(jax_state, ICPConfig(**ICP), mesh=mesh,
                                     **KW).serve()
    else:
        for i, pose in enumerate(x["crop_poses"]):
            p, m, _ = own.provide_reference(pose)
            out[f"own_crop{i}"], out[f"own_crop_mask{i}"] = (p.numpy(),
                                                            m.numpy())
        state = convert.localizer_state_to_numpy(own)
        out.update({f"state_{k}": state[k] for k in (
            "map_points", "map_mask", "block_size", "rev_bits")})
        own.stop_serving()
        loc = convert.localizer_from_state(jax_state, ICPConfig(**ICP),
                                           mesh=mesh, **KW)
        for i, pose in enumerate(x["crop_poses"]):
            p, m, n = loc.provide_reference(pose)
            out[f"crop{i}"], out[f"crop_mask{i}"], out[f"crop_n{i}"] = (
                p.numpy(), m.numpy(), n.numpy())
        for i, (local, odom, _) in enumerate(_walk(world, FRAMES)):
            out[f"pose{i}"] = loc.localize(local, odom)
        loc.stop_serving()
    np.savez(os.path.join(out_dir, f"rank{mesh.rank}.npz"), **out)


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """JAX's localizer on a mesh of 2: its blocked state and its crops at
    the walk's ground-truth poses."""
    import jax.numpy as jnp

    from aicp_mapping_tpu.parallel import ShardedMapLocalizer as JLocalizer
    from aicp_mapping_tpu.parallel import make_mesh
    from aicp_mapping_tpu.registration.icp import ICPConfig as JICPConfig

    world = _world()
    loc = JLocalizer(make_mesh(2, axis="points"), world, JICPConfig(**ICP),
                     **KW)
    cap = loc.map_points.shape[0]
    poses = np.stack([gt for _, _, gt in _walk(world, 3)])
    x = dict(map_points=np.asarray(loc.map_points).reshape(2, -1, 3),
             map_mask=np.asarray(loc.map_mask).reshape(2, -1),
             map_normals=np.asarray(loc.map_normals).reshape(2, -1, 3),
             block_size=np.int64(cap // 2),
             rev_bits=np.int64(max(17, int(np.ceil(np.log2(cap))))),
             crop_poses=poses)
    crops = [[np.asarray(a) for a in loc.provide_reference(jnp.asarray(p))]
             for p in poses]
    root = tmp_path_factory.mktemp("sharded_localizer")
    np.savez(root / "inputs.npz", **x)
    return root, x, crops


@pytest.fixture(scope="module")
def port(jax_side):
    root, _, _ = jax_side
    launch(_localizer_rank, 2, str(root / "inputs.npz"), str(root),
           device="cpu", timeout_s=DEADLINE_S)
    return [dict(np.load(root / f"rank{r}.npz")) for r in range(2)]


def test_blocks_and_block_normals_match_jax(jax_side, port):
    """Each rank holds JAX's block of the Morton-ordered map, and its
    radius normals agree with JAX's per-block normals (seams included) to
    the normals parity tests' tolerance; the gathered blocked state is
    JAX's."""
    _, x, _ = jax_side
    for r, res in enumerate(port):
        np.testing.assert_array_equal(res["points"], x["map_points"][r])
        mask = x["map_mask"][r]
        dots = np.abs((res["normals"] * x["map_normals"][r]).sum(1))
        assert (dots[mask] > 0.999).mean() >= 0.99
    p = port[0]
    np.testing.assert_array_equal(p["state_map_points"], x["map_points"])
    np.testing.assert_array_equal(p["state_map_mask"], x["map_mask"])
    assert int(p["state_block_size"]) == int(x["block_size"]) == 8192
    assert int(p["state_rev_bits"]) == int(x["rev_bits"]) == 17


def test_crop_rows_match_jax(jax_side, port):
    """Each rank cuts its block by (outside the box, bit-reversed global
    row); rank 0's merge gives the rows of JAX's global sort, in order:
    from JAX's state the points, mask and normals equal, from the port's
    own load the points and mask."""
    _, _, crops = jax_side
    p = port[0]
    for i, (pts, mask, normals) in enumerate(crops):
        np.testing.assert_array_equal(p[f"crop{i}"], pts)
        np.testing.assert_array_equal(p[f"crop_mask{i}"], mask)
        np.testing.assert_array_equal(p[f"crop_n{i}"], normals)
        np.testing.assert_array_equal(p[f"own_crop{i}"], pts)
        np.testing.assert_array_equal(p[f"own_crop_mask{i}"], mask)
        assert mask.sum() > 0


def test_walk_locks_to_ground_truth(jax_side, port):
    """tests/test_parallel.py:277-309's walk through the localizer built
    from JAX's blocked state: the first frame absorbs the 0.78 m offset and
    every frame is within 0.06 m of the ground truth."""
    world = _world()
    errs = [np.linalg.norm(port[0][f"pose{i}"][:3, 3] - gt[:3, 3])
            for i, (_, _, gt) in enumerate(_walk(world, FRAMES))]
    assert max(errs) < 0.06, errs
