"""The port's single-device map localizer against the JAX package's
`ShardedMapLocalizer` on a mesh of one device: the same Morton order, map,
per-frame crop and corrected poses on a drifting walk through a room
(tests/test_parallel.py's walk), and state carried across with `convert`."""
import numpy as np
import pytest
import torch

from aicp_mapping_tpu.parallel import ShardedMapLocalizer as JaxLocalizer
from aicp_mapping_tpu.parallel import make_mesh
from aicp_mapping_tpu.parallel import morton_argsort_np as jax_morton_argsort
from aicp_mapping_tpu.registration.icp import ICPConfig as JaxICPConfig
from aicp_mapping_tpu.tools.synthetic import room_cloud
from aicp_mapping_tpu_torch import convert
from aicp_mapping_tpu_torch.parallel import (ShardedMapLocalizer,
                                             morton_argsort_np)
from aicp_mapping_tpu_torch.registration.icp import ICPConfig
from test_golden import TOLERANCES

torch.set_num_threads(1)
# a map below 16,384 points: both packages take exhaustive normals on CPU
WORLD = room_cloud(n=15000, size=10.0, seed=13, noise=0.005)
KW = dict(trim_ratio=0.7, max_correction_magnitude=0.3, out_capacity=4096)
ICP = dict(nn_mode="banded", nn_cell_size=2.0)


def _walk(n_frames):
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
        near = WORLD[np.linalg.norm(WORLD - gt[:3, 3], axis=1) < 6.0]
        sel = near[rng.choice(len(near), 4000, replace=False)]
        local = (sel - gt[:3, 3]) @ gt[:3, :3]
        drift += rng.normal(0, 0.02, 3).astype(np.float32)
        odom = gt.copy()
        odom[:3, 3] += drift + offset
        yield local.astype(np.float32), odom, gt


@pytest.mark.parametrize("cell", [1.0, 0.25])
def test_morton_argsort_np_matches_jax(cell):
    rng = np.random.default_rng(2)
    pts = rng.uniform(-30, 30, (5000, 3)).astype(np.float32)
    pts[::7] = pts[1::7][:len(pts[::7])]               # exact ties
    np.testing.assert_array_equal(morton_argsort_np(pts, cell),
                                  jax_morton_argsort(pts, cell))


@pytest.fixture(scope="module")
def localizers():
    jax_loc = JaxLocalizer(make_mesh(1, axis="points"), WORLD,
                           JaxICPConfig(**ICP), **KW)
    loc = ShardedMapLocalizer(WORLD, ICPConfig(**ICP), device="cpu", **KW)
    return jax_loc, loc


def test_localizer_matches_jax(localizers):
    """The same map and normals at load, the same crop rows in the same
    order every frame, and the same corrected poses (within 1 mm here;
    the golden tolerances are 2 cm / 5 cm), every frame within 6 cm of
    the ground truth."""
    jax_loc, loc = localizers
    np.testing.assert_array_equal(loc.map_points.numpy(),
                                  np.asarray(jax_loc.map_points))
    np.testing.assert_array_equal(loc.map_mask.numpy(),
                                  np.asarray(jax_loc.map_mask))
    dots = np.abs((loc.map_normals.numpy()
                   * np.asarray(jax_loc.map_normals)).sum(1))
    assert (dots[loc.map_mask.numpy()] > 0.999).mean() >= 0.99
    for local, odom, gt in _walk(3):
        pose = loc.total_correction @ odom
        np.testing.assert_allclose(loc.total_correction,
                                   jax_loc.total_correction, atol=1e-4)
        got = [a.numpy() for a in loc.provide_reference(pose)]
        want = [np.asarray(a) for a in jax_loc.provide_reference(pose)]
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        pj = jax_loc.localize(local, odom)
        pt = loc.localize(local, odom)
        rj, rt = jax_loc.last_result, loc.last_result
        assert (rt.accepted, rt.registered, rt.reference_id) == \
            (rj.accepted, rj.registered, rj.reference_id) == (True, True, -1)
        assert rt.octree_overlap == rj.octree_overlap == 50.0
        assert abs(rt.n_iterations - rj.n_iterations) <= 1
        np.testing.assert_allclose(rt.correction[:3, 3], rj.correction[:3, 3],
                                   atol=min(1e-3, TOLERANCES["correction_t"]))
        np.testing.assert_allclose(pt, pj, atol=1e-3)
        assert np.linalg.norm(pt[:3, 3] - gt[:3, 3]) < 0.06


def test_localizer_state_round_trips(localizers):
    """A second localizer built from the first one's state, over its
    prepared map (no normals pass), localizes the next frame exactly as the
    first does."""
    _, loc = localizers
    state = convert.localizer_state_to_numpy(loc)
    twin = convert.localizer_from_state(state, ICPConfig(**ICP),
                                        device="cpu", **KW)
    again = convert.localizer_state_to_numpy(twin)
    for k in ("map_points", "map_mask", "map_normals"):
        np.testing.assert_array_equal(again[k], state[k])
    assert again["frame_idx"] == state["frame_idx"]
    assert again["app"]["graph_ids"] == state["app"]["graph_ids"]
    local, odom, _ = list(_walk(4))[-1]
    np.testing.assert_array_equal(twin.localize(local, odom),
                                  loc.localize(local, odom))
