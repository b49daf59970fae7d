"""The port's progressive morphological ground filter against the JAX
package's (CPU), on tests/test_tools.py's scenes and on raycast urban
scans at the KITTI runner's raster (0.5 m cells, 256 x 256)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aicp_mapping_tpu.cloud import Cloud as JCloud
from aicp_mapping_tpu.ops import ground as jground
from aicp_mapping_tpu_torch.cloud import Cloud
from aicp_mapping_tpu_torch.ops import ground
from aicp_mapping_tpu_torch.tools.urban import (drive_trajectory,
                                                make_urban_world,
                                                velodyne_scan)

torch.set_num_threads(1)
# share of labels equal to JAX's: the raster centre is rounded once from a
# float64 sum in the port and summed in float32 by XLA, and a centre one
# ulp apart can move points across cell edges
MIN_EQUAL = 0.999


def _ground_scene(seed=0):
    """Flat ground plane + two box 'objects' standing on it
    (tests/test_tools.py)."""
    rng = np.random.default_rng(seed)
    g = np.column_stack([
        rng.uniform(-20, 20, 4000), rng.uniform(-20, 20, 4000),
        rng.normal(0, 0.02, 4000)]).astype(np.float32)
    box1 = np.column_stack([
        rng.uniform(2, 4, 800), rng.uniform(2, 4, 800),
        rng.uniform(0.5, 2.5, 800)]).astype(np.float32)
    box2 = np.column_stack([
        rng.uniform(-8, -6, 800), rng.uniform(1, 3, 800),
        rng.uniform(0.5, 3.5, 800)]).astype(np.float32)
    return g, np.concatenate([box1, box2])


def _slope_scene():
    rng = np.random.default_rng(1)
    x = rng.uniform(-20, 20, 3000)
    y = rng.uniform(-20, 20, 3000)
    z = 0.1 * x + rng.normal(0, 0.02, 3000)
    return np.column_stack([x, y, z]).astype(np.float32)


def _urban_scan(frame: int):
    world = make_urban_world(seed=0)
    pose = drive_trajectory(frame + 1, world, speed=10.0)[frame]
    return velodyne_scan(world, pose, n_azimuth=512, seed=frame)


def _scenes():
    g, objects = _ground_scene()
    return {
        "boxes": (np.concatenate([g, objects]), 8192, dict(
            cell_size=0.5, grid_dim=128)),
        "slope": (_slope_scene(), 4096, dict(cell_size=0.5, grid_dim=128)),
        "boxes_default": (np.concatenate([g, objects]), 8192, {}),
        "urban_0": (_urban_scan(0), 32768, dict(cell_size=0.5,
                                                grid_dim=256)),
        "urban_7": (_urban_scan(7), 32768, dict(cell_size=0.5,
                                                grid_dim=256)),
    }


SCENES = _scenes()


@jax.jit
def _jax_center(points, mask):
    """JAX's raster centre (`ground_mask`'s own expression)."""
    m_f = mask.astype(jnp.float32)
    denom = jnp.maximum(jnp.sum(m_f), 1.0)
    return jnp.sum(points[:, :2] * m_f[:, None], axis=0) / denom


@pytest.mark.parametrize("name", sorted(SCENES))
def test_ground_mask_matches_jax(name, monkeypatch):
    pts, cap, kw = SCENES[name]
    jc = JCloud.from_numpy(pts, capacity=cap)
    want = np.asarray(jground.ground_mask(
        jc.points, jc.mask, jground.GroundFilterConfig(**kw)))
    c = Cloud.from_numpy(pts, capacity=cap)
    cfg = ground.GroundFilterConfig(**kw)
    got = ground.ground_mask(c.points, c.mask, cfg).numpy()
    assert (got == want).mean() >= MIN_EQUAL, (got != want).sum()
    # the centre: JAX's float32 sum within its rounding
    center = torch.as_tensor(np.array(_jax_center(jc.points, jc.mask)))
    np.testing.assert_allclose(ground.raster_center(c.points, c.mask),
                               center, rtol=1e-5, atol=1e-5)
    assert not got[len(pts):].any()
    # given JAX's centre, every label is JAX's
    monkeypatch.setattr(ground, "raster_center", lambda p, m: center)
    np.testing.assert_array_equal(
        ground.ground_mask(c.points, c.mask, cfg).numpy(), want)


def test_ground_filter_separates_objects():
    """tests/test_tools.py's assertions on the port."""
    g, objects = _ground_scene()
    pts = np.concatenate([g, objects])
    cloud = Cloud.from_numpy(pts, capacity=8192)
    non_ground, grd = ground.remove_ground(
        cloud.points, cloud.mask,
        ground.GroundFilterConfig(cell_size=0.5, grid_dim=128))
    non_ground, grd = non_ground.numpy(), grd.numpy()
    n = len(pts)
    is_object = np.zeros(8192, bool)
    is_object[len(g):n] = True
    is_ground = np.zeros(8192, bool)
    is_ground[:len(g)] = True
    assert np.sum(non_ground & is_object) / len(objects) > 0.9
    assert np.sum(grd & is_ground) / len(g) > 0.9
    assert not np.any(non_ground[n:]) and not np.any(grd[n:])
    assert not np.any(non_ground & grd)


def test_ground_filter_sloped_terrain():
    """A 10 % slope is still ground (tests/test_tools.py)."""
    cloud = Cloud.from_numpy(_slope_scene(), capacity=4096)
    _, grd = ground.remove_ground(
        cloud.points, cloud.mask,
        ground.GroundFilterConfig(cell_size=0.5, grid_dim=128))
    assert grd.numpy()[:3000].mean() > 0.8


@pytest.mark.parametrize("kw", [{}, dict(max_window_size=2),
                                dict(max_window_size=9, base=3.0)])
def test_window_sizes_match_jax(kw):
    assert ground._window_sizes(ground.GroundFilterConfig(**kw)) == \
        jground._window_sizes(jground.GroundFilterConfig(**kw))


def test_empty_and_offset_clouds():
    """No valid point: nothing is ground; a cloud far from the origin is
    rasterized around its own centre."""
    pts = torch.zeros((1024, 3))
    mask = torch.zeros(1024, dtype=torch.bool)
    assert not ground.ground_mask(pts, mask).any()
    g, objects = _ground_scene(seed=2)
    scene = np.concatenate([g, objects]) + np.float32([500.0, -300.0, 20.0])
    c = Cloud.from_numpy(scene, capacity=8192)
    jc = JCloud.from_numpy(scene, capacity=8192)
    kw = dict(cell_size=0.5, grid_dim=128)
    got = ground.ground_mask(c.points, c.mask,
                             ground.GroundFilterConfig(**kw)).numpy()
    want = np.asarray(jground.ground_mask(jc.points, jc.mask,
                                          jground.GroundFilterConfig(**kw)))
    assert (got == want).mean() >= MIN_EQUAL
    assert got[:len(g)].mean() > 0.9
