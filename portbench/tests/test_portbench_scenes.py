"""The scene copy: the same seed gives the same bits, and the walk runs on
across laps without a jump."""
from __future__ import annotations

import numpy as np

from portbench.scenes.room_walk import RoomWalk

WALK = dict(scene_seed=0, world_points=6000, world_size=20.0,
            sensor_range=14.0, step=0.8, yaw_rate_deg=4.0, lap=90, drift_per_frame=0.03,
            drift_yaw_deg=0.4, noise=0.02, start_stride=5)
BIG_SEED = 2**31 + 12345


def _same(a, b):
    for (u1, p1, t1), (u2, p2, t2) in zip(a, b):
        assert u1 == u2
        assert np.array_equal(p1, p2) and np.array_equal(t1, t2)


def test_walk_same_seed_same_bits():
    a, b = RoomWalk(BIG_SEED, **WALK), RoomWalk(BIG_SEED, **WALK)
    _same([a.frame(i) for i in range(0, 200, 17)],
          [b.frame(i) for i in range(0, 200, 17)])
    # another seed: the same frames from another start in the lap
    c = RoomWalk(BIG_SEED + 1, **WALK)
    assert c.offset != a.offset
    shift = (c.offset - a.offset) % a.lap
    for i in range(0, 200, 13):
        assert np.array_equal(a.frame(i + shift)[1], c.frame(i)[1])


def test_walk_runs_on_across_laps():
    w = RoomWalk(7, **WALK)
    step = [np.linalg.inv(w.true_pose(i)) @ w.true_pose(i + 1)
            for i in range(w.lap + 3)]
    # the lap's last step (89 -> 90) is the same motion as every other
    for s in step:
        np.testing.assert_allclose(s, step[0], atol=2e-4)
    # every lap offers the same frames
    assert np.array_equal(w.frame(5)[1], w.frame(5 + w.lap)[1])
    # the prior's error stays one frame's: never more than ~5 sigma
    for i in range(0, 3 * w.lap, 7):
        err = np.linalg.inv(w.true_pose(i)) @ w.prior(i)
        assert np.abs(err[:2, 3]).max() < 0.15
