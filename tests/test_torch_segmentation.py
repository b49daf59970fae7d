"""Parity of the port's hough prefilter with the JAX package's fused
sorted-space prefilter, and its shape-based moments dispatch."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aicp_mapping_tpu.ops import banded_nn as jband
from aicp_mapping_tpu.ops import normals as jnorm
from aicp_mapping_tpu.ops import segmentation as jseg
from aicp_mapping_tpu.ops.segmentation import _hough_prefilter_sorted
from aicp_mapping_tpu.ops.voxel import voxel_downsample
from aicp_mapping_tpu.tools.synthetic import room_cloud
from aicp_mapping_tpu_torch.ops import segmentation as seg

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def voxelized_room():
    """A 4,096-point voxelized room, as the prefilter receives it."""
    raw = room_cloud(n=24000, size=10.0, seed=4, noise=0.005)
    pts, mask = voxel_downsample(jnp.asarray(raw),
                                 jnp.ones(len(raw), bool), 0.08, 4096)
    return np.array(pts), np.array(mask)


VIEWPOINT = np.float32([0.0, 0.0, 1.5])


def _both(pts, mask, capacity):
    want = _hough_prefilter_sorted(jnp.asarray(pts), jnp.asarray(mask),
                                   jnp.asarray(VIEWPOINT), 0.4, 1.0, 20,
                                   capacity)
    got = seg.plane_segmentation_filter(
        torch.as_tensor(pts), torch.as_tensor(mask),
        torch.as_tensor(VIEWPOINT), min_cluster_size=20,
        out_capacity=capacity, normal_radius=0.4)
    return ([np.asarray(a) for a in want[:3]], [a.numpy() for a in got[:3]])


def test_hough_prefilter_order_matches_jax(voxelized_room, monkeypatch):
    """The sorts and tie-breaks, exactly. Fed the same normals, the port
    keeps the same points in the same cluster-balanced round-robin order,
    cut at a capacity below the kept count, as the JAX package's composable
    ops (`_compact_unique_keys` -> `filter_small_clusters` ->
    `_balanced_compaction_perm`, the same math as its fused prefilter)."""
    pts, mask = voxelized_room
    codes = np.asarray(jband.morton_codes(
        jnp.asarray(pts), jnp.asarray(mask),
        jnp.asarray(pts[mask].min(0)), jnp.float32(2.0)))
    order = np.argsort(codes, kind="stable")
    ps, ms = jnp.asarray(pts[order]), jnp.asarray(codes[order] != 2**31 - 1)
    M = jnorm._radius_moments_xla(ps, ms, 0.4)
    nrm, curv, cnt = jnorm.moments_to_normals(M, ps, ms,
                                              jnp.asarray(VIEWPOINT))
    labels = jseg._compact_unique_keys(jseg._hough_key(ps, nrm, 6, 0.15),
                                       ms & (curv <= 1.0))
    keep = jseg.filter_small_clusters(labels, ms, 20)
    perm = np.asarray(jseg._balanced_compaction_perm(labels, keep))[:2048]
    assert np.asarray(keep).sum() > 2048

    monkeypatch.setattr(seg, "moments_for",
                        lambda *a: torch.as_tensor(np.array(M)))
    monkeypatch.setattr(seg, "moments_to_normals", lambda *a: tuple(
        torch.as_tensor(np.array(x)) for x in (nrm, curv, cnt)))
    gp, gm, gn, _, _ = seg.plane_segmentation_filter(
        torch.as_tensor(pts), torch.as_tensor(mask),
        torch.as_tensor(VIEWPOINT), min_cluster_size=20, out_capacity=2048,
        normal_radius=0.4)
    assert bool(gm.all())
    np.testing.assert_array_equal(gp.numpy(), np.asarray(ps)[perm])
    np.testing.assert_array_equal(gn.numpy(), np.asarray(nrm)[perm])


def test_hough_prefilter_matches_jax(voxelized_room):
    """End to end with the port's own moments and normals. Normals of
    two-point neighbourhoods are ill-conditioned (any direction normal to
    the pair), so a few points change plane cells between any two
    implementations, and the round-robin order — which interleaves every
    cluster — is not comparable row by row; the kept set is."""
    pts, mask = voxelized_room
    (wp, wm, _), (gp, gm, _) = _both(pts, mask, 4096)
    kept_w, kept_g = int(wm.sum()), int(gm.sum())
    assert 2000 < kept_w < 4096
    assert abs(kept_g - kept_w) <= 0.01 * kept_w
    want = {tuple(p) for p in np.round(wp[wm], 5)}
    found = np.mean([tuple(p) in want for p in np.round(gp[gm], 5)])
    assert found >= 0.99, found


def test_moments_dispatch_by_shape(monkeypatch):
    """Banded moments for >= 16,384 points in whole 1024-blocks,
    exhaustive otherwise, on every device."""
    calls = []

    def fake(kind):
        def fn(ps, *args, **kw):
            calls.append(kind)
            return torch.zeros((ps.shape[0], 10))
        return fn

    monkeypatch.setattr(seg, "sorted_radius_moments_kernel", fake("banded"))
    monkeypatch.setattr(seg, "radius_moments_kernel", fake("exhaustive"))
    for n in (16384, 32768, 16384 + 512, 8192, 4096, 1000):
        ps = torch.zeros((n, 3))
        seg.moments_for(ps, torch.ones(n, dtype=torch.bool),
                        torch.zeros(n, dtype=torch.int64), 0.4)
    assert calls == ["banded", "banded", "exhaustive", "exhaustive",
                     "exhaustive", "exhaustive"]


def test_unported_segmentation_methods_raise():
    pts = torch.zeros((64, 3))
    mask = torch.ones(64, dtype=torch.bool)
    for kw in (dict(method="region_growing", out_capacity=32),
               dict(method="hough")):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            seg.plane_segmentation_filter(pts, mask, **kw)
