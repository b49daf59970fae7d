"""The int16 wire format of the port against the JAX package's (CPU):
`Cloud.from_numpy(quantize=True)`, `Cloud.from_wire_q16`, `wire_cloud`
and `wire_batch`, the mask rebuilt from the count and the points after the
device dequantize.

The port dequantizes `q * scale + center` rounded once (a fused
multiply-add) on every axis. XLA on the CPU contracts the x and y columns
of JAX's `_dequantize_jit` into fused multiply-adds but, in its vectorized
loop, not z (the loop's remainder rows and thread-partition edges are
contracted): JAX's z is then the product rounded and the sum rounded, at
most one ulp from the port's. So x and y are held bit for bit, and z to
one of the two roundings."""
import dataclasses

import numpy as np
import pytest
import torch

from aicp_mapping_tpu import native as jnative
from aicp_mapping_tpu.cloud import Cloud as JCloud
from aicp_mapping_tpu.pipeline import sequence as jsequence
from aicp_mapping_tpu_torch import convert, native
from aicp_mapping_tpu_torch.cloud import Cloud, _fma_f32
from aicp_mapping_tpu_torch.pipeline import sequence
from test_pipeline import small_config


def _cloud(n, seed, scale=30.0, offset=(0.0, 0.0, 0.0)):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-scale, scale, (n, 3)) + np.asarray(offset)
    return pts.astype(np.float32)


def _assert_dequantized(got: Cloud, want: JCloud, q, scale, center):
    """Mask equal; the port's points are the correctly rounded FMA; JAX's
    agree bit for bit on x and y, and on z up to XLA's contraction."""
    gm, wm = got.mask.numpy(), np.asarray(want.mask)
    np.testing.assert_array_equal(gm, wm)
    gp, wp = got.points.numpy(), np.asarray(want.points)
    assert gp.dtype == np.float32 and gp.shape == wp.shape
    np.testing.assert_array_equal(gp, native._fma32(q, scale, center))
    np.testing.assert_array_equal(gp[:, :2], wp[:, :2])
    unfused = (q.astype(np.float32) * scale) + center
    z_ok = (gp[:, 2] == wp[:, 2]) | (wp[:, 2] == unfused[:, 2])
    assert z_ok.all(), np.flatnonzero(~z_ok)[:10]


CLOUDS = {
    "random": (_cloud(5000, 1), 8192),
    "far": (_cloud(3000, 2, 4.0, (55.0, -40.0, 2.0)), 4096),
    "subsampled": (_cloud(9000, 3), 4096),
    "one point": (_cloud(1, 4), 16),
    "flat": (np.c_[_cloud(700, 5)[:, :2], np.full(700, 1.5, np.float32)],
             1024),
}


@pytest.mark.parametrize("case", sorted(CLOUDS))
def test_from_numpy_quantize_matches_jax(case):
    pts, cap = CLOUDS[case]
    got = Cloud.from_numpy(pts, capacity=cap, quantize=True)
    want = JCloud.from_numpy(pts, capacity=cap, quantize=True)
    sub = pts if len(pts) <= cap else \
        pts[np.linspace(0, len(pts) - 1, cap).astype(np.int64)]
    q = np.zeros((cap, 3), np.int16)
    q[:len(sub)], scale, center = native.quantize_q16(sub)
    _assert_dequantized(got, want, q, scale, center)
    assert int(got.count()) == int(want.count()) == len(sub)
    assert not got.pre_voxelized


def test_from_numpy_quantize_empty_cloud_takes_the_raw_path():
    got = Cloud.from_numpy(np.zeros((0, 3), np.float32), capacity=32,
                           quantize=True)
    want = JCloud.from_numpy(np.zeros((0, 3), np.float32), capacity=32,
                             quantize=True)
    np.testing.assert_array_equal(got.points.numpy(),
                                  np.asarray(want.points))
    assert int(got.count()) == 0 == int(want.count())


@pytest.mark.parametrize("voxel,cap", [(0.08, 4096), (0.5, 512), (1.0, 8)])
def test_from_wire_q16_matches_jax(voxel, cap):
    pts = _cloud(6000, 6, 6.0)
    q, scale, center, n = native.voxel_downsample_q16(pts, voxel, cap)
    got = Cloud.from_wire_q16(q, scale, center, n)
    want = JCloud.from_wire_q16(*jnative.voxel_downsample_q16(pts, voxel,
                                                               cap))
    _assert_dequantized(got, want, q, scale, center)


def test_fma_matches_its_numpy_twin():
    """The dequantize's torch FMA and the host twin `native._fma32` give the
    same bits (the card runs the torch one)."""
    rng = np.random.default_rng(7)
    q = rng.integers(-32767, 32768, (20000, 3)).astype(np.int16)
    scale = rng.uniform(1e-6, 3e-3, 3).astype(np.float32)
    center = rng.uniform(-100, 100, 3).astype(np.float32)
    got = _fma_f32(torch.from_numpy(q), torch.from_numpy(scale),
                   torch.from_numpy(center)).numpy()
    np.testing.assert_array_equal(got, native._fma32(q, scale, center))


WIRE = {
    "raw": {},
    "quantized": dict(quantized_upload=True),
    "voxel": dict(wire_voxel=0.08),
    "voxel and quantized": dict(wire_voxel=0.08, quantized_upload=True),
}


@pytest.mark.parametrize("wire", sorted(WIRE))
def test_wire_cloud_matches_jax(wire):
    jcfg = small_config(**WIRE[wire])
    cfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    pts = _cloud(6000, 8, 8.0)
    got = sequence.wire_cloud(cfg, pts, device="cpu")
    want = jsequence.wire_cloud(jcfg, pts)
    assert got.pre_voxelized == want.pre_voxelized == (
        jcfg.wire_voxel > 0)
    assert got.capacity == want.capacity
    if jcfg.quantized_upload:
        if jcfg.wire_voxel > 0:
            q, scale, center, _ = native.voxel_downsample_q16(
                pts, jcfg.wire_voxel, jcfg.downsample_capacity)
        else:
            q = np.zeros((jcfg.raw_capacity, 3), np.int16)
            q[:len(pts)], scale, center = native.quantize_q16(pts)
        _assert_dequantized(got, want, q, scale, center)
    else:
        np.testing.assert_array_equal(got.points.numpy(),
                                      np.asarray(want.points))
        np.testing.assert_array_equal(got.mask.numpy(),
                                      np.asarray(want.mask))


def test_wire_batch_matches_jax():
    """Four clouds (one empty) prepared as one batch: each frame's
    dequantized view as JAX's, and as the same cloud prepared alone."""
    jcfg = small_config(wire_voxel=0.08, quantized_upload=True)
    cfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    batch = [_cloud(6000, 9 + i, 8.0) for i in range(3)]
    batch.append(np.zeros((0, 3), np.float32))
    got = sequence.wire_batch(cfg, batch, device="cpu")
    want = jsequence.wire_batch(jcfg, batch)
    for pts, g, w in zip(batch, got, want):
        assert g.pre_voxelized and w.pre_voxelized
        q, scale, center, _ = native.voxel_downsample_q16(
            pts, jcfg.wire_voxel, jcfg.downsample_capacity)
        _assert_dequantized(g, w, q, scale, center)
        alone = sequence.wire_cloud(cfg, pts, device="cpu")
        np.testing.assert_array_equal(g.points.numpy(),
                                      alone.points.numpy())
    with pytest.raises(ValueError, match="quantized"):
        sequence.wire_batch(convert.config_from_dict(
            dataclasses.asdict(small_config(wire_voxel=0.08))), batch,
            device="cpu")


def test_wire_helpers_default_to_the_card():
    """wire_cloud and wire_batch put their clouds on the card unless the
    caller asks for the CPU; without a card they raise instead of falling
    back."""
    import inspect

    for fn in (sequence.wire_cloud, sequence.wire_batch):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a card is present: the defaults would run there")
    cfg = convert.config_from_dict(dataclasses.asdict(
        small_config(wire_voxel=0.08, quantized_upload=True)))
    pts = _cloud(2000, 3, 8.0)
    with pytest.raises(RuntimeError, match="CUDA"):
        sequence.wire_cloud(cfg, pts)
    with pytest.raises(RuntimeError, match="CUDA"):
        sequence.wire_batch(cfg, [pts])
