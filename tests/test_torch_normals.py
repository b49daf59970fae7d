"""Parity of the port's radius moments (plain twins of kernels K2 and K3)
and normals with the JAX package: its XLA moments, its Pallas moments
kernels in interpret mode, and `moments_to_normals`."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aicp_mapping_tpu.ops import banded_nn as jband
from aicp_mapping_tpu.ops import normals as jnorm
from aicp_mapping_tpu_torch import _kernels
from aicp_mapping_tpu_torch.ops import banded_nn, normals

torch.set_num_threads(1)


def _cloud(seed, N, lo=-5.0, hi=5.0):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(lo, hi, (N, 3)).astype(np.float32)
    return pts, rng.uniform(size=N) > 0.1


def _assert_moments_agree(got, want, min_same=0.999):
    """The kernels' contract (tests/test_ops.py banded coverage test):
    neighbour counts agree, and moments match where they do."""
    got, want = np.asarray(got), np.asarray(want)
    diff = np.abs(got[:, 9] - want[:, 9])
    assert (diff <= 2).mean() >= 0.99, diff.max()
    same = diff == 0
    assert same.mean() >= min_same, same.mean()
    np.testing.assert_allclose(got[same], want[same], rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("jax_fn", ["xla", "pallas"])
def test_radius_moments_matches_jax(jax_fn):
    pts, mask = _cloud(5, 1024)
    if jax_fn == "xla":
        want = jnorm._radius_moments_xla(jnp.asarray(pts), jnp.asarray(mask),
                                         0.8)
    else:
        want = jnorm._radius_moments_pallas(pts, mask, 0.8, interpret=True)
    got = normals.radius_moments(torch.as_tensor(pts),
                                 torch.as_tensor(mask), 0.8)
    _assert_moments_agree(got.numpy(), want)


def test_sorted_radius_moments_matches_jax_banded():
    """Banded moments with truncated windows (band 4 of 16 blocks of 128):
    the same windows, hence the same neighbours, as the JAX kernel."""
    pts, mask = _cloud(7, 2048, 0.0, 12.0)
    origin = pts[mask].min(0)
    codes = np.asarray(jband.morton_codes(pts, mask, origin, 2.0))
    order = np.argsort(codes, kind="stable")
    ps, ms, cs = pts[order], mask[order], codes[order]
    want = jnorm.sorted_radius_moments(ps, ms, cs, 0.5, band=4, tm=128,
                                       tn=128, interpret=True)
    got = normals.sorted_radius_moments(
        torch.as_tensor(ps), torch.as_tensor(ms), torch.as_tensor(cs).long(),
        0.5, band=4, tm=128, tn=128)
    _assert_moments_agree(got.numpy(), want)
    full = np.asarray(jnorm._radius_moments_xla(jnp.asarray(ps),
                                                jnp.asarray(ms), 0.5))
    assert (np.asarray(want)[:, 9] < full[:, 9]).any()   # windows truncate


@pytest.mark.parametrize("tn", [32, 256])
def test_radius_moments_banded_matches_jax(tn):
    """`_radius_moments_banded` (Morton sort at 2 m, banded moments, unsort)
    at small tiles, against JAX with its kernels in interpret mode. With
    128 blocks of 32 JAX's `_radius_moments_banded` takes its f32 banded
    kernel (the one K2 replaces past 64 blocks). At 16 blocks of 256 it
    would take the bf16 split kernel, whose counts on the CPU differ from
    its own f32 kernel's by more than 2 for ~1-3% of points (ROADMAP Q3),
    so there the port is held to the f32 kernel on JAX's own sort."""
    pts, mask = _cloud(12, 4096, 0.0, 16.0)
    if tn == 32:
        want = np.asarray(jnorm._radius_moments_banded(
            jnp.asarray(pts), jnp.asarray(mask), 0.8, tm=128, tn=tn,
            interpret=True))
    else:
        codes = jband.morton_codes(jnp.asarray(pts), jnp.asarray(mask),
                                   jnp.asarray(pts[mask].min(0)),
                                   jnp.float32(2.0))
        perm = np.asarray(jnp.argsort(codes))
        want = np.empty((4096, 10), np.float32)
        want[perm] = np.asarray(jnorm.sorted_radius_moments(
            pts[perm], mask[perm], np.asarray(codes)[perm], 0.8, tm=128,
            tn=tn, interpret=True))
    got = normals._radius_moments_banded(torch.as_tensor(pts),
                                         torch.as_tensor(mask), 0.8, tm=128,
                                         tn=tn)
    _assert_moments_agree(got.numpy(), want)
    full = normals.radius_moments(torch.as_tensor(pts),
                                  torch.as_tensor(mask), 0.8).numpy()
    assert (got.numpy()[:, 9] < full[:, 9]).any()        # windows truncate


@pytest.mark.parametrize("viewpoint", [None, (0.0, 0.0, 5.0)],
                         ids=["no_viewpoint", "viewpoint"])
def test_radius_normals_matches_jax(viewpoint):
    """Below 16,384 points both packages take the exhaustive moments."""
    rng = np.random.default_rng(13)
    pts = rng.uniform(-3, 3, (2048, 3)).astype(np.float32)
    pts[:, 2] = 0.02 * rng.normal(size=2048) + 0.3 * pts[:, 0]
    mask = rng.uniform(size=2048) > 0.05
    vp = None if viewpoint is None else np.float32(viewpoint)
    jn, jc, jcnt = (np.asarray(a) for a in jnorm.radius_normals(
        jnp.asarray(pts), jnp.asarray(mask), 0.5,
        None if vp is None else jnp.asarray(vp)))
    tn, tc, tcnt = (a.numpy() for a in normals.radius_normals(
        torch.as_tensor(pts), torch.as_tensor(mask), 0.5,
        None if vp is None else torch.as_tensor(vp)))
    np.testing.assert_array_equal(tcnt, jcnt)
    np.testing.assert_allclose(tc, jc, atol=1e-5)
    if vp is None:                     # unoriented: compare up to sign
        np.testing.assert_allclose(np.abs((tn * jn).sum(1))[mask], 1.0,
                                   atol=1e-4)
    else:
        np.testing.assert_allclose(tn, jn, atol=1e-4)


def test_moments_to_normals_matches_jax():
    rng = np.random.default_rng(9)
    pts = rng.uniform(-3, 3, (1500, 3)).astype(np.float32)
    pts[:, 2] = 0.02 * rng.normal(size=1500) + 0.3 * pts[:, 0]   # a plane
    mask = rng.uniform(size=1500) > 0.05
    vp = np.float32([0.0, 0.0, 5.0])
    M = jnorm._radius_moments_xla(jnp.asarray(pts), jnp.asarray(mask), 0.6)
    jn, jc, jcnt = jnorm.moments_to_normals(M, jnp.asarray(pts),
                                            jnp.asarray(mask),
                                            jnp.asarray(vp))
    tn, tc, tcnt = normals.moments_to_normals(
        torch.as_tensor(np.array(M)), torch.as_tensor(pts),
        torch.as_tensor(mask), torch.as_tensor(vp))
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), atol=1e-4)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5)
    np.testing.assert_array_equal(tcnt.numpy(), np.asarray(jcnt))


def test_eigh3x3_smallest_matches_jax():
    rng = np.random.default_rng(10)
    X = rng.normal(size=(200, 3, 3)).astype(np.float32)
    A = X @ np.swapaxes(X, 1, 2) + np.eye(3, dtype=np.float32) / 10
    je, jv = jnorm._eigh3x3_smallest(jnp.asarray(A))
    te, tv = normals._eigh3x3_smallest(torch.as_tensor(A))
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=1e-4,
                               atol=1e-4)
    dots = np.abs(np.sum(tv.numpy() * np.asarray(jv), axis=-1))
    np.testing.assert_allclose(dots, 1.0, atol=1e-4)


def test_kernel_wrappers_use_plain_twins_on_cpu():
    _kernels.reset_launch_counts()
    pts, mask = _cloud(11, 2048, 0.0, 12.0)
    p, m = torch.as_tensor(pts), torch.as_tensor(mask)
    np.testing.assert_array_equal(
        normals.radius_moments_kernel(p, m, 0.5).numpy(),
        normals.radius_moments(p, m, 0.5).numpy())
    codes = banded_nn.morton_codes(p, m, p[m].amin(0), 2.0)
    cs, perm = torch.sort(codes, stable=True)
    args = (p[perm], cs != banded_nn.SENTINEL, cs, 0.5)
    np.testing.assert_array_equal(
        normals.sorted_radius_moments_kernel(*args, tm=256, tn=256).numpy(),
        normals.sorted_radius_moments(*args, tm=256, tn=256).numpy())
    assert _kernels.launch_counts() == {
        "nn_payload": 0, "banded_moments": 0, "radius_moments": 0,
        "banded_nn_payload_stream": 0}
