"""The port's `register` CLI and PCD IO against the JAX package (CPU)."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from aicp_mapping_tpu import cli as jcli
from aicp_mapping_tpu.io import pcd as jpcd
from aicp_mapping_tpu.tools.synthetic import room_cloud
from aicp_mapping_tpu_torch import cli
from aicp_mapping_tpu_torch.io import pcd

torch.set_num_threads(1)
ROOT = os.path.join(os.path.dirname(__file__), "..")
CLF = os.path.join(ROOT, "data", "classification", "risk_classifier.npz")
# tolerances of the comparison with JAX's `register` (%, %, 0-100,
# probability, m, m): the golden file's, Hausdorff like a translation
TOL = {"overlap_percent": 2.0, "fov_overlap": 2.0, "alignability": 5.0,
       "risk": 0.1, "hausdorff": 0.02}


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """A seeded room scanned twice: the reading moved by a known small
    motion, both written by the port's write_pcd with their viewpoints."""
    d = tmp_path_factory.mktemp("pair")
    ref = room_cloud(n=3600, size=10.0, seed=3, noise=0.01)[:3000]
    c, s = np.cos(0.03), np.sin(0.03)
    R = np.float32([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    read = (ref @ R.T + np.float32([0.12, -0.08, 0.02])).astype(np.float32)
    vp_ref = (0.5, -0.3, 1.2, 1.0, 0.0, 0.0, 0.0)
    vp_read = (0.6, -0.4, 1.2, np.cos(0.015), 0.0, 0.0, np.sin(0.015))
    paths = str(d / "read.pcd"), str(d / "ref.pcd")
    pcd.write_pcd(paths[0], read, viewpoint=vp_read)
    pcd.write_pcd(paths[1], ref, viewpoint=vp_ref, binary="compressed")
    return paths


def _run(main, argv, capsys):
    assert main(argv) == 0
    return json.loads(capsys.readouterr().out)


def test_register_matches_jax(pair, capsys, tmp_path):
    argv = [*pair, "--classifier", CLF]
    want = _run(jcli.main, ["register", *argv], capsys)
    out = str(tmp_path / "aligned.pcd")
    got = _run(cli.main, ["register", *argv, "--device", "cpu", "-o", out],
               capsys)
    assert got.keys() == want.keys()
    for k, tol in TOL.items():
        assert abs(got[k] - want[k]) <= tol, (k, got[k], want[k])
    np.testing.assert_allclose(np.asarray(got["correction"])[:3, 3],
                               np.asarray(want["correction"])[:3, 3],
                               atol=0.02)
    assert got["trim_ratio"] == pytest.approx(want["trim_ratio"], abs=0.02)
    assert got["risk"] >= 0.0 and got["hausdorff"] > 0.0
    # the aligned reading lands on the reference
    aligned, _ = pcd.read_cloud(out)
    ref, _ = pcd.read_cloud(pair[1])
    assert len(aligned) == 3000
    assert np.abs(aligned.mean(0) - ref.mean(0)).max() < 0.02


@pytest.mark.parametrize("chain", ["icp_3d_trimmed.yaml",
                                   "besl92_pt2point.yaml"])
def test_register_with_a_named_chain_matches_jax(pair, capsys, chain):
    """Named chains, random sampling included (besl92_pt2point keeps 5 % of
    each cloud by JAX's own draws)."""
    argv = ["register", *pair, "--icp-config",
            os.path.join(ROOT, "configs", "icp", chain)]
    want = _run(jcli.main, argv, capsys)
    got = _run(cli.main, argv + ["--device", "cpu"], capsys)
    assert got["trim_ratio"] == want["trim_ratio"]
    assert got["risk"] == want["risk"] == -1.0
    np.testing.assert_allclose(np.asarray(got["correction"])[:3, 3],
                               np.asarray(want["correction"])[:3, 3],
                               atol=0.02)


def test_register_runs_on_the_card_by_default(pair):
    """`python -m aicp_mapping_tpu_torch register` takes the card unless
    asked for the CPU: without one it fails and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["register", *pair])
    out = subprocess.run([sys.executable, "-m", "aicp_mapping_tpu_torch",
                          "register", *pair], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0 and "hausdorff" not in out.stdout


@pytest.mark.parametrize("binary", [False, True, "compressed"])
def test_pcd_round_trip_matches_jax(tmp_path, binary):
    rng = np.random.default_rng(1)
    pts = rng.normal(size=(500, 3)).astype(np.float32) * 20
    vp = (1.0, 2.0, 3.0, 0.9238795, 0.0, 0.0, 0.3826834)
    mine, theirs = str(tmp_path / "a.pcd"), str(tmp_path / "b.pcd")
    pcd.write_pcd(mine, pts, viewpoint=vp, binary=binary)
    jpcd.write_pcd(theirs, pts, viewpoint=vp, binary=binary)
    assert open(mine, "rb").read() == open(theirs, "rb").read()
    got, got_vp = pcd.read_pcd(mine)
    want, want_vp = jpcd.read_pcd(mine)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_vp, want_vp)
    np.testing.assert_allclose(pcd.viewpoint_to_pose(got_vp),
                               jpcd.viewpoint_to_pose(want_vp), atol=1e-6)


def test_read_cloud_bin(tmp_path):
    raw = np.random.default_rng(2).normal(size=(100, 4)).astype(np.float32)
    raw[7, 1] = np.nan
    path = str(tmp_path / "scan.bin")
    raw.tofile(path)
    pts, vp = pcd.read_cloud(path)
    np.testing.assert_array_equal(pts, np.delete(raw[:, :3], 7, axis=0))
    np.testing.assert_array_equal(vp, [0, 0, 0, 1, 0, 0, 0])
    with pytest.raises(IOError):
        pcd.read_cloud(str(tmp_path / "scan.ply"))
