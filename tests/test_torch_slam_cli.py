"""The port's `slam` CLI against the JAX package's, and the whole slice with
the region-growing prefilter (CPU). The hough slice, the back-end replay
and a recorded sequence replayed from disk: tests/test_torch_slam.py."""
import json

import numpy as np
import pytest
import torch

from aicp_mapping_tpu import cli as jcli
from aicp_mapping_tpu.io import poses as jposes
from aicp_mapping_tpu.pipeline import App as JApp
from aicp_mapping_tpu.pipeline import SequenceRunner as JRunner
from aicp_mapping_tpu_torch import cli
from aicp_mapping_tpu_torch.pipeline import App, SequenceRunner
from test_mapper import small_config
from test_torch_slam import check_slice, loop_items, port_config

torch.set_num_threads(1)
TOL_ATE = 0.02                     # m
FRAMES = 5


def test_region_growing_slice_matches_jax():
    """App + SequenceRunner + PoseGraphMapper with region growing (one
    exact kNN build shared by kNN normals and label propagation; JAX's is
    approximate), against JAX's run, over the loop's first `FRAMES` frames
    (JAX's region growing takes ~4 s a frame on a CPU)."""
    items = loop_items()[0][:FRAMES]
    japp = JApp(small_config(segmentation_method="region_growing"))
    jresults = JRunner(japp).run_clouds(items)
    app = App(port_config("region_growing"), device="cpu")
    results = SequenceRunner(app).run_clouds(items)
    check_slice(app, results, japp, jresults)


def _run(main, argv, capsys):
    assert main(argv) == 0
    return json.loads(capsys.readouterr().out)


def test_slam_cli_matches_jax(capsys, tmp_path):
    """`slam --synthetic 8 --device cpu` against JAX's `slam --synthetic
    8` (closures between keyframes one apart, at 10 % overlap): the same
    frames, keyframes and closure count, ATE before and after
    the back-end within 2 cm; the map and the KITTI poses are written;
    with `--mesh-devices 2` the same summary and keyframe poses."""
    argv = ["slam", "--synthetic", "8", "--min-keyframe-gap", "1",
            "--min-loop-overlap", "10"]
    want = _run(jcli.main, argv, capsys)
    out_map, out_poses = str(tmp_path / "map.pcd"), str(tmp_path / "kf.txt")
    got = _run(cli.main, argv + ["--device", "cpu", "--output-map", out_map,
                                 "--output-poses", out_poses], capsys)
    assert got.keys() == want.keys()
    for k in ("frames", "accepted", "keyframes"):
        assert got[k] == want[k], k
    assert len(got["loop_closures"]) == len(want["loop_closures"]) >= 1
    for k in ("ate_pre_m", "ate_post_m"):
        assert abs(got[k] - want[k]) <= TOL_ATE, (k, got[k], want[k])
    assert len(jposes.read_kitti_poses(out_poses)) == got["keyframes"]
    # the back-end edge-sharded over two gloo ranks: rank 0 runs the
    # command, the summary carries the mesh; the same keyframe poses
    meshed = str(tmp_path / "kf2.txt")
    got2 = _run(cli.main, argv + ["--device", "cpu", "--mesh-devices", "2",
                                  "--output-poses", meshed], capsys)
    assert got2.pop("mesh_devices") == 2 and got2.pop("backend") == "gloo"
    assert got2 == got
    np.testing.assert_allclose(jposes.read_kitti_poses(meshed),
                               jposes.read_kitti_poses(out_poses),
                               rtol=1e-3, atol=1e-4)
    # the pipelined front-end gives the synchronous summary (JAX's
    # pipelined front-end gives its synchronous one on this nominal loop)
    piped = _run(cli.main, argv + ["--device", "cpu", "--pipelined"], capsys)
    for k in ("frames", "accepted", "keyframes"):
        assert piped[k] == want[k], k
    assert len(piped["loop_closures"]) == len(want["loop_closures"])
    for k in ("ate_pre_m", "ate_post_m"):
        assert abs(piped[k] - got[k]) <= 1e-4, (k, piped[k], got[k])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(argv)
