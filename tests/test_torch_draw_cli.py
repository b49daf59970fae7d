"""The port's `draw` and `vtk-to-octree` commands against the JAX
package's `_cmd_draw` / `_cmd_vtk_to_octree` on the same files (CPU), and
the port's `tools/drive_demo.py` flow with JAX's assertions."""
import json
import os

import numpy as np
import pytest
import torch

from aicp_mapping_tpu import cli as jcli
from aicp_mapping_tpu.io import vtk as jvtk
from aicp_mapping_tpu_torch import cli
from aicp_mapping_tpu_torch.io.pcd import read_pcd, write_pcd
from aicp_mapping_tpu_torch.io.vtk import read_vtk, write_vtk
from aicp_mapping_tpu_torch.tools.synthetic import room_cloud

torch.set_num_threads(1)
# tests/test_torch_risk.py's rule for kNN normals: >= 99 % of points within
# 1e-4 of JAX's (here up to sign: `draw` orients no normal), plus the
# 6-digit text of the ASCII VTK file
NORMALS_TOL, NORMALS_SHARE, TEXT_TOL = 1e-4, 0.99, 2e-6


def _run(main, argv, capsys):
    assert main(argv) == 0
    return json.loads(capsys.readouterr().out)


@pytest.fixture(scope="module")
def cloud(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("draw") / "room.pcd")
    write_pcd(path, room_cloud(n=3000, size=8.0, seed=4, noise=0.01))
    return path


@pytest.mark.parametrize("resolution", ["0.2", "0.75"])
def test_draw_octree_matches_jax(cloud, tmp_path, capsys, resolution):
    outs = {}
    for name, main in (("port", cli.main), ("jax", jcli.main)):
        outs[name] = str(tmp_path / f"{name}.vtk")
        outs[name + "_json"] = _run(main, ["draw", cloud, outs[name],
                                           "--resolution", resolution],
                                    capsys)
    assert outs["port_json"] == {**outs["jax_json"], "output": outs["port"]}
    assert open(outs["port"], "rb").read() == open(outs["jax"], "rb").read()


@pytest.mark.parametrize("stride,scale", [("1", "0.2"), ("3", "0.5")])
def test_draw_normals_matches_jax(cloud, tmp_path, capsys, stride, scale):
    outs = {}
    for name, main, extra in (("port", cli.main, ["--device", "cpu"]),
                              ("jax", jcli.main, [])):
        outs[name] = str(tmp_path / f"{name}.vtk")
        info = _run(main, ["draw", cloud, outs[name], "--mode", "normals",
                           "--stride", stride, "--scale", scale] + extra,
                    capsys)
        outs[name + "_segments"] = info["segments"]
    assert outs["port_segments"] == outs["jax_segments"] == \
        -(-3000 // int(stride))
    got = read_vtk(outs["port"]).reshape(-1, 2, 3)
    want = jvtk.read_vtk(outs["jax"]).reshape(-1, 2, 3)
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    d_got, d_want = (s[:, 1] - s[:, 0] for s in (got, want))
    off = np.minimum(np.abs(d_got - d_want).max(1),
                     np.abs(d_got + d_want).max(1))
    share = (off <= float(scale) * NORMALS_TOL + TEXT_TOL).mean()
    assert share >= NORMALS_SHARE, share
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(["draw", cloud, outs["port"], "--mode", "normals"])


@pytest.mark.parametrize("out", ["cells.pcd", "cells.vtk"])
def test_vtk_to_octree_matches_jax(tmp_path, capsys, out):
    """tests/test_tools.py::test_cli_vtk_to_octree's cloud, both output
    formats: the same cells and summary as JAX's command."""
    src = str(tmp_path / "in.vtk")
    write_vtk(src, np.random.default_rng(1).uniform(0, 2.0, (2000, 3))
              .astype(np.float32))
    paths, infos = {}, {}
    for name, main in (("port", cli.main), ("jax", jcli.main)):
        paths[name] = str(tmp_path / f"{name}_{out}")
        infos[name] = _run(main, ["vtk-to-octree", src, paths[name],
                                  "--resolution", "0.5"], capsys)
    assert infos["port"] == {**infos["jax"], "output": paths["port"]}
    assert 30 <= infos["port"]["occupied_cells"] <= 125
    read = read_vtk if out.endswith(".vtk") else (lambda p: read_pcd(p)[0])
    np.testing.assert_array_equal(read(paths["port"]), read(paths["jax"]))
    if out.endswith(".vtk"):
        assert open(paths["port"], "rb").read() == \
            open(paths["jax"], "rb").read()


def test_drive_demo_flow(capsys):
    """The demo's flow on the CPU: a trained classifier, the failure
    prediction path, a RecordingVisualizer, and JAX's two assertions (run
    inside `run`)."""
    from aicp_mapping_tpu_torch.tools import drive_demo

    out = drive_demo.run(device="cpu")
    frames, vis = out["frames"], out["vis"]
    assert len(frames) == 12 and all(f.accepted for f in frames)
    assert out["corr_err"][-1] < out["odom_err"][-1] + 0.01
    assert sorted(vis.metrics) == ["alignability", "alignment_risk",
                                   "fov_overlap", "octree_overlap"]
    assert all(0.0 <= f.risk <= 1.0 for f in frames[1:])
    assert len(vis.maps) >= 1 and len(vis.poses) >= 2
    summary = out["app"].timing.summary()
    assert summary["aicp.app.finalize"]["count"] == 11
    assert "timing:" in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            drive_demo.main([])
