"""The port's recorded-sequence commands against the JAX package's CLI on
the CPU: `replay` (with `--live-viz` streaming to a viewer), `accumulate`
(the same PCD bytes) and `localize` on one device, over a sequence
recorded by `SequenceRecorder`."""
import json
import socket
import threading
import time

import numpy as np
import pytest
import torch

from aicp_mapping_tpu import cli as jcli
from aicp_mapping_tpu.io import poses as jposes
from aicp_mapping_tpu.pipeline import SequenceRecorder
from aicp_mapping_tpu.pipeline import synthetic_sequence as jax_sequence
from aicp_mapping_tpu_torch import cli
from aicp_mapping_tpu_torch.io.pcd import write_pcd
from aicp_mapping_tpu_torch.utils import live_viz
from test_golden import TOLERANCES

torch.set_num_threads(1)

# tests/test_golden.py's capacities, in the reference's YAML schema
CONFIG = """AICP:
  Pipeline:
    rawCapacity: 8192
    downsampleCapacity: 4096
    filteredCapacity: 2048
    minClusterSize: 20
"""


@pytest.fixture(scope="module")
def recorded(tmp_path_factory):
    """Four frames of the golden sequence recorded, a prior map of their
    points and the small config."""
    root = tmp_path_factory.mktemp("recorded")
    items, _ = jax_sequence(n_frames=4, n_points=5000, seed=11)
    rec = SequenceRecorder(str(root / "seq"))
    for utime, pts, pose in items:
        rec.record(utime, pts, pose)
    write_pcd(str(root / "map.pcd"),
              np.concatenate([p for _, p, _ in items]))
    (root / "aicp.yaml").write_text(CONFIG)
    return root


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _read_types(port: int, out: list) -> None:
    """A viewer of `replay --live-viz PORT`: connects as soon as the
    command listens and keeps each frame's type until it closes."""
    deadline = time.time() + 60
    while True:
        try:
            sock = socket.create_connection(("127.0.0.1", port), timeout=60)
            break
        except OSError:
            if time.time() > deadline:
                raise
            time.sleep(0.002)
    with sock:
        out.extend(h["type"] for h, _ in live_viz.read_frames(sock))


def _run(main, argv, capsys):
    assert main(argv) == 0
    return json.loads(capsys.readouterr().out)


def _poses_agree(a, b):
    pa, pb = jposes.read_kitti_poses(a), jposes.read_kitti_poses(b)
    assert len(pa) == len(pb)
    np.testing.assert_allclose(np.asarray(pa)[:, :3, 3],
                               np.asarray(pb)[:, :3, 3],
                               atol=TOLERANCES["corrected_t"])


def test_replay_matches_jax(recorded, capsys, tmp_path):
    argv = ["replay", str(recorded / "seq"), "--config",
            str(recorded / "aicp.yaml")]
    want = _run(jcli.main, argv + ["--output-poses",
                                   str(tmp_path / "want.txt")], capsys)
    got = _run(cli.main, argv + ["--device", "cpu", "--output-poses",
                                 str(tmp_path / "got.txt")], capsys)
    assert got == want and got["frames"] == 4
    _poses_agree(tmp_path / "got.txt", tmp_path / "want.txt")
    # --live-viz, with a reference update every frame so that a viewer
    # that connects after the bootstrap still sees clouds and maps: the
    # summary of the same replay without it, and the viewer gets the stream
    yaml = tmp_path / "every_frame.yaml"
    yaml.write_text(CONFIG + "    referenceUpdateFrequency: 1\n")
    live_argv = ["replay", str(recorded / "seq"), "--config", str(yaml),
                 "--device", "cpu"]
    port = _free_port()
    got_types = []
    reader = threading.Thread(target=_read_types, args=(port, got_types),
                              daemon=True)
    reader.start()
    live = _run(cli.main, live_argv + ["--live-viz", str(port)], capsys)
    reader.join(timeout=10)
    assert not reader.is_alive()
    assert live == _run(cli.main, live_argv, capsys)
    assert {"cloud", "map", "pose", "metric"} <= set(got_types), got_types
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(argv)


@pytest.mark.parametrize("extra", [[], ["--voxel", "0.1"],
                                   ["--max-scans", "3", "--capacity", "9000",
                                    "--max-range", "12"]])
def test_accumulate_matches_jax(recorded, capsys, tmp_path, extra):
    """The same odom-frame cloud, written as the same PCD bytes."""
    argv = ["accumulate", str(recorded / "seq"), *extra, "-o"]
    want = _run(jcli.main, argv + [str(tmp_path / "want.pcd")], capsys)
    got = _run(cli.main, argv + [str(tmp_path / "got.pcd")], capsys)
    assert (got["scans"], got["points"]) == (want["scans"], want["points"])
    assert (tmp_path / "got.pcd").read_bytes() == \
        (tmp_path / "want.pcd").read_bytes()


def test_localize_matches_jax(recorded, capsys, tmp_path):
    """`localize --mesh-devices 1` against JAX's on a one-device mesh: the
    same frames and map, poses within the golden tolerance; and with the
    map sharded over two ranks."""
    argv = ["localize", str(recorded / "seq"), "--map",
            str(recorded / "map.pcd")]
    want = _run(jcli.main, argv + ["--output-poses",
                                   str(tmp_path / "want.txt")], capsys)
    got = _run(cli.main, argv + ["--device", "cpu", "--mesh-devices", "1",
                                 "--output-poses", str(tmp_path / "got.txt")],
               capsys)
    for key in ("frames", "map_points", "mesh_devices"):
        assert got[key] == want[key], key
    np.testing.assert_allclose(got["final_pose_t"], want["final_pose_t"],
                               atol=TOLERANCES["corrected_t"])
    _poses_agree(tmp_path / "got.txt", tmp_path / "want.txt")
    # the map in two Morton blocks on two gloo ranks (as
    # tests/test_tools.py:365): rank 0 localizes, the summary carries the
    # mesh, the poses stay within the golden tolerance of JAX's
    got2 = _run(cli.main, argv + ["--device", "cpu", "--mesh-devices", "2", "--output-poses",
                                  str(tmp_path / "got2.txt")], capsys)
    assert got2["mesh_devices"] == 2 and got2["backend"] == "gloo"
    for key in ("frames", "map_points"):
        assert got2[key] == want[key], key
    _poses_agree(tmp_path / "got2.txt", tmp_path / "want.txt")
