"""A later change adds a cell, a configuration, a traffic mix, a metric, a
scene kind and an entry as files and BENCHMARK.json entries: the new cell
runs with no edit to any file that was there."""
from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys

from conftest import REPO, make_tiny


def _digests(root):
    out = {}
    for base, _, files in os.walk(os.path.join(root, "portbench")):
        for f in files:
            if "__pycache__" not in base:
                p = os.path.join(base, f)
                out[p] = hashlib.sha256(open(p, "rb").read()).hexdigest()
    return out


def test_a_new_cell_config_mix_and_metric_need_no_edit(tmp_path):
    root = make_tiny(str(tmp_path / "copy"))
    pb = os.path.join(root, "portbench")
    before = _digests(root)
    # a scene kind: the room walked at half the pace
    with open(os.path.join(pb, "scenes", "slow_walk.py"), "w") as f:
        f.write("from portbench.scenes.room_walk import RoomWalk\n\n\n"
                "def make(seed, device=None, **params):\n"
                "    params['step'] /= 2\n"
                "    return RoomWalk(seed, **params)\n")
    # an entry: the closed loop, with each frame's latency kept apart
    with open(os.path.join(pb, "entries", "paced.py"), "w") as f:
        f.write("from portbench.entries import process_cloud\n\n"
                "judge = process_cloud.judge\n\n\n"
                "class Driver(process_cloud.Driver):\n"
                "    def window(self, seconds):\n"
                "        w = super().window(seconds)\n"
                "        self.paced = list(w.latencies)\n"
                "        return w\n")
    # a configuration: the tiny room at a coarser wire grid, walked slowly
    cfg = json.load(open(os.path.join(pb, "configs", "bench60k.json")))
    cfg["name"] = "room_coarse"
    cfg["pipeline"]["wire_voxel"] = 0.12
    cfg["pipeline"]["voxel_size"] = 0.12
    cfg["scene"]["kind"] = "slow_walk"
    json.dump(cfg, open(os.path.join(pb, "configs", "room_coarse.json"),
                        "w"))
    # a traffic mix: a shorter warm-up at the new entry, data only
    json.dump({"entry": "paced", "warmup_frames": 1,
               "max_rate": 100, "staged_frames": 2, "traced_frames": 2},
              open(os.path.join(pb, "traffic", "brisk.json"), "w"))
    json.dump({"config": "room_coarse", "traffic": "brisk",
               "check": {"start_frames": 3, "sample_frames": 4},
               "limits": {"corr_gap_m": 0.01, "gate_mismatch": 0}},
              open(os.path.join(pb, "workloads", "room_coarse.brisk.json"),
                   "w"))
    # a metric: frames handed in during the window
    with open(os.path.join(pb, "metrics", "frames_in.py"), "w") as f:
        f.write("def read(run):\n"
                "    return len(run.window.frames) if run.window else None\n")
    bench = json.load(open(os.path.join(root, "BENCHMARK.json")))
    bench["configs"].append({"name": "room_coarse", "source": "test",
                             "file": "portbench/configs/room_coarse.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "room_coarse.brisk",
                               "config": "room_coarse", "traffic": "brisk",
                               "chips": 1, "why": "test"})
    bench["end_to_end"].append({"name": "frames_in", "unit": "frames",
                                "better": "higher", "bound": 0.25,
                                "source": "host_clock",
                                "workloads": ["room_coarse.brisk"]})
    json.dump(bench, open(os.path.join(root, "BENCHMARK.json"), "w"))
    code = (
        "import json, sys\n"
        f"sys.path[:0] = [{root!r}, {REPO!r}]\n"
        "from portbench import harness, spec\n"
        f"cell = spec.load_cell({root!r}, 'room_coarse.brisk')\n"
        "out = harness.run_cell(cell, 21, 1.0, False, device='cpu', "
        "log=lambda m: None)\n"
        "print(json.dumps(out))\n")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, cwd=root)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"], out["check"]
    assert set(out["metrics"]) == {"setup_s", "frames_in"}
    assert out["metrics"]["frames_in"]["value"] >= 1
    after = _digests(root)
    assert all(after[p] == d for p, d in before.items())
