"""Fixtures of the benchmark's CPU tests: a tiny copy of the benchmark
(`BENCHMARK.json`, `portbench/` with small capacities, scenes and
segments) that a CPU run finishes in seconds."""
from __future__ import annotations

import json
import os
import shutil
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def _edit(path, fn):
    with open(path) as f:
        d = json.load(f)
    fn(d)
    with open(path, "w") as f:
        json.dump(d, f, indent=1)


def make_tiny(dst: str) -> str:
    """A tiny CPU copy of the benchmark at `dst`; returns `dst`."""
    shutil.copytree(os.path.join(REPO, "portbench"),
                    os.path.join(dst, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), dst)
    cfgs = os.path.join(dst, "portbench", "configs")
    traffic = os.path.join(dst, "portbench", "traffic")

    def bench(d):
        d["pipeline"].update(raw_capacity=8192, downsample_capacity=4096,
                             filtered_capacity=2048, pipeline_depth=8)
        d["icp"].update(coarse_decimation=4)
        d["scene"].update(world_points=6000, world_size=20.0,
                          sensor_range=14.0, step=0.8)

    _edit(os.path.join(cfgs, "bench60k.json"), bench)
    _edit(os.path.join(traffic, "online.json"), lambda d: d.update(
        warmup_frames=2, staged_frames=3, traced_frames=3, max_rate=100))
    _edit(os.path.join(traffic, "replay.json"), lambda d: d.update(
        warmup_frames=10, staged_frames=8, traced_frames=8, max_rate=100,
        batch_h2d=4))
    return dst


@pytest.fixture(scope="session")
def tiny(tmp_path_factory) -> str:
    return make_tiny(str(tmp_path_factory.mktemp("tiny")))
