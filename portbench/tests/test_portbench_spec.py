"""The harness finds every cell, configuration and metric by name, and
BENCHMARK.json keeps to the benchmark's contract."""
from __future__ import annotations

import json
import os
import re

import pytest

from conftest import REPO
from portbench import drivers, spec

BENCH = spec.load_bench(REPO)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_loads_by_name(cell):
    c = spec.load_cell(REPO, cell)
    assert c.config["name"] == c.entry["config"]
    # the mix's entry and the configuration's scene are modules by name
    entry = drivers.load_module("entries", c.traffic["entry"])
    assert issubclass(entry.Driver, drivers.Driver) and callable(entry.judge)
    scene = drivers.load_module("scenes", c.config["scene"]["kind"])
    assert callable(scene.make)
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer, "every cell reports a per-layer metric"
    # each per-layer metric's end-to-end metric is one the cell reports
    assert {m["moves"] for m in c.per_layer} <= names


@pytest.mark.parametrize("metric", [m["name"] for m in
                                    BENCH["end_to_end"] + BENCH["per_layer"]])
def test_every_metric_has_a_reader(metric):
    assert callable(spec.load_reader(metric))


def test_configs_are_files_of_their_own():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    for c in BENCH["configs"]:
        with open(os.path.join(REPO, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"]
        assert set(c["reduced"]) == set(cfg["reduced"])
        assert c["file"].startswith(BENCH["paths"][0] + "/")


def test_contract_names_and_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and all(NAME.match(k)
                                             for k in c["reduced"])
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(BENCH["workloads"])
    layers = {}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        if "layer" in m:
            layers.setdefault(m["layer"], []).append(m["name"])
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert os.path.getsize(os.path.join(REPO, "BENCHMARK.json")) < 65536


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        spec.load_cell(REPO, "no_such.cell")


def test_a_module_name_is_a_name_not_a_path():
    with pytest.raises(ValueError):
        drivers.load_module("entries", "../run")
