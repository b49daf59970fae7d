"""Finding a cell's pieces by name: `BENCHMARK.json` at the root of the
checkout names the cells, configurations and metrics; each has a file of
its own under `portbench/`, which this module loads.

- a configuration: the `file` its entry in `BENCHMARK.json` names
  (`portbench/configs/<name>.json`);
- a traffic mix: `portbench/traffic/<traffic>.json`, the parameters the
  general driver (`drivers.py`) reads;
- a cell: `portbench/workloads/<cell>.json`, its sample sizes and the
  limits of its correctness check;
- a metric: `portbench/metrics/<name>.py`, whose `read(run)` returns the
  metric's value or None when the run holds nothing to read.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))


@dataclasses.dataclass
class Cell:
    name: str
    root: str
    bench: dict
    entry: dict          # the cell's entry in BENCHMARK.json's workloads
    config: dict         # the configuration file's contents
    traffic: dict
    workload: dict
    end_to_end: list     # BENCHMARK.json metric entries this cell reports
    per_layer: list

    @property
    def chips(self) -> int:
        return int(self.entry["chips"])


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_bench(root: str) -> dict:
    return _json(os.path.join(root, "BENCHMARK.json"))


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(root: str, name: str, pkg: str | None = None) -> Cell:
    """The cell `name` of the checkout at `root`; `pkg` is the folder of
    the benchmark's data files (default: this package's folder)."""
    pkg = pkg or HERE
    bench = load_bench(root)
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json "
                       f"(cells: {', '.join(entries)})")
    entry = entries[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _json(os.path.join(root, configs[entry["config"]]["file"]))
    traffic = _json(os.path.join(pkg, "traffic", entry["traffic"] + ".json"))
    workload = _json(os.path.join(pkg, "workloads", name + ".json"))
    for key in ("config", "traffic"):
        if workload[key] != entry[key]:
            raise ValueError(f"workloads/{name}.json names {key} "
                             f"{workload[key]!r}, BENCHMARK.json "
                             f"{entry[key]!r}")
    return Cell(name, root, bench, entry, config, traffic, workload,
                [m for m in bench["end_to_end"] if _applies(m, name)],
                [m for m in bench["per_layer"] if _applies(m, name)])


def load_reader(name: str, pkg: str | None = None):
    """The `read(run)` of metric `name` (its file may hold dots)."""
    path = os.path.join(pkg or HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
