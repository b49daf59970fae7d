"""The readers of ICP's replays (`metrics/icp_replays.online.py`,
`icp_replays.replay.py`): a traced run of each tiny cell on the CPU with
ICP's graph path standing in (`capture_plan` as on the card, a stand-in
graph whose replay runs the step) reports the `aicp.icp.replay` spans a
frame, one per ICP iteration of the traced frames; the same run on the
eager loop, as a program without the graph path, reports 0; without a
trace or a tracer the readers return None."""
from __future__ import annotations

import os
import types

import pytest

from conftest import REPO
from portbench import harness, spec
from portbench.metrics import _program

BENCH = spec.load_bench(REPO)
CELLS = ("bench60k.online", "bench60k.replay")
READERS = {m["name"]: m for m in BENCH["per_layer"]
           if m["name"].startswith("icp_replays.")}


def test_each_reader_is_declared_for_its_cell():
    assert sorted(READERS) == ["icp_replays.online", "icp_replays.replay"]
    for name, m in READERS.items():
        assert m["source"] == "program_counter" and m["layer"] == "icp"
        assert m["workloads"] == ["bench60k." + name.rsplit(".", 1)[1]]
        assert m["moves"] == ("frame_ms" if name.endswith("online")
                              else "scans_per_s")


def _graph_path(mp, icp) -> None:
    """ICP's graph path on the CPU: the plain matcher standing for K1, a
    stand-in graph whose replay runs the captured step."""
    real = icp.capture_plan

    def as_on_the_card(config, plan, device, mesh=None):
        kernel = dict(plan, nn="kernel") if plan["nn"] == "plain" else plan
        return real(config, kernel, "cuda", mesh)

    def capture(self):
        self.graph = types.SimpleNamespace(replay=self.body)

    mp.setattr(icp, "capture_plan", as_on_the_card)
    mp.setattr(icp._Replay, "capture", capture)
    mp.setattr(icp, "_graphs", type(icp._graphs)())


@pytest.fixture(scope="module")
def traced(tiny):
    """(line, run) of each cell on each path, each in a fresh ring."""
    from aicp_mapping_tpu_torch.registration import icp
    from aicp_mapping_tpu_torch.utils import timing

    out = {}
    for graph in (False, True):
        for cell in CELLS:
            c = spec.load_cell(tiny, cell, os.path.join(tiny, "portbench"))
            runs = []
            load = spec.load_reader

            def keeping(name, pkg=None):
                read = load(name, pkg)

                def run_it(run):
                    runs.append(run)
                    return read(run)
                return run_it

            timing.reset()
            with pytest.MonkeyPatch.context() as mp:
                if graph:
                    _graph_path(mp, icp)
                mp.setattr(spec, "load_reader", keeping)
                line = harness.run_cell(c, 3000000021, 1.0, True,
                                        device="cpu", log=lambda m: None)
            out[graph, cell] = (line, runs[0])
    return out


@pytest.mark.parametrize("cell", CELLS)
def test_a_replay_an_iteration_on_the_graph_path(traced, cell):
    line, run = traced[True, cell]
    assert line["correct"], line["check"]
    name = "icp_replays." + cell.split(".")[1]
    got = line["metrics"][name]["value"]
    iters = [run.results[k].n_iterations for k in run.traced]
    assert got > 0
    assert got == pytest.approx(sum(iters) / len(iters), abs=1e-9)


@pytest.mark.parametrize("cell", CELLS)
def test_zero_on_the_eager_loop(traced, cell):
    line, _ = traced[False, cell]
    assert line["correct"], line["check"]
    assert line["metrics"]["icp_replays." + cell.split(".")[1]]["value"] \
        == 0.0


@pytest.mark.parametrize("name", sorted(READERS))
def test_every_reader_is_silent_without_a_trace(name, traced, monkeypatch):
    read = spec.load_reader(name)
    run = traced[True, READERS[name]["workloads"][0]][1]
    assert read(harness.Run(run.cell)) is None
    monkeypatch.setattr(_program, "ring", lambda: None)
    assert read(run) is None
