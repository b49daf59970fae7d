"""The readers of the port's own spans (`metrics/_program.py`): a traced
run of each tiny cell on the CPU reports every one of its program-span
metrics, none negative; the `aicp.app.dispatch` spans in the window are the
traced frames, and the main thread's twins fit the trace's clock; without
a trace, or with a program that has no tracer, every reader returns
None."""
from __future__ import annotations

import os

import pytest

from conftest import REPO
from portbench import harness, spec
from portbench.metrics import _program

BENCH = spec.load_bench(REPO)
PROGRAM = ("wire_host_ms.online", "wire_copy_ms.online", "dispatch_ms.online",
           "finalize_wait_ms.online", "handoff_ms.online",
           "icp_sync_ms.online", "icp_syncs.online", "idle_unspanned.online",
           "dispatch_ms.replay", "lock_wait_ms.replay",
           "prep_wait_ms.replay", "idle_unspanned.replay",
           "step_prefilter_ms.online", "step_overlap_ms.online",
           "step_icp_ms.online")
NEW = {m["name"]: m for m in BENCH["per_layer"] if m["name"] in PROGRAM}


def test_each_program_metric_is_declared_for_its_cell():
    assert sorted(NEW) == sorted(PROGRAM)
    for name, m in NEW.items():
        assert m["source"] in ("program_span", "program_counter")
        assert m["workloads"] == ["bench60k." + name.rsplit(".", 1)[1]]


@pytest.fixture(scope="module")
def traced(tiny):
    """Each cell's result line, the run its readers were handed, its spans
    placed in the window and the twins' fit, each cell in a fresh ring as
    in a process of its own."""
    from aicp_mapping_tpu_torch.utils import timing

    out = {}
    for cell in ("bench60k.online", "bench60k.replay"):
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
        spec.load_reader = keeping
        try:
            line = harness.run_cell(c, 3000000011, 1.0, True,
                                    device="cpu", log=lambda m: None)
        finally:
            spec.load_reader = load
        run = runs[0]
        out[cell] = (line, run, _program.placed(run),
                     _program.fit(_program.twins(run, _program.ring())))
    return out


@pytest.mark.parametrize("cell", ["bench60k.online", "bench60k.replay"])
def test_a_traced_run_reports_every_program_metric(traced, cell):
    line, run, (every, inside, frames), (_, resid) = traced[cell]
    assert line["correct"], line["check"]
    want = {n for n, m in NEW.items() if cell in m["workloads"]}
    assert want and want <= set(line["metrics"])
    for name in want:
        assert line["metrics"][name]["value"] >= 0.0, name
    assert frames == len(run.traced)
    assert {p.name for p in inside} >= {"aicp.app.dispatch",
                                        "aicp.wire.voxel"}
    # the main thread's twins on the trace's clock
    assert resid <= 50.0


@pytest.mark.parametrize("name", sorted(NEW))
def test_every_reader_is_silent_without_a_trace(name, traced,
                                                monkeypatch):
    read = spec.load_reader(name)
    run = traced[NEW[name]["workloads"][0]][1]
    assert read(harness.Run(run.cell)) is None
    monkeypatch.setattr(_program, "ring", lambda: None)
    assert read(run) is None
