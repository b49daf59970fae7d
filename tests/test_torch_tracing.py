"""The port's tracer (`utils.timing.span`) on the CPU: off, it records
nothing and opens no `record_function`; under a profiler, golden frames
through the App (synchronous and with the async finalizer) and the
pipelined runner leave the documented spans on the main, finalizer and
wire threads, with their parents and frame numbers; ICP's spans count its
flag reads and its solves' error checks; the main thread's spans have
twins in the exported trace, which a fitted offset places within 50 µs;
results do not change with tracing on."""
import collections
import dataclasses
import json
import statistics

import numpy as np
import pytest
import torch

from aicp_mapping_tpu_torch import App, PipelineConfig
from aicp_mapping_tpu_torch.pipeline import SequenceRunner, fused
from aicp_mapping_tpu_torch.pipeline.sequence import synthetic_sequence
from aicp_mapping_tpu_torch.registration import ICPConfig, icp
from aicp_mapping_tpu_torch.utils import timing

torch.set_num_threads(1)

NAMES = {"aicp.wire.voxel", "aicp.wire.upload", "aicp.runner.prep_wait",
         "aicp.app.lock_wait", "aicp.app.dispatch", "aicp.app.flush",
         "aicp.app.finalize_wait", "aicp.app.finalize",
         "aicp.step.prefilter", "aicp.step.overlap", "aicp.step.icp",
         "aicp.icp.sync", "aicp.icp.solve_check", "aicp.step.risk",
         "aicp.risk.fov", "aicp.risk.align", "aicp.risk.classify",
         "aicp.seg.propagation_read", "aicp.seg.propagation_launch"}
# tests/test_torch_app_viz.py's golden scene, failure prediction on
GOLDEN = dict(raw_capacity=8192, downsample_capacity=4096,
              filtered_capacity=2048, min_cluster_size=20,
              align_ds_capacity=1024, align_max_clusters=8,
              failure_prediction_mode=True)
WIRE = dict(wire_voxel=0.08, quantized_upload=True)
ASYNC = dict(pipeline_depth=2, async_finalize=True)


@pytest.fixture(scope="module")
def items():
    return synthetic_sequence(n_frames=5, n_points=5000, seed=11)[0]


@pytest.fixture(autouse=True)
def fresh_ring():
    timing.reset()
    yield
    timing.reset()


def _run(items, pipelined=False, batch_h2d=0, **kw):
    app = App(PipelineConfig(**GOLDEN, **kw), device="cpu")
    try:
        return SequenceRunner(app, pipelined=pipelined).run_clouds(
            items, batch_h2d=batch_h2d)
    finally:
        app.close()


def _profiled(fn):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


def test_off_span_is_the_shared_noop_and_records_nothing(items,
                                                         monkeypatch):
    opened = []

    def counting(name, *args):
        opened.append(name)
        raise AssertionError("record_function opened with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    assert timing.span("aicp.app.dispatch") is timing.span("x", frame=3)
    with timing.span("x") as s:
        assert s is None
    _run(items[:3])
    _run(items[:3], pipelined=True, batch_h2d=2, **WIRE, **ASYNC)
    assert timing.spans() == [] and opened == []
    assert timing.dropped() == 0


def _by_id(spans):
    return {s.id: s for s in spans}


def test_synchronous_app_spans_parents_and_frames(items):
    _, _ = _profiled(lambda: _run(items[:4]))
    spans = timing.spans()
    assert {s.name for s in spans} <= NAMES
    # the runner prepares each cloud on its wire thread
    assert {s.thread for s in spans if s.name.startswith("aicp.wire.")} \
        == {"aicp-wire_0"}
    assert {s.thread for s in spans
            if not s.name.startswith("aicp.wire.")} == {"MainThread"}
    assert timing.dropped() == 0
    ids = _by_id(spans)
    dispatch = [s for s in spans if s.name == "aicp.app.dispatch"]
    assert [s.frame for s in dispatch] == [0, 1, 2, 3]
    assert all(s.parent is None for s in dispatch)
    for name in ("aicp.step.prefilter", "aicp.step.overlap",
                 "aicp.step.icp"):
        got = [s for s in spans if s.name == name]
        assert [s.frame for s in got] == [1, 2, 3], name
        assert all(ids[s.parent].name == "aicp.app.dispatch" for s in got)
    for name in ("aicp.icp.sync", "aicp.icp.solve_check"):
        got = [s for s in spans if s.name == name]
        assert got and all(ids[s.parent].name == "aicp.step.icp"
                           and s.frame == ids[s.parent].frame
                           for s in got), name
    for name in ("aicp.app.finalize_wait", "aicp.app.finalize"):
        got = [s for s in spans if s.name == name]
        assert [s.frame for s in got] == [1, 2, 3], name
        assert all(ids[s.parent].name == "aicp.app.flush" for s in got)
    for s in spans:
        assert s.start_ns <= s.end_ns
        if s.parent is not None:
            up = ids[s.parent]
            assert up.start_ns <= s.start_ns and s.end_ns <= up.end_ns


def test_async_finalizer_and_runner_threads(items):
    res, _ = _profiled(lambda: _run(items, pipelined=True, batch_h2d=2,
                                    **WIRE, **ASYNC))
    spans = timing.spans()
    assert {s.name for s in spans} <= NAMES
    assert timing.dropped() == 0
    by = collections.defaultdict(list)
    for s in spans:
        by[s.thread, s.name].append(s)
    main = "MainThread"
    assert [s.frame for s in by[main, "aicp.app.dispatch"]] == \
        list(range(len(items)))
    # every frame after the bootstrap finalized on the finalizer thread
    assert sorted(s.frame for s in by["aicp-finalizer",
                                      "aicp.app.finalize"]) == \
        list(range(1, len(items)))
    waits = by["aicp-finalizer", "aicp.app.finalize_wait"]
    assert waits and all(s.parent is None for s in waits)
    assert not by[main, "aicp.app.finalize"]
    # the wire on the runner's thread, one upload a batch of 2, and the
    # main thread's waits on it
    assert len(by["aicp-wire_0", "aicp.wire.voxel"]) == len(items)
    assert len(by["aicp-wire_0", "aicp.wire.upload"]) == 3
    assert len(by[main, "aicp.runner.prep_wait"]) == 3
    assert all(s.frame is None for s in by["aicp-wire_0", "aicp.wire.voxel"])
    assert len(res) == len(items)


def _phases(monkeypatch):
    """Each ICP phase's (smooth_length, n_iterations): the solver calls
    that made no solver call inside."""
    phases = []

    def wrap(fn):
        def run(*args, **kwargs):
            config = kwargs.get("config", args[7] if len(args) > 7
                                else ICPConfig())
            inner = len(phases)
            res = fn(*args, **kwargs)
            if len(phases) == inner:
                phases.append((config.smooth_length, res.n_iterations))
            return res
        return run

    monkeypatch.setattr(icp, "point_to_plane_icp",
                        wrap(icp.point_to_plane_icp))
    monkeypatch.setattr(fused, "point_to_plane_icp",
                        wrap(fused.point_to_plane_icp))
    return phases


@pytest.mark.parametrize("coarse,degen", [(0, 0.0), (3, 0.0), (0, 20.0)],
                         ids=["fine", "coarse", "degeneracy-aware"])
def test_icp_sync_spans_count_the_flag_reads(items, monkeypatch, coarse,
                                             degen):
    """The flag: one read an iteration once the phase's history
    (smooth_length) is full; coarse-to-fine runs two phases, the fine one
    with a history of 2. The error checks: one solve an iteration, and
    degeneracy-aware an eigh besides."""
    phases = _phases(monkeypatch)
    _profiled(lambda: _run(items[:4], icp=ICPConfig(
        coarse_iterations=coarse, coarse_decimation=2,
        degeneracy_threshold=degen)))
    reads = sum(max(0, its - S + 1) for S, its in phases)
    iterations = sum(its for _, its in phases)
    assert len(phases) == 3 * (2 if coarse else 1)
    assert reads > 0
    spans = timing.spans()
    assert sum(s.name == "aicp.icp.sync" for s in spans) == reads
    assert sum(s.name == "aicp.icp.solve_check" for s in spans) == \
        iterations * (2 if degen else 1)


def test_main_thread_twins_in_the_trace(items, tmp_path):
    _, prof = _profiled(lambda: _run(items[:3], pipelined=True,
                                     batch_h2d=2, **WIRE, **ASYNC))
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"
                  and e.get("cat") == "user_annotation"]
    spans = timing.spans()
    twins = [s for s in spans if s.twin]
    assert twins and all(s.thread == "MainThread" for s in twins)
    assert not any(s.twin for s in spans if s.thread != "MainThread")
    assert not any(e["name"] in ("aicp.app.finalize", "aicp.wire.voxel")
                   for e in events), "only the main thread is traced"
    diffs = []
    for name in {s.name for s in twins}:
        ss = sorted((s for s in twins if s.name == name),
                    key=lambda s: s.start_ns)
        ee = sorted((e for e in events if e["name"] == name),
                    key=lambda e: e["ts"])
        assert len(ss) == len(ee), name
        diffs += [e["ts"] - s.start_ns * 1e-3 for s, e in zip(ss, ee)]
    off = statistics.median(diffs)
    resid = sorted(abs(d - off) for d in diffs)
    assert statistics.median(resid) <= 50.0
    assert resid[int(0.9 * (len(resid) - 1))] <= 50.0, resid


def _fields(res):
    return [dataclasses.astuple(r) for r in res]


@pytest.mark.parametrize("kw", [{}, dict(pipelined=True, batch_h2d=2,
                                         **WIRE, **ASYNC)],
                         ids=["sync", "async"])
def test_results_identical_with_tracing_on(items, kw):
    off = _run(items[:4], **kw)
    assert timing.spans() == []
    on, _ = _profiled(lambda: _run(items[:4], **kw))
    assert timing.spans()
    assert len(on) == len(off)
    for a, b in zip(_fields(off), _fields(on)):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
