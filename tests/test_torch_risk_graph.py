"""The risk stage as CUDA graphs (`pipeline/risk_graph.py`) and the capture
helper it shares with ICP (`utils/graphs.py`).

On the CPU: each captured piece makes no host read and no host copy (the
label-propagation kernel's place taken by a loop without reads, as the
kernel has none); the graph path's host loop, with a stand-in graph whose
replay runs the piece, gives the eager stage's bits over a dozen frames of
the small ANYmal walk (`tests/test_torch_risk_reference.py`'s), and its
results outlive the next frame's replay; the helper's policy, and its
count of a launch recorded into a capture at each replay; and the
benchmark's reader of the replays (`portbench/metrics/risk_replays.fp.py`)
on traced CPU runs of a tiny `anymal_fp.online`.

On the card (`-m cuda`; this file imports no JAX, so run it with
`python -m pytest --noconftest -m cuda tests/test_torch_risk_graph.py -q`):
the captured stage against the eager stage over 24 frames at the cell's
shapes."""
import collections
import dataclasses
import json
import os
import shutil
import threading
import types

import numpy as np
import pytest
import torch

from aicp_mapping_tpu_torch import _kernels
from aicp_mapping_tpu_torch.classification.classifier import RiskClassifier
from aicp_mapping_tpu_torch.ops import segmentation
from aicp_mapping_tpu_torch.overlap import alignability
from aicp_mapping_tpu_torch.overlap.fov import fov_overlap
from aicp_mapping_tpu_torch.pipeline import fused, risk_graph
from aicp_mapping_tpu_torch.utils import graphs, timing
from portbench import drivers, harness, spec
from portbench import trace as portbench_trace
from portbench.reference.frame import FramePath
from test_torch_icp_graph import NoHostRead

torch.set_num_threads(1)
ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
CLF = os.path.join(ROOT, "data", "classification", "risk_classifier.npz")
CELL = "anymal_fp.online"


def _config(small: bool) -> dict:
    with open(os.path.join(ROOT, "portbench", "configs",
                           "anymal_fp.json")) as f:
        config = json.load(f)
    config["pipeline"].update(classifier_path=CLF)
    if small:
        config["pipeline"].update(
            raw_capacity=8192, downsample_capacity=4096,
            filtered_capacity=2048, align_ds_capacity=1024, pipeline_depth=8)
        config["icp"].update(coarse_decimation=4)
        config["scene"].update(room_points=6000, room_size=10.0,
                               corridor_points=6000, corridor_length=20.0,
                               sensor_range=7.0, start_x=-2.0, leg_frames=40)
    return config


def _walk(config: dict, device, start: int, frames: int):
    """The risk stage's inputs at each step of the walk from `start`: the
    previous frame's prefiltered cloud at its pose as the reference, the
    frame's own at its prior, their overlap; and the classifier."""
    cfg = drivers.pipeline_config(config)
    scene = drivers.make_scene(config, 0, "cpu")
    scene.offset = 0
    path = FramePath(config, device)
    pre = []
    for i in range(start, start + frames + 1):
        _, pts, pose = scene.frame(i)
        pre.append((path.prefilter(pts, pose),
                    torch.as_tensor(pose, device=device)))
    steps = []
    for (ref, ref_pose), (read, pose) in zip(pre, pre[1:]):
        overlap = fused._overlap_percent(cfg, ref.points, ref.mask,
                                         read.points, read.mask)
        steps.append((ref.points, ref.mask, ref_pose, read.points,
                      read.mask, pose, overlap))
    clf = RiskClassifier(device=device)
    clf.load(CLF)
    return cfg, steps, clf.model.to(device)


@pytest.fixture(scope="module")
def small_walk():
    return _walk(_config(small=True), "cpu", 1, 12)


def _read_free_propagation(idx, pull_ok, mask, max_iters=64,
                           jumps_per_iter=6):
    """`propagate_labels` without its convergence read: every round is
    run, and a round after convergence changes nothing."""
    n = mask.shape[0]
    labels = torch.where(mask, torch.arange(n), n)
    for _ in range(max_iters):
        new = torch.minimum(labels,
                            torch.where(pull_ok, labels[idx], n).amin(1))
        for _ in range(jumps_per_iter):
            jumped = new[torch.clamp(new, 0, n - 1)]
            new = torch.where(new < n, torch.minimum(new, jumped), n)
        labels = torch.where(mask, new, n)
    return torch.where(mask, labels, -1)


@pytest.fixture
def stand_in(monkeypatch):
    """The graph path on the CPU: `capture_plan` as on the card, a capture
    that hands back a stand-in graph whose replay runs the piece, an empty
    cache and zeroed counts."""
    monkeypatch.setattr(risk_graph, "capture_plan", lambda device: True)
    monkeypatch.setattr(graphs, "capture", lambda body, device:
                        types.SimpleNamespace(replay=body))
    monkeypatch.setattr(risk_graph, "_graphs", collections.OrderedDict())
    graphs.reset_counts("risk")


def test_each_piece_makes_no_host_read(small_walk, monkeypatch):
    """`_Replay`'s load and its three pieces, what the graphs hold, read
    nothing back and copy nothing from the host; the solves between them
    (eager on the card too) run outside the mode."""
    cfg, steps, model = small_walk
    monkeypatch.setattr(segmentation, "propagate_labels_kernel",
                        _read_free_propagation)
    fused.risk_stage(cfg, *steps[0], model)        # the key's eager call
    rep = risk_graph._Replay(cfg, steps[1], model)
    for inputs in steps[1:3]:
        with NoHostRead():
            rep.load(inputs, model)
        for body, solve in rep.pieces():
            with NoHostRead():
                body()
            if solve is not None:
                solve()
    assert 0.0 <= float(rep.out[2]) <= 1.0
    assert [t.shape for t in rep.out] == [torch.Size([])] * 4
    assert rep.out[3].dtype == torch.bool


def _same_bits(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w), (got, want)


def test_the_graph_path_gives_the_eager_bits(small_walk, stand_in):
    """The key's first call runs the eager stage, its second captures, the
    rest replay: each frame's (fov, alignability, risk, risk_ok) bit for
    bit the eager stage's, three replays a frame, one capture; and each
    frame's results still hold after the next frame's replay."""
    cfg, steps, model = small_walk
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(risk_graph, "capture_plan", lambda device: False)
        eager = [fused.risk_stage(cfg, *s, model) for s in steps]
    assert len({bool(e[3]) for e in eager}) == 2     # gated and not
    graphs.reset_counts("risk")
    timing.reset()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        got = [fused.risk_stage(cfg, *s, model) for s in steps]
    spans = collections.Counter(s.name for s in timing.spans())
    for g, w in zip(got, eager):
        _same_bits(g, w)
    n = len(steps)
    assert graphs.counts("risk") == {"captures": 1, "replays": 3 * (n - 1),
                                     "eager_calls": 1}
    assert spans["aicp.risk.replay"] == 3 * (n - 1)
    assert spans["aicp.risk.align"] == n
    assert spans["aicp.risk.fov"] == spans["aicp.risk.classify"] == 1
    (rep,) = risk_graph._graphs.values()
    assert all(g.data_ptr() != r.data_ptr() for g, r in zip(got[-1],
                                                             rep.out))


def test_without_a_model_and_per_key(small_walk, stand_in):
    """No classifier: risk -1 and the gate open, as eagerly; another
    configuration is another key, warmed by its own first call."""
    cfg, steps, _ = small_walk
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(risk_graph, "capture_plan", lambda device: False)
        eager = [fused.risk_stage(cfg, *s) for s in steps[:3]]
    got = [fused.risk_stage(cfg, *s) for s in steps[:3]]
    for g, w in zip(got, eager):
        _same_bits(g, w)
        assert float(g[2]) == -1.0 and bool(g[3])
    fused.risk_stage(dataclasses.replace(cfg, risk_threshold=0.25),
                     *steps[0])
    assert len(risk_graph._graphs) == 2
    assert graphs.counts("risk")["captures"] == 1


def test_the_policy_eager_first_then_capture(monkeypatch):
    """`lookup` hands back None until `warmed`, then builds the entry once;
    the cache keeps the latest `keys` keys; the thread and the shapes are
    in the key."""
    cache, made = collections.OrderedDict(), []

    def make(k):
        return lambda: made.append(k) or f"graph {k}"

    assert graphs.lookup(cache, "a", make("a"), 2) is None
    graphs.warmed(cache, "a", 2)
    assert graphs.lookup(cache, "a", make("a"), 2) == "graph a"
    assert graphs.lookup(cache, "a", make("a"), 2) == "graph a"
    assert made == ["a"]
    for k in ("b", "c"):
        graphs.warmed(cache, k, 2)
    assert list(cache) == ["b", "c"]
    t = [torch.zeros(3)]
    keys = [graphs.key("cfg", t, "cpu")]
    th = threading.Thread(target=lambda: keys.append(
        graphs.key("cfg", t, "cpu")))
    th.start()
    th.join()
    assert keys[0] != keys[1] and keys[0][:2] == keys[1][:2]
    assert keys[0][4] == (((3,), torch.float32),)
    assert graphs.key("cfg", [torch.zeros(4)], "cpu") != keys[0]
    assert not graphs.capturing("cpu")


def _tiny_fp(dst: str) -> str:
    """A tiny CPU copy of the benchmark with `anymal_fp.online` small."""
    shutil.copytree(os.path.join(ROOT, "portbench"),
                    os.path.join(dst, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dst)
    small = _config(small=True)
    for name, update in (
            (os.path.join("configs", "anymal_fp.json"), None),
            (os.path.join("traffic", "online_fp.json"), dict(
                warmup_frames=2, staged_frames=3, traced_frames=3,
                max_rate=100))):
        path = os.path.join(dst, "portbench", name)
        with open(path) as f:
            d = json.load(f)
        if update is None:
            for key in ("pipeline", "icp", "scene"):
                d[key].update(small[key])
        else:
            d.update(update)
        with open(path, "w") as f:
            json.dump(d, f, indent=1)
    return dst


def _with_device_work(load):
    """`portbench.trace.load` with one device event over the window, as a
    run on the card has."""
    def loaded(path):
        trace = load(path)
        lo, hi = trace.window("portbench.window")
        trace.device.append(portbench_trace.Event("kernel", "stand-in", lo,
                                                  hi - lo, ()))
        return trace
    return loaded


@pytest.mark.parametrize("graph,card", [(True, True), (False, True),
                                        (False, False)],
                         ids=["graph", "eager", "cpu"])
def test_the_replays_reader(tmp_path, monkeypatch, graph, card):
    """A traced CPU run of a tiny `anymal_fp.online`. With device work in
    its trace, as on the card: three replays a frame where the graph path
    stands in, 0 on the eager stage. Without (the CPU, where the stage is
    never captured) the line leaves the metric out."""
    root = _tiny_fp(str(tmp_path))
    if graph:
        monkeypatch.setattr(risk_graph, "capture_plan", lambda device: True)
        monkeypatch.setattr(graphs, "capture", lambda body, device:
                            types.SimpleNamespace(replay=body))
    if card:
        monkeypatch.setattr(portbench_trace, "load",
                            _with_device_work(portbench_trace.load))
    monkeypatch.setattr(risk_graph, "_graphs", collections.OrderedDict())
    timing.reset()
    cell = spec.load_cell(root, CELL, os.path.join(root, "portbench"))
    line = harness.run_cell(cell, 3000000022, 1.0, True, device="cpu",
                            log=lambda m: None)
    assert line["correct"], line["check"]
    if card:
        assert line["metrics"]["risk_replays.fp"]["value"] == (3.0 if graph
                                                                else 0.0)
    else:
        assert "risk_replays.fp" not in line["metrics"]
    assert "risk_align_ms.fp" in line["metrics"]


def test_the_replays_reader_without_the_captured_stage(monkeypatch):
    """In a program without `pipeline/risk_graph.py` the reader returns
    None, before it reads the run: the line leaves the metric out."""
    read = spec.load_reader("risk_replays.fp")
    assert read.__globals__["MODULE"] == risk_graph.__name__
    monkeypatch.setitem(read.__globals__, "MODULE",
                        "aicp_mapping_tpu_torch.pipeline.no_such_stage")
    assert read(None) is None


def test_a_recorded_launch_counts_at_each_replay(monkeypatch):
    """`graphs.counted` inside a capture made by `graphs.capture` adds to
    the graph's tally, and each replay, the first included, counts it;
    outside a capture it counts at once; in another capture, never."""
    seen = []
    graph = graphs.Graph(types.SimpleNamespace(
        replay=lambda: seen.append("replay")))
    monkeypatch.setattr(graphs, "capturing", lambda device: True)
    monkeypatch.setattr(graphs._recording, "tally", graph.tally,
                        raising=False)
    graphs.counted("cuda", seen.append, "launch")
    monkeypatch.setattr(graphs._recording, "tally", None)
    graphs.counted("cuda", seen.append, "foreign")
    assert seen == []
    graph.replay()
    graph.replay()
    assert seen == ["replay", "launch"] * 2
    monkeypatch.setattr(graphs, "capturing", lambda device: False)
    graphs.counted("cpu", seen.append, "now")
    assert seen[-1] == "now"


@pytest.fixture(scope="module")
def card_walk():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA graphs and the "
                    "label-propagation kernel have no CPU mode")
    _kernels.library()
    return _walk(_config(small=False), "cuda", 30, 24)


def _eager_parts(cfg, inputs):
    """The eager stage's labels and diagnostics on the stage's inputs."""
    ref_points, ref_mask, ref_pose, fpts, fmask, read_pose, _ = inputs
    _, a_in_b, b_in_a = fov_overlap(ref_points, ref_mask, ref_pose, fpts,
                                    fmask, read_pose, cfg.sensor_range,
                                    cfg.sensor_angular_view)
    o = risk_graph.align_options(cfg)
    labels = [alignability._segment_cloud(p, m, pose, o).labels
              for p, m, pose in ((ref_points, a_in_b, ref_pose),
                                 (fpts, b_in_a, read_pose))]
    _, diag = alignability.alignability_filter(
        ref_points, a_in_b, ref_pose, fpts, b_in_a, read_pose,
        voxel_size=o.voxel_size, ds_capacity=o.ds_capacity,
        max_clusters=o.max_clusters)
    return labels, diag


@pytest.mark.cuda
def test_the_captured_stage_is_the_eager_stage_on_the_card(card_walk,
                                                           monkeypatch):
    """24 steps of the full-size walk (8,192-point clouds, 4,096 voxels,
    32 clusters): the captured stage's labels, matches, matched points,
    eigenvalues, alignability, risk and gate equal the eager stage's; box
    overlaps, summed with float atomics on the card, differ in at most 1 %
    of their entries; two label-propagation launches a frame and the eager
    stage's rounds, and every launch counted across the capture's frame;
    one capture."""
    cfg, steps, model = card_walk
    monkeypatch.setattr(risk_graph, "_graphs", collections.OrderedDict())
    with monkeypatch.context() as mp:
        mp.setattr(risk_graph, "capture_plan", lambda device: False)
        segmentation.reset_propagation_rounds()
        eager = [fused.risk_stage(cfg, *s, model) for s in steps[2:]]
        rounds = segmentation.propagation_rounds()
        want = [_eager_parts(cfg, s) for s in steps[2:]]
    graphs.reset_counts("risk")
    segmentation.reset_propagation_rounds()
    _kernels.reset_launch_counts()
    for s in steps[:2]:                    # the eager call, the capture
        fused.risk_stage(cfg, *s, model)
    # two launches eagerly; the capture's warm-up, its first replay and the
    # frame's replay two each
    assert _kernels.launch_counts()["label_propagation"] == 8
    assert segmentation.propagation_rounds()["calls"] == 8
    (rep,) = risk_graph._graphs.values()
    segmentation.reset_propagation_rounds()
    _kernels.reset_launch_counts()
    gated = set()
    for s, e, (labels, diag) in zip(steps[2:], eager, want):
        got = fused.risk_stage(cfg, *s, model)
        _same_bits(got, e)
        gated.add(bool(got[3]))
        for p, lab in zip(rep.planes, labels):
            assert torch.equal(p.labels, lab)
        for key in ("matched_a", "n_matched_points"):
            assert torch.equal(rep.diagnostics[key], diag[key]), key
        assert torch.equal(rep.evals, diag["eigvals"])
        assert (rep.diagnostics["box_overlap"]
                != diag["box_overlap"]).float().mean() <= 0.01
    n = len(steps) - 2
    assert _kernels.launch_counts()["label_propagation"] == 2 * n
    assert segmentation.propagation_rounds() == rounds
    assert graphs.counts("risk") == {"captures": 1, "replays": 3 * n + 3,
                                     "eager_calls": 1}
    assert len(risk_graph._graphs) == 1
    assert np.mean([float(e[1]) for e in eager]) > 0
