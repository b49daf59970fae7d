"""ICP's captured iteration (`registration.icp.capture_plan`, `_Replay`,
`_replayed`) on the CPU: which operating points take the graph, a step with
no host read, the graph path's host loop against the eager loop bit for
bit (a stand-in graph whose replay runs the step), its reads, and a
singular system raising as `torch.linalg.solve` does. The capture itself
runs only on the card (chip_smoke.py's ICP graph phase)."""
import collections
import dataclasses
import types

import pytest
import torch

from aicp_mapping_tpu_torch.geometry import se3
from aicp_mapping_tpu_torch.ops.normals import estimate_normals
from aicp_mapping_tpu_torch.registration import icp
from aicp_mapping_tpu_torch.tools.synthetic import room_cloud
from aicp_mapping_tpu_torch.utils import timing

torch.set_num_threads(1)

BENCH = icp.ICPConfig(coarse_iterations=6, coarse_decimation=8)
HOST_READS = (torch.Tensor.item, torch.Tensor.__bool__,
              torch.Tensor.__float__, torch.Tensor.__int__,
              torch.Tensor.tolist, torch.Tensor.cpu, torch.Tensor.numpy)


# Host-to-device copies, which a capture refuses from pageable memory: a
# tensor made from Python data, a Python number written into a tensor.
HOST_COPIES = (torch.tensor, torch.as_tensor)


class NoHostRead(torch.overrides.TorchFunctionMode):
    """Fails on every way a tensor reaches the host, and on the copies from
    the host that a CUDA graph's capture refuses."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in HOST_READS:
            raise AssertionError(f"host read: {func.__name__}")
        if func in HOST_COPIES or (func is torch.Tensor.__setitem__
                                   and not isinstance(args[2], torch.Tensor)):
            raise AssertionError(f"host copy: {func.__name__}")
        return func(*args, **(kwargs or {}))


def _scene(n: int, n_ref: int, seed: int):
    """A room reference with normals and a moved, partly masked reading."""
    ref = torch.as_tensor(room_cloud(n=n_ref + n_ref // 5, size=16.0,
                                     seed=seed, noise=0.005)[:n_ref])
    ref_mask = torch.ones(n_ref, dtype=torch.bool)
    ref_mask[-n_ref // 64:] = False
    normals, _, _ = estimate_normals(ref, ref_mask, k=12)
    scan = torch.as_tensor(room_cloud(n=n + n // 5, size=16.0, seed=seed + 1,
                                      noise=0.005)[:n])
    T = se3.make_transform(se3.so3_exp(torch.tensor([0.01, -0.01, 0.04])),
                           torch.tensor([0.15, -0.1, 0.02]))
    mask = torch.ones(n, dtype=torch.bool)
    mask[::97] = False
    return (se3.transform_points(T, scan).contiguous(), mask, ref,
            normals.contiguous(), ref_mask)


@pytest.fixture(scope="module")
def bench_scene():
    """The bench point's shapes: 8,192 x 8,192, coarse at 1,024."""
    return _scene(8192, 8192, 41)


@pytest.fixture(scope="module")
def small_scene():
    return _scene(2048, 2048, 43)


def test_capture_plan_pins_each_point():
    """The graph where K1 serves a single-device, non-degeneracy-aware
    solve on CUDA; the eager loop on the CPU, under the banded matcher, on
    a mesh and degeneracy-aware."""
    single = dataclasses.replace(BENCH, coarse_iterations=0)
    for M in (8192, 1024):
        plan = icp.solver_plan(BENCH, M, 8192, "cuda")
        assert plan["nn"] == "kernel"
        assert icp.capture_plan(single, plan, "cuda", None)
        assert icp.capture_plan(single, plan, torch.device("cuda:0"))
        assert not icp.capture_plan(
            single, icp.solver_plan(BENCH, M, 8192, "cpu"), "cpu", None)
    banded = icp.solver_plan(BENCH, 8192, 32768, "cuda")
    assert banded["nn"] == "banded"
    assert not icp.capture_plan(single, banded, "cuda", None)
    plan = icp.solver_plan(BENCH, 8192, 8192, "cuda")
    assert not icp.capture_plan(single, plan, "cuda", mesh=object())
    for mode in ("reading", "reference"):
        sharded = dataclasses.replace(single, axis_name="x",
                                      shard_axis_mode=mode)
        assert not icp.capture_plan(sharded, plan, "cuda", object())
    degen = dataclasses.replace(single, degeneracy_threshold=30.0)
    assert not icp.capture_plan(degen, plan, "cuda", None)
    idle = dataclasses.replace(single, max_iterations=0)
    assert not icp.capture_plan(idle, plan, "cuda", None)


def test_the_mode_catches_host_reads():
    t = torch.ones(3)
    for read in (lambda: bool(t[0]), lambda: float(t[0]), lambda: int(t[0]),
                 lambda: t[0].item(), lambda: t.tolist(), lambda: t.cpu(),
                 lambda: t.numpy()):
        with NoHostRead(), pytest.raises(AssertionError, match="host read"):
            read()

    def setitem():
        t[0] = 1.0
    for copy in (setitem, lambda: torch.tensor([1.0]),
                 lambda: torch.as_tensor(1.0)):
        with NoHostRead(), pytest.raises(AssertionError, match="host copy"):
            copy()
    with NoHostRead():
        t[0] = torch.zeros(())
        t[1:].fill_(2.0)


@pytest.mark.parametrize("cfg", [
    dict(),
    dict(error_metric="point_to_point"),
    dict(trim_normal_space=True, max_match_dist=0.5),
], ids=["plane", "point", "normal_space_trim"])
def test_the_captured_step_makes_no_host_read(small_scene, cfg):
    """`_Replay.body`, what the graph holds (the step with the unchecked
    solve and the state's write-back), reads nothing back and copies
    nothing from the host; the state moves."""
    config = icp.ICPConfig(**cfg)
    reading, rmask, ref, normals, ref_mask = small_scene
    p2plane = config.error_metric == "point_to_plane"
    inputs = (reading, rmask, ref, normals if p2plane else None, ref_mask,
              torch.eye(4), torch.tensor(0.7))
    rep = icp._Replay(config, inputs)
    rep.load(inputs)
    with NoHostRead():
        for _ in range(3):
            rep.body()
    assert not torch.equal(rep.T, torch.eye(4))
    assert rep.info.dtype == torch.int32 and rep.status.dtype == torch.int32
    assert int(rep.info) == 0 and int(rep.status) in (0, 1)


@pytest.fixture
def stand_in(monkeypatch):
    """The graph path on the CPU: `capture_plan` as on the card (the plain
    matcher standing for K1), a capture
    that installs a stand-in graph whose replay runs the step, an empty
    cache, each single-phase call's (rows, config, iterations) recorded
    through the module global the phases recurse by, and the spans on."""
    real_plan = icp.capture_plan

    def as_on_the_card(config, plan, device, mesh=None):
        kernel = dict(plan, nn="kernel") if plan["nn"] == "plain" else plan
        return real_plan(config, kernel, "cuda", mesh)

    monkeypatch.setattr(icp, "capture_plan", as_on_the_card)

    def capture(self):
        self.graph = types.SimpleNamespace(replay=self.body)
        icp._count("captures")

    monkeypatch.setattr(icp._Replay, "capture", capture)
    monkeypatch.setattr(icp, "_graphs", collections.OrderedDict())
    calls = []
    solve = icp.point_to_plane_icp

    def recorded(reading_points, *args, **kwargs):
        res = solve(reading_points, *args, **kwargs)
        calls.append((reading_points.shape[0], args[6], res.n_iterations))
        return res

    monkeypatch.setattr(icp, "point_to_plane_icp", recorded)
    icp.reset_graph_counts()
    return calls


def _single_phases(calls, n_ref):
    return [(M, c, it) for M, c, it in calls
            if not icp.solver_plan(c, M, n_ref, "cpu")["coarse"]]


def _same_bits(got, want):
    assert got.n_iterations == want.n_iterations
    for name in ("T", "hessian", "match_dist2", "inlier_mask", "inlier_rms"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(a, b), name


def _reads(calls) -> int:
    """The graph path's reads: one an iteration from the history's length
    on, and one at the end of a run shorter than the history."""
    return sum(max(0, it - c.smooth_length + 1)
               if c.max_iterations >= c.smooth_length else 1
               for _, c, it in calls)


@pytest.mark.parametrize("scene, cfg", [
    ("bench_scene", dict(coarse_iterations=6, coarse_decimation=8)),
    ("small_scene", dict()),
    ("small_scene", dict(error_metric="point_to_point")),
    ("small_scene", dict(trim_normal_space=True)),
    ("small_scene", dict(max_match_dist=0.05)),
    ("small_scene", dict(max_iterations=3)),
    ("small_scene", dict(coarse_iterations=2, coarse_decimation=4,
                         max_iterations=3, smooth_length=3)),
], ids=["coarse_to_fine_8192_1024", "plane", "point", "normal_space_trim",
        "max_match_dist", "short_of_the_history",
        "coarse_to_fine_short_fine"])
def test_the_graph_loop_gives_the_eager_bits(request, stand_in, scene,
                                               cfg):
    """The key's first call runs the eager loop, its second captures and
    replays: the same result bit for bit, one replay an iteration, no
    eager iteration, and the reads `_replayed` documents."""
    reading, rmask, ref, normals, ref_mask = request.getfixturevalue(scene)
    config = icp.ICPConfig(**cfg)
    init_T = se3.make_transform(se3.so3_exp(torch.tensor([0.0, 0.0, 0.01])),
                                torch.tensor([0.02, 0.0, 0.0]))
    args = (reading, rmask, ref, normals, ref_mask, init_T,
            torch.tensor(0.7), config)
    eager = icp.point_to_plane_icp(*args)
    phases = _single_phases(stand_in, ref.shape[0])
    assert icp.graph_counts() == {"captures": 0, "replays": 0,
                                  "eager_iterations": eager.n_iterations}
    assert eager.n_iterations >= 3
    stand_in.clear()
    icp.reset_graph_counts()
    timing.reset()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        replayed = icp.point_to_plane_icp(*args)
    spans = collections.Counter(s.name for s in timing.spans())
    _same_bits(replayed, eager)
    assert _single_phases(stand_in, ref.shape[0]) == phases
    assert icp.graph_counts() == {"captures": len(phases),
                                  "replays": eager.n_iterations,
                                  "eager_iterations": 0}
    assert spans["aicp.icp.replay"] == eager.n_iterations
    assert spans["aicp.icp.sync"] == _reads(phases)
    assert spans["aicp.icp.solve_check"] == 0
    # a third call replays the graphs captured by the second
    again = icp.point_to_plane_icp(*args)
    _same_bits(again, eager)
    assert icp.graph_counts()["captures"] == len(phases)
    # the results are copies, not the graph's buffers
    (rep,) = [r for r in icp._graphs.values()][-1:]
    assert again.T.data_ptr() != rep.T.data_ptr()


def test_a_python_trim_ratio_is_a_float32_ratio(stand_in, small_scene):
    """A float ratio is the number a float32 0-d tensor holds: the same
    bits eagerly and replayed, under one key, captured once."""
    reading, rmask, ref, normals, ref_mask = small_scene
    out = [icp.point_to_plane_icp(reading, rmask, ref, normals, ref_mask,
                                  torch.eye(4), ratio, icp.ICPConfig())
           for ratio in (0.6, torch.tensor(0.6), 0.6, torch.tensor(0.6))]
    for res in out[1:]:
        _same_bits(res, out[0])
    assert len(icp._graphs) == 1
    assert icp.graph_counts()["captures"] == 1
    assert icp.graph_counts()["replays"] == 3 * out[0].n_iterations


def test_the_cache_keeps_the_latest_keys(stand_in, small_scene,
                                         monkeypatch):
    monkeypatch.setattr(icp, "GRAPH_KEYS", 2)
    reading, rmask, ref, normals, ref_mask = small_scene
    for it in (3, 4, 5):
        icp.point_to_plane_icp(reading, rmask, ref, normals, ref_mask,
                               torch.eye(4), 0.7,
                               icp.ICPConfig(max_iterations=it))
    assert [k[0].max_iterations for k in icp._graphs] == [4, 5]


def test_a_singular_solve_raises_as_torch_linalg_solve(stand_in,
                                                     small_scene):
    """One matched point at the origin, point-to-point, with the damping
    cancelling its guard: the normal matrix's rotation block is zero. The
    eager loop (`torch.linalg.solve`) raises at once; the graph path,
    whose key a sound cloud warmed, raises the same error at its read."""
    M = 512
    reading = torch.zeros((M, 3))
    rmask = torch.zeros(M, dtype=torch.bool)
    rmask[0] = True
    # trace(A) = 3 for one inlier: lam = damping * 3 / 6 + 1e-12 = 0
    damping = -2e-12
    lam = damping * torch.tensor(3.0) / 6.0 + 1e-12
    assert float(lam) == 0.0
    config = icp.ICPConfig(error_metric="point_to_point", damping=damping,
                           max_iterations=5)
    singular = (reading, rmask, reading.clone(), reading.clone(),
                rmask.clone(), torch.eye(4), 0.5, config)
    with pytest.raises(torch.linalg.LinAlgError) as eager:
        icp.point_to_plane_icp(*singular)
    assert not icp._graphs                        # a raise warms no key
    sound = tuple(t[:M].contiguous() for t in small_scene)
    icp.point_to_plane_icp(*sound, torch.eye(4), 0.5, config)
    with pytest.raises(torch.linalg.LinAlgError) as graph:
        icp.point_to_plane_icp(*singular)
    assert icp.graph_counts()["captures"] == 1
    assert str(graph.value) == str(eager.value)
    assert "singular" in str(eager.value)
