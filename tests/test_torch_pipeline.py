"""The port's frame step and App against the JAX package (CPU): one fused
frame step on the same inputs, the golden scenario, state carried across
with `convert`, and the port's import and device rules."""
import ast
import dataclasses
import glob
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aicp_mapping_tpu.ops import voxel as jvox
from aicp_mapping_tpu.pipeline import config as jconfig
from aicp_mapping_tpu.pipeline import fused as jfused
from aicp_mapping_tpu.pipeline.app import App as JaxApp
from aicp_mapping_tpu.pipeline.sequence import \
    synthetic_sequence as jax_synthetic_sequence
from aicp_mapping_tpu_torch import (AlignedCloud, App, Cloud,
                                    PipelineConfig, _kernels, convert,
                                    load_yaml_config)
from aicp_mapping_tpu_torch.ops import banded_nn, knn
from aicp_mapping_tpu_torch.pipeline import fused
from aicp_mapping_tpu_torch.pipeline.sequence import synthetic_sequence
from test_golden import TOLERANCES, _compare, _load_golden, _result_lines

torch.set_num_threads(1)
ROOT = os.path.join(os.path.dirname(__file__), "..")


def _golden_cfg(cls, **kw):
    """tests/test_golden.py::_small_cfg for either package."""
    return cls(raw_capacity=8192, downsample_capacity=4096,
               filtered_capacity=2048, min_cluster_size=20,
               failure_prediction_mode=False, **kw)


def _frame(cfg, pts, pose):
    return AlignedCloud.create(0, Cloud.from_numpy(
        pts, capacity=cfg.raw_capacity), pose)


@pytest.fixture(scope="module")
def sequence():
    return synthetic_sequence(n_frames=8, n_points=5000, seed=11)[0]


def test_synthetic_sequence_matches_jax(sequence):
    want, _ = jax_synthetic_sequence(n_frames=8, n_points=5000, seed=11)
    for (tu, tp, tpose), (wu, wp, wpose) in zip(sequence, want):
        assert tu == wu
        np.testing.assert_allclose(tp, wp, atol=2e-5)
        np.testing.assert_allclose(tpose, wpose, atol=1e-6)


@pytest.mark.parametrize("working_mode", ["robot", "debug"])
def test_app_frame_step_matches_jax(sequence, working_mode):
    """One fused frame step (prefilter -> overlap -> auto-tuned ICP ->
    gates -> chaining) on identical inputs, to the golden tolerances."""
    jcfg = _golden_cfg(jconfig.PipelineConfig, working_mode=working_mode)
    tcfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    (_, p0, pose0), (_, p1, pose1) = sequence[0], sequence[1]
    ref = jfused.make_reference_prep(jcfg)(
        *_padded(p0, jcfg.raw_capacity), jnp.asarray(pose0[:3, 3]))
    ref = [np.array(a) for a in ref]
    prev_total = np.asarray(
        jfused.se3.se3_exp(jnp.float32([0.02, -0.01, 0.0, 0.0, 0.0, 0.003])))
    raw = _padded(p1, jcfg.raw_capacity)
    want = jfused.make_app_frame_step(jcfg, False, False)(
        *raw, pose1, prev_total, ref[0], ref[2], ref[1], pose0,
        np.float32(-1.0), np.bool_(False), jnp.zeros(10), jnp.float32(0.0),
        jnp.zeros(2), jnp.ones(2))

    def t(a):
        return torch.as_tensor(np.array(a))

    got = fused.make_app_frame_step(tcfg)(
        t(raw[0]), t(raw[1]), t(pose1), t(prev_total), t(ref[0]), t(ref[2]),
        t(ref[1]), t(pose0), -1.0, False)
    assert bool(got.accepted) == bool(want.accepted)
    assert bool(got.risk_ok) == bool(want.risk_ok)
    assert abs(float(got.overlap_percent) - float(want.overlap_percent)) \
        <= TOLERANCES["octree_overlap"]
    fc_w = int(want.filtered_count)
    assert abs(int(got.filtered_count) - fc_w) <= 0.02 * fc_w
    np.testing.assert_allclose(got.correction.numpy(),
                               np.asarray(want.correction), atol=2e-3)
    np.testing.assert_allclose(got.new_total.numpy(),
                               np.asarray(want.new_total), atol=2e-3)
    assert abs(got.n_iterations - int(want.n_iterations)) <= 1


def _padded(pts, cap):
    out = np.zeros((cap, 3), np.float32)
    out[:len(pts)] = pts
    return out, np.arange(cap) < len(pts)


def test_frame_step_matches_jax(sequence):
    """The benchmark's frame step (no gates) from a given initial guess."""
    jcfg = _golden_cfg(jconfig.PipelineConfig)
    (_, p0, pose0), (_, p1, pose1) = sequence[2], sequence[3]
    ref = [np.array(a) for a in jfused.make_reference_prep(jcfg)(
        *_padded(p0, jcfg.raw_capacity), jnp.asarray(pose0[:3, 3]))]
    raw = _padded(p1, jcfg.raw_capacity)
    init = np.eye(4, dtype=np.float32)
    init[:3, 3] = [0.03, -0.02, 0.0]
    want = jfused.make_frame_step(jcfg)(*raw, pose1[:3, 3], ref[0], ref[2],
                                        ref[1], init)
    tcfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    got = fused.make_frame_step(tcfg)(
        *(torch.as_tensor(np.array(a)) for a in (
            *raw, pose1[:3, 3], ref[0], ref[2], ref[1], init)))
    assert abs(float(got.overlap_percent) - float(want.overlap_percent)) \
        <= TOLERANCES["octree_overlap"]
    np.testing.assert_allclose(got.correction.numpy(),
                               np.asarray(want.correction), atol=2e-3)
    assert float(got.trim_ratio) == pytest.approx(float(want.trim_ratio),
                                                  abs=0.02)


def test_app_matches_golden(sequence):
    """The golden scenario through the port's App on the CPU."""
    cfg = _golden_cfg(PipelineConfig)
    app = App(cfg, device="cpu")
    frames = [app.process_cloud(AlignedCloud.create(
        u, Cloud.from_numpy(p, capacity=cfg.raw_capacity), pose))
        for u, p, pose in sequence]
    _compare(_result_lines(frames), _load_golden()["frames"])


def test_app_prior_map_matches_golden(sequence):
    """tests/test_golden.py::_run_prior_map through the port's App: the
    prior map prefiltered and stored, every frame registered against its
    crop (normals from `radius_normals`) with the overlap pinned at 50; a
    second App seeded halfway with `convert` carries on identically."""
    world = np.concatenate([p for _, p, _ in sequence[:6]])
    cfg = _golden_cfg(PipelineConfig, localize_against_prior_map=True,
                      crop_map_around_base=20.0, map_capacity=16384)
    app = App(cfg)
    app.set_prior_map(Cloud.from_numpy(world, capacity=16384))
    assert app.prior_map.capacity == 16384
    frames = [app.process_cloud(_frame(cfg, p, pose))
              for _, p, pose in sequence[:6]]
    _compare(_result_lines(frames), _load_golden()["prior_map"],
             "prior_map")
    assert all(f.octree_overlap == 50.0 and f.reference_id == -1
               for f in frames)

    a, b = App(cfg), App(cfg)
    a.set_prior_map(Cloud.from_numpy(world, capacity=16384))
    for _, p, pose in sequence[:3]:
        a.process_cloud(_frame(cfg, p, pose))
    convert.app_state_from_numpy(b, **convert.app_state_to_numpy(a))
    ra, rb = (x.process_cloud(_frame(cfg, *sequence[3][1:])) for x in (a, b))
    np.testing.assert_array_equal(ra.corrected_pose, rb.corrected_pose)
    assert (ra.reading_id, ra.reference_id) == (rb.reading_id,
                                                rb.reference_id) == (3, -1)


def test_app_go_back_matches_golden(sequence):
    """tests/test_golden.py::_run_go_back: five mapping frames, then
    go_back_to_map() makes the built map the prior map."""
    cfg = _golden_cfg(PipelineConfig, crop_map_around_base=20.0,
                      map_capacity=16384)
    app = App(cfg)
    frames = []
    for i, (_, p, pose) in enumerate(sequence):
        if i == 5:
            assert len(app.aligned_map_np) == 2048   # the bootstrap cloud
            app.go_back_to_map()
            assert cfg.localize_against_prior_map
        frames.append(app.process_cloud(_frame(cfg, p, pose)))
    _compare(_result_lines(frames), _load_golden()["go_back"], "go_back")


@pytest.mark.parametrize("mode", ["built_map", "loaded_map",
                                  "merged_prior_map"])
def test_built_and_loaded_map_modes_match_jax(sequence, mode):
    """localize_against_built_map crops the accumulated reference clouds;
    load_map_from_file registers the first frame against the prior map
    (exempt from the accept gate, here set tight enough to reject the
    later frames) and then follows the graph; merge_aligned_clouds_to_map
    grows the prior map every reference_update_frequency clouds and
    re-filters it every 30. Both Apps, frame by frame."""
    from aicp_mapping_tpu.cloud import AlignedCloud as JAC
    from aicp_mapping_tpu.cloud import Cloud as JCloud

    items = sequence[:4]
    kw = dict(crop_map_around_base=20.0, map_capacity=16384)
    if mode == "built_map":
        kw.update(localize_against_built_map=True,
                  reference_update_frequency=2)
    elif mode == "loaded_map":
        kw.update(load_map_from_file=True, max_correction_magnitude=0.01)
        items = sequence[1:4]
    else:
        kw.update(localize_against_prior_map=True,
                  merge_aligned_clouds_to_map=True,
                  reference_update_frequency=2)
    jcfg = _golden_cfg(jconfig.PipelineConfig, **kw)
    japp, app = JaxApp(jcfg), App(_golden_cfg(PipelineConfig, **kw))
    if mode != "built_map":
        world = np.concatenate([p for _, p, _ in sequence[:3]])
        japp.set_prior_map(JCloud.from_numpy(world, capacity=16384))
        app.set_prior_map(Cloud.from_numpy(world, capacity=16384))
    want = [japp.process_cloud(JAC.create(0, JCloud.from_numpy(
        p, capacity=jcfg.raw_capacity), pose)) for _, p, pose in items]
    got = [app.process_cloud(_frame(app.cfg, p, pose))
           for _, p, pose in items]
    _compare(_result_lines(got), _result_lines(want), mode)
    assert app.graph.current_reference_id == \
        japp.graph.current_reference_id
    np.testing.assert_allclose(app.aligned_map_np.shape,
                               japp.aligned_map_np.shape)
    if mode == "loaded_map":
        assert got[0].reference_id == -1 and got[0].accepted
        assert not all(g.accepted for g in got[1:])
    if mode == "merged_prior_map":
        n_map = int(app.prior_map.count())
        assert n_map == int(japp.prior_map.count())
        assert app.prior_map.capacity == 16384


def test_set_initial_guess_matches_jax():
    rng = np.random.default_rng(7)
    pose = np.asarray(jfused.se3.se3_exp(jnp.asarray(
        rng.normal(size=6).astype(np.float32))))
    odom = np.asarray(jfused.se3.se3_exp(jnp.asarray(
        rng.normal(size=6).astype(np.float32))))
    japp, app = JaxApp(_golden_cfg(jconfig.PipelineConfig)), App(
        _golden_cfg(PipelineConfig))
    japp.set_initial_guess(pose, odom)
    app.set_initial_guess(pose, odom)
    np.testing.assert_allclose(app.total_correction, japp.total_correction,
                               atol=1e-6)
    np.testing.assert_allclose(app.total_correction @ odom, pose, atol=1e-5)


def test_convert_round_trips(sequence):
    jcfg = _golden_cfg(jconfig.PipelineConfig)
    jcfg.icp = dataclasses.replace(jcfg.icp, coarse_iterations=6,
                                   coarse_decimation=8)
    tcfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert convert.config_from_dict(dataclasses.asdict(tcfg)) == tcfg

    cfg = _golden_cfg(PipelineConfig, reference_update_frequency=2)
    a, b = App(cfg), App(cfg)
    for _, p, pose in sequence[:4]:
        a.process_cloud(_frame(cfg, p, pose))
    convert.app_state_from_numpy(b, **convert.app_state_to_numpy(a))
    sa, sb = convert.app_state_to_numpy(a), convert.app_state_to_numpy(b)
    assert sa.keys() == sb.keys()
    for k in sa:
        np.testing.assert_array_equal(sa[k], sb[k])
    ra, rb = (app.process_cloud(_frame(cfg, *sequence[4][1:]))
              for app in (a, b))
    assert (ra.reference_id, ra.reading_id) == (rb.reference_id,
                                                rb.reading_id)
    np.testing.assert_array_equal(ra.corrected_pose, rb.corrected_pose)


def test_app_seeded_from_jax_app_state(sequence):
    """A port App given the JAX App's state registers the next frame like
    the JAX App does (the per-frame comparison without drift)."""
    jcfg = _golden_cfg(jconfig.PipelineConfig)
    japp = JaxApp(jcfg)
    from aicp_mapping_tpu.cloud import AlignedCloud as JAC
    from aicp_mapping_tpu.cloud import Cloud as JCloud

    def jframe(p, pose):
        return JAC.create(0, JCloud.from_numpy(p, capacity=jcfg.raw_capacity),
                          pose)
    for _, p, pose in sequence[:3]:
        japp.process_cloud(jframe(p, pose))
    app = App(convert.config_from_dict(dataclasses.asdict(jcfg)))
    pts, mask, normals = (np.array(a) for a in japp._ref_device)
    convert.app_state_from_numpy(
        app, pts, mask, normals, japp._ref_pose, japp.total_correction,
        (japp.graph.n_clouds, japp.graph.current_reference_id,
         japp._since_ref_disp))
    _, p, pose = sequence[3]
    want = japp.process_cloud(jframe(p, pose))
    got = app.process_cloud(_frame(app.cfg, p, pose))
    _compare(_result_lines([got]), _result_lines([want]))


@pytest.mark.parametrize("name", ["aicp_config.yaml", "aicp_anymal.yaml",
                                  "aicp_test_config.yaml"])
def test_load_yaml_config_matches_jax(name):
    path = os.path.join(ROOT, "configs", name)
    assert dataclasses.asdict(load_yaml_config(path)) == \
        dataclasses.asdict(jconfig.load_yaml_config(path))


def test_reference_prep_matches_jax(sequence):
    """Voxel downsample + hough prefilter of a reference cloud at the golden
    capacities: the same number of kept points, every one of them a voxel
    centroid of the JAX package's voxelization (within 3e-5 m), with unit
    normals. Which points fill the capacity is not compared: isolated
    points' normals are rounding noise (ROADMAP Q3)."""
    jcfg = _golden_cfg(jconfig.PipelineConfig)
    _, p0, pose0 = sequence[0]
    raw = _padded(p0, jcfg.raw_capacity)
    _, wm, _ = jfused.make_reference_prep(jcfg)(*raw,
                                                jnp.asarray(pose0[:3, 3]))
    tcfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    gp, gm, gn = fused.make_reference_prep(tcfg)(
        *(torch.as_tensor(a) for a in (*raw, pose0[:3, 3])))
    assert int(gm.sum()) == int(np.asarray(wm).sum()) == jcfg.filtered_capacity
    cp, cm = (np.asarray(a) for a in jvox.voxel_downsample(
        *raw, jcfg.voxel_size, jcfg.downsample_capacity))
    dist = (gp[gm][:, None, :] - torch.as_tensor(cp[cm])[None]).abs().amax(
        -1).amin(1)
    assert float(dist.max()) <= 3e-5, float(dist.max())
    np.testing.assert_allclose(torch.linalg.norm(gn[gm], dim=1).numpy(), 1.0,
                               atol=1e-5)


def _imported_roots(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_sources_and_chip_smoke_import_no_jax():
    files = glob.glob(os.path.join(ROOT, "aicp_mapping_tpu_torch", "**",
                                   "*.py"), recursive=True)
    files.append(os.path.join(ROOT, "chip_smoke.py"))
    assert len(files) > 20
    for path in files:
        bad = {"jax", "jaxlib", "aicp_mapping_tpu"} & set(
            _imported_roots(path))
        assert not bad, (path, bad)


def test_chip_smoke_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py would run in full")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout, out.stdout


def test_port_imports_no_jax():
    code = ("import sys; before = set(sys.modules); "
            "import aicp_mapping_tpu_torch, aicp_mapping_tpu_torch.convert; "
            "new = set(sys.modules) - before; "
            "bad = [m for m in new if m.split('.')[0] in "
            "('jax', 'jaxlib', 'aicp_mapping_tpu')]; "
            "assert not bad, bad; print('ok')")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_kernels_never_fall_back(monkeypatch, tmp_path):
    """CPU tensors run the plain twins without launching anything; any other
    device raises; without a toolchain the kernel build raises; and an App
    on a missing card raises instead of running on the CPU."""
    _kernels.reset_launch_counts()
    q = torch.zeros((8, 3))
    m = torch.ones(8, dtype=torch.bool)
    knn.nn_payload_kernel(q, m, q, m, torch.zeros((8, 8)))
    assert _kernels.launch_counts()["nn_payload"] == 0
    meta = q.to("meta")
    with pytest.raises(ValueError, match="no kernel"):
        knn.nn_payload_kernel(meta, m.to("meta"), meta, m.to("meta"),
                              torch.zeros((8, 8), device="meta"))
    with pytest.raises(ValueError, match="contiguous"):
        knn.nn_payload_kernel(q.T.contiguous().T, m, q, m,
                              torch.zeros((8, 8)))
    # the banded kernel K5 likewise
    r = torch.zeros((1024, 3))
    pen = torch.zeros(1024)
    pay = torch.zeros((1024, 8))
    starts = torch.zeros(1, dtype=torch.int32)
    qb = torch.zeros((512, 3))
    fn = banded_nn.nn_payload_banded_stream_kernel
    fn(qb, r, pen, pay, starts, 1)
    with pytest.raises(ValueError, match="no kernel"):
        fn(*(t.to("meta") for t in (qb, r, pen, pay, starts)), 1)
    assert sum(_kernels.launch_counts().values()) == 0
    monkeypatch.setattr(_kernels, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(_kernels, "_lib", None)
    monkeypatch.setattr(_kernels.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc"):
        _kernels.library()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            App(PipelineConfig(), device="cuda")


def test_app_rejects_unported_modes():
    for kw in (dict(failure_prediction_mode=True),
               dict(async_finalize=True), dict(wire_voxel=0.08),
               dict(quantized_upload=True), dict(debug_dir="dumps")):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            App(PipelineConfig(**kw))
    with pytest.raises(NotImplementedError):
        fused.make_app_frame_step(PipelineConfig(), with_risk=True)
