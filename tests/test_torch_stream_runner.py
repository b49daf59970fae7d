"""The port's SequenceRunner on the pipelined App (CPU): pipelined and
synchronous agree on a nominal sequence, a recorded directory replays
through the prefetcher in the wire format as JAX's does, and the
submission API's contract (window, flush, drain, close, errors raised, no
fallback)."""
import dataclasses

import numpy as np
import pytest
import torch

from aicp_mapping_tpu.pipeline import App as JApp
from aicp_mapping_tpu.pipeline import SequenceRunner as JRunner
from aicp_mapping_tpu.pipeline import synthetic_sequence as jax_sequence
from aicp_mapping_tpu_torch import AlignedCloud, Cloud, convert
from aicp_mapping_tpu_torch.pipeline import (App, SequenceRecorder,
                                             SequenceRunner)
from test_golden import _compare, _result_lines, _small_cfg

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def seq():
    return jax_sequence(n_frames=8, n_points=5000, seed=11)[0]


def _cfg(**kw):
    return convert.config_from_dict(dataclasses.asdict(_small_cfg(**kw)))


def _frame(cfg, item):
    utime, pts, pose = item
    return AlignedCloud.create(utime, Cloud.from_numpy(
        pts, capacity=cfg.raw_capacity), pose)


def test_pipelined_matches_synchronous(seq):
    """On a nominal sequence the speculative reference and the device-chained
    total are exact: depth 4, with and without the finalizer thread, gives
    the synchronous results to 1e-6 (JAX's test_pipelined_matches_
    synchronous)."""
    sync = SequenceRunner(App(_cfg(), device="cpu")).run_clouds(seq)
    for async_finalize in (False, True):
        app = App(_cfg(pipeline_depth=4, async_finalize=async_finalize),
                  device="cpu")
        pipe = SequenceRunner(app, pipelined=True).run_clouds(seq)
        app.close()
        assert len(pipe) == len(sync)
        for a, b in zip(sync, pipe):
            assert (a.utime, a.accepted, a.registered, a.reference_id) == \
                (b.utime, b.accepted, b.registered, b.reference_id)
            np.testing.assert_allclose(a.correction, b.correction,
                                       atol=1e-6, rtol=0)
            np.testing.assert_allclose(a.corrected_pose, b.corrected_pose,
                                       atol=1e-6, rtol=0)
            assert abs(a.octree_overlap - b.octree_overlap) < 1e-4


def test_run_directory_wire_format_matches_jax(tmp_path, seq):
    """A recorded sequence replayed through the prefetcher, the host voxel
    grid and the int16 upload, pipelined: frame by frame JAX's replay of
    the same directory, and within 3 cm of the raw path (JAX's
    test_wire_format_directory_replay)."""
    rec = SequenceRecorder(str(tmp_path))
    for utime, pts, pose in seq[:5]:
        rec.record(utime, pts, pose)
    kw = dict(quantized_upload=True, wire_voxel=0.08, pipeline_depth=3)
    want = JRunner(JApp(_small_cfg(**kw)), pipelined=True).run_directory(
        str(tmp_path))
    app = App(_cfg(**kw), device="cpu")
    got = SequenceRunner(app, pipelined=True).run_directory(str(tmp_path))
    _compare(_result_lines(got), _result_lines(want), "wire directory")
    raw = SequenceRunner(App(_cfg(), device="cpu")).run_directory(
        str(tmp_path))
    assert len(raw) == len(got) == 5
    for a, b in zip(raw, got):
        assert a.accepted == b.accepted
        np.testing.assert_allclose(a.corrected_pose[:3, 3],
                                   b.corrected_pose[:3, 3], atol=0.03)


def test_submission_window_and_flush(seq):
    """Depth 4: the bootstrap returns at once, then nothing until four
    frames are in flight, when the oldest two come back; flush returns the
    rest, in order."""
    cfg = _cfg(pipeline_depth=4)
    app = App(cfg, device="cpu")
    out = [app.submit_cloud(_frame(cfg, it)) for it in seq[:6]]
    assert [len(o) for o in out] == [1, 0, 0, 0, 2, 0]
    rest = app.flush()
    assert [r.utime for r in rest] == [it[0] for it in seq[3:6]]
    assert app.flush() == [] and app._pending == []
    assert [r.reading_id for r in app.frames] == list(range(6))


def test_async_finalize_drain_and_close(seq):
    cfg = _cfg(pipeline_depth=2, async_finalize=True)
    app = App(cfg, device="cpu")
    got = []
    for it in seq[:5]:
        got += app.submit_cloud(_frame(cfg, it))
    got += app.flush()
    got += app.drain_results()
    assert [r.utime for r in got] == [it[0] for it in seq[:5]]
    thread = app._fin_thread
    app.close()
    app.close()
    assert not thread.is_alive()


def test_finalizer_errors_are_raised(seq, monkeypatch):
    """A failing finalize raises at the next flush (async) or at once
    (synchronous); nothing falls back."""
    for async_finalize in (True, False):
        cfg = _cfg(pipeline_depth=1, async_finalize=async_finalize)
        app = App(cfg, device="cpu")
        app.submit_cloud(_frame(cfg, seq[0]))

        def broken(pending, host):
            raise ValueError("broken finalize")

        monkeypatch.setattr(app, "_finalize", broken)
        with pytest.raises((RuntimeError, ValueError)) as err:
            app.submit_cloud(_frame(cfg, seq[1]))
            app.flush()
        assert "finalize" in str(err.value)
        monkeypatch.undo()
        app.close()


def test_failed_preparation_fails_the_run(seq):
    """A cloud the wire preparation cannot take raises from run_clouds."""
    bad = [seq[0], (seq[1][0], np.zeros((7, 2), np.float32), seq[1][2])]
    for kw in ({}, dict(quantized_upload=True, wire_voxel=0.08)):
        runner = SequenceRunner(App(_cfg(**kw), device="cpu"),
                                pipelined=True)
        with pytest.raises(ValueError):
            runner.run_clouds(bad, batch_h2d=2)


def test_counters_survive_threads():
    """The launch and propagation counters, bumped from more threads than
    cores with a short switch interval, lose no update (an App's dispatch
    and finalizer threads both launch kernels)."""
    import sys
    import threading

    from aicp_mapping_tpu_torch import _kernels
    from aicp_mapping_tpu_torch.ops import segmentation

    _kernels.reset_launch_counts()
    segmentation.reset_propagation_rounds()
    n_threads, n = 16, 2000

    def bump():
        for _ in range(n):
            _kernels.count_launch("nn_payload")
            segmentation._count_propagation("rounds")

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=bump) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert _kernels.launch_counts()["nn_payload"] == n_threads * n
    assert segmentation.propagation_rounds()["rounds"] == n_threads * n
    _kernels.reset_launch_counts()
    segmentation.reset_propagation_rounds()
