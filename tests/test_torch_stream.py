"""The port's pipelined App (`submit_cloud` / `flush`, async finalize)
against the JAX package's pipelined App on the CPU, frame by frame, to the
golden tolerances with `accepted`, `registered` and `reference_id` equal.

Both run the same numpy clouds. Under pipelining a rejection is seen when
its frame is finalized, so the frames dispatched in between register
against the reference the rejected frame adopted; `test_rejection_inside_
the_window` holds the port to JAX's results there at each depth. With
async finalize, when a finalize lands relative to later dispatches is up
to the threads (in JAX as in the port), so a rejection inside the window
would make the results depend on timing: the async cases run the nominal
sequence, whose results do not."""
import dataclasses

import numpy as np
import pytest
import torch

from aicp_mapping_tpu.pipeline import App as JApp
from aicp_mapping_tpu.pipeline import SequenceRunner as JRunner
from aicp_mapping_tpu.pipeline import synthetic_sequence as jax_sequence
from aicp_mapping_tpu_torch import convert
from aicp_mapping_tpu_torch.pipeline import App, SequenceRunner
from test_golden import _compare, _result_lines, _small_cfg

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def seq():
    """The golden scenario's sequence (tests/test_golden.py)."""
    return jax_sequence(n_frames=8, n_points=5000, seed=11)[0]


def _shifted(items, frame=3, dx=0.25):
    """`items` with one frame's points moved `dx` m: its correction
    (0.300 m in JAX's run; the others' at most 0.091) fails an accept
    gate at 0.14 m."""
    out = list(items)
    utime, pts, pose = out[frame]
    out[frame] = (utime, pts + np.float32([dx, 0.0, 0.0]), pose)
    return out


def run_both(jcfg, items, **run_kw):
    """JAX's and the port's App through their SequenceRunner, pipelined."""
    japp = JApp(jcfg)
    want = JRunner(japp, pipelined=True).run_clouds(items, **run_kw)
    japp.close()
    app = App(convert.config_from_dict(dataclasses.asdict(jcfg)),
              device="cpu")
    try:
        got = SequenceRunner(app, pipelined=True).run_clouds(items, **run_kw)
    finally:
        app.close()
    return app, got, japp, want


def _same_state(app, japp):
    assert app.updates_counter == japp.updates_counter
    assert app.graph.n_clouds == japp.graph.n_clouds
    assert app.graph.current_reference_id == japp.graph.current_reference_id
    np.testing.assert_allclose(app.total_correction, japp.total_correction,
                               atol=0.02)


@pytest.mark.parametrize("async_finalize", [False, True])
@pytest.mark.parametrize("depth", [1, 3, 4])
def test_pipelined_app_matches_jax(seq, depth, async_finalize):
    """The nominal sequence, 6 frames, at each depth with and without the
    finalizer thread."""
    jcfg = _small_cfg(pipeline_depth=depth, async_finalize=async_finalize)
    app, got, japp, want = run_both(jcfg, seq[:6])
    _compare(_result_lines(got), _result_lines(want),
             f"depth {depth} async {async_finalize}")
    assert all(r.accepted for r in got)
    _same_state(app, japp)


@pytest.mark.parametrize("depth", [1, 3, 4])
def test_rejection_inside_the_window(seq, depth):
    """Frame 3 moved 0.25 m and the accept gate at 0.14 m: frame 3 is
    rejected; at depths 3 and 4 the frames dispatched before its finalize
    register against its speculatively adopted reference and are rejected
    too (as JAX's), at depth 1 none is."""
    jcfg = _small_cfg(pipeline_depth=depth, reference_update_frequency=3,
                      max_correction_magnitude=0.14)
    app, got, japp, want = run_both(jcfg, _shifted(seq))
    _compare(_result_lines(got), _result_lines(want), f"depth {depth}")
    rejected = [i for i, r in enumerate(got) if not r.accepted]
    assert rejected == {1: [3], 3: [3, 4, 5], 4: [3, 4, 5, 6]}[depth]
    _same_state(app, japp)


def test_wire_format_pipelined_matches_jax(seq):
    """bench.py's operating point in small: the host voxel grid and int16
    upload, async finalize, depth 4, the clouds prepared in batches of 2
    and uploaded by one copy each."""
    jcfg = _small_cfg(pipeline_depth=4, async_finalize=True,
                      quantized_upload=True, wire_voxel=0.08)
    app, got, japp, want = run_both(jcfg, seq[:6], batch_h2d=2)
    _compare(_result_lines(got), _result_lines(want), "wire")
    _same_state(app, japp)
