"""The replay: `SequenceRunner(app, pipelined=True).run_clouds(frames,
batch_h2d=...)`, as a replay or mapping host pushes a recorded drive
through: frames in flight up to the configuration's `pipeline_depth`, the
wire prepared on the runner's thread `batch_h2d` clouds to an upload,
results finalized on the App's finalizer thread.

The runner drives the App through its public `submit_cloud`. It is handed
the App behind a thin front (`_Front`) whose `submit_cloud` notes each
dispatch and stops the replay at the window's end by raising there. A
frame counts when its result is in `App.frames`: the window reads its
length at its start and at its end. The staged segment times the
runner's wire batches.
"""
from __future__ import annotations

import functools
import time

from portbench import check, drivers

judge = functools.partial(check.judge, pipelined=True)


class _Front:
    """The App as the runner sees it: every attribute the App's, with
    `submit_cloud` the driver's."""

    def __init__(self, app, submit_cloud):
        self._app, self.submit_cloud = app, submit_cloud

    def __getattr__(self, name):
        return getattr(self._app, name)


class Driver(drivers.Driver):
    pipelined = True

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        from aicp_mapping_tpu_torch.pipeline.sequence import SequenceRunner

        self.runner = SequenceRunner(_Front(self.app, self._submit),
                                     pipelined=True)
        self._idx, self._dispatched = [], []
        self._until = None
        self._closed = None
        self._polls = []

    def _submit(self, cloud):
        """`App.submit_cloud`, once the window is known to be open."""
        if self._until is not None and time.perf_counter() >= self._until:
            self._closed = (time.perf_counter(), len(self.app.frames))
            raise drivers.WindowClosed
        if self._until is not None:
            self._polls.append((time.perf_counter(), len(self.app.frames)))
        self._frame = self._idx[len(self._dispatched)]
        self._dispatched.append(self._frame)
        with self._span("portbench.submit_cloud"):
            return self.app.submit_cloud(cloud)

    def _replay(self, idx: list, until=None) -> list:
        """Dispatch frames `idx` through the runner without a flush; with
        `until`, stop dispatching once that time has passed. Returns the
        frames dispatched."""
        self._idx, self._dispatched, self._until = idx, [], until
        try:
            self.runner.run_clouds([self.supply[i] for i in idx],
                                   batch_h2d=self.traffic["batch_h2d"],
                                   flush=False)
        except drivers.WindowClosed:
            pass
        finally:
            self._until = None
        return self._dispatched

    def _run(self, idx: list, staged: bool = False) -> list:
        return self._replay(idx)

    def window(self, seconds: float) -> drivers.Window:
        """Frames dispatched from the window's start until `seconds` have
        passed; the results recorded in between complete in it."""
        w = drivers.Window()
        idx = self._take(len(self.supply) - self.next)
        w.start = time.perf_counter()
        before = len(self.app.frames)
        w.frames = self._replay(idx, until=w.start + seconds)
        if self._closed is None:
            raise RuntimeError("the replay ran out of frames before the "
                               "window ended")
        w.end, after = self._closed
        w.completed = after - before
        # a diagnostic: the rate in each half, from the dispatch nearest
        # the middle
        mid = (w.start + w.end) / 2
        if self._polls:
            t, n = min(self._polls, key=lambda p: abs(p[0] - mid))
            if before < n < after and w.start < t < w.end:
                w.halves = ((t - w.start) * 1e3 / (n - before),
                            (w.end - t) * 1e3 / (after - n))
        self.finish()
        self.next = w.frames[-1] + 1
        return w

    def staged(self, n: int) -> list:
        """`n` frames with the runner's wire batches timed, per cloud."""
        from aicp_mapping_tpu_torch.pipeline import sequence

        def per_cloud(fn):
            def run(cfg, pts_list, *args, **kwargs):
                t0 = time.perf_counter()
                out = fn(cfg, pts_list, *args, **kwargs)
                dt = (time.perf_counter() - t0) / len(pts_list)
                self.spans["wire_batch_per_cloud"].extend(
                    [dt] * len(pts_list))
                return out
            return run

        idx = self._take(n)
        with self._wrapped(sequence, "wire_batch", per_cloud):
            done = self._run(idx, staged=True)
        self.finish()
        return done
