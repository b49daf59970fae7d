"""The closed loop: one client hands in one cloud at a time and waits for
its result, as AICP's ROS node does.

Each frame is timed from when its scan is handed over to when its
`FrameResult` returns: the upload (the int16 wire with the host voxel
grid) and `App.process_cloud`. The staged
segment times the wire, and the frame step's prefilter and ICP between
device syncs.
"""
from __future__ import annotations

import functools
import time

from portbench import check, drivers

judge = functools.partial(check.judge, pipelined=False)


class Driver(drivers.Driver):
    pipelined = False

    def _upload(self, i: int, staged: bool):
        """Frame i's scan as the App is handed it (an `AlignedCloud`)."""
        from aicp_mapping_tpu_torch.cloud import AlignedCloud
        from aicp_mapping_tpu_torch.pipeline.sequence import wire_cloud

        utime, pts, prior = self.supply[i]
        t0 = time.perf_counter()
        cloud = wire_cloud(self.cfg, pts, device=self.device)
        if staged:
            self.spans["wire_cloud"].append(time.perf_counter() - t0)
        return AlignedCloud.create(utime, cloud, prior)

    def _online(self, idx: list, latencies=None, until=None,
                staged: bool = False, times=None) -> list:
        done = []
        for i in idx:
            if until is not None and time.perf_counter() >= until:
                break
            self._frame = i
            t0 = time.perf_counter()
            with self._span("portbench.upload"):
                cloud = self._upload(i, staged)
            with self._span("portbench.process_cloud"):
                self.app.process_cloud(cloud)
            t1 = time.perf_counter()
            if latencies is not None:
                latencies.append(t1 - t0)
                times.append(t1)
            done.append(i)
        return done

    def _run(self, idx: list, staged: bool = False) -> list:
        return self._online(idx, staged=staged)

    def window(self, seconds: float) -> drivers.Window:
        """Frames offered from the window's start for `seconds`, each
        timed; the window ends with the last result."""
        w = drivers.Window()
        idx = self._take(len(self.supply) - self.next)
        w.start = time.perf_counter()
        times = []
        w.frames = self._online(idx, latencies=w.latencies,
                                until=w.start + seconds, times=times)
        w.end = time.perf_counter()
        w.completed = len(w.frames)
        mid = (w.start + w.end) / 2
        first = sum(1 for t in times if t <= mid)
        if 0 < first < len(times):
            w.halves = ((mid - w.start) * 1e3 / first,
                        (w.end - mid) * 1e3 / (len(times) - first))
        if len(w.frames) == len(idx):
            raise RuntimeError("the closed loop ran out of frames before "
                               "the window ended")
        self.next = w.frames[-1] + 1
        return w

    def staged(self, n: int) -> list:
        """`n` frames with the wire timed, and the frame step's prefilter
        and ICP synchronised and timed."""
        from aicp_mapping_tpu_torch.pipeline import fused

        idx = self._take(n)
        with self._wrapped(fused, "_prefilter", self._synced("_prefilter")), \
                self._wrapped(fused, "point_to_plane_icp",
                              self._synced("point_to_plane_icp")):
            return self._run(idx, staged=True)
