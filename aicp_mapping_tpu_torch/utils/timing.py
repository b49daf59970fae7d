"""Per-stage wall-clock timing, port of `aicp_mapping_tpu.utils.timing`.

`TimingUtils` keeps a tic/toc stack of wall-clock starts and the named
durations it has measured. The stack is per thread: the App's finalize
runs on the caller's thread or on the async finalizer's, and each section
opens and closes on one of them. `profiler_trace` wraps `torch.profiler`
where the JAX package wraps `jax.profiler`.
"""
from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict


class TimingUtils:
    def __init__(self, verbose: bool = False):
        self._local = threading.local()
        self._verbose = verbose
        self.records: dict[str, list[float]] = defaultdict(list)

    @property
    def _stack(self) -> list[float]:
        if not hasattr(self._local, "stack"):
            self._local.stack = []
        return self._local.stack

    def tic(self) -> None:
        self._stack.append(time.perf_counter())

    def toc(self, name: str) -> float:
        dt = time.perf_counter() - self._stack.pop()
        self.records[name].append(dt)
        if self._verbose:
            print(f"[Timing] {name}: {dt * 1e3:.2f} ms")
        return dt

    @contextlib.contextmanager
    def section(self, name: str):
        self.tic()
        try:
            yield
        finally:
            self.toc(name)

    def summary(self) -> dict[str, dict[str, float]]:
        out = {}
        for name, vals in self.records.items():
            out[name] = {
                "count": len(vals),
                "mean_ms": 1e3 * sum(vals) / max(len(vals), 1),
                "total_s": sum(vals),
            }
        return out


@contextlib.contextmanager
def profiler_trace(logdir: str):
    """Trace a code region with `torch.profiler` (the host, and the card
    when there is one) and write it into `logdir` as a Chrome trace
    (`*.pt.trace.json`, readable by TensorBoard and Perfetto)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=torch.profiler.tensorboard_trace_handler(
                     logdir)) as prof:
        yield prof
