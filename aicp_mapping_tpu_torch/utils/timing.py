"""Per-stage wall-clock timing and the port's tracer, port of
`aicp_mapping_tpu.utils.timing`.

`TimingUtils` keeps a tic/toc stack of wall-clock starts and the named
durations it has measured. The stack is per thread: the App's finalize
runs on the caller's thread or on the async finalizer's, and each section
opens and closes on one of them. Each section is also a span (below).
`profiler_trace` wraps `torch.profiler` where the JAX package wraps
`jax.profiler`.

The tracer. `span(name, frame=None)` is a context manager around a piece
of the program's host work. It is off unless a torch profiler is active in
the process (`torch.autograd.profiler._is_profiler_enabled`, which every
thread sees); off, it costs one flag read and hands back a shared no-op
context. On, each span is kept, when it closes,
in a bounded ring (`spans()`, `reset()`, `dropped()`) as a `Span`: its
name, its thread's name, its start and end by `time.perf_counter_ns`, the
id of the span it opened inside on the same thread, and its frame (the
index in `App.frames` of the frame it works on, where the App knows it;
else its parent's). Where the profiler records the calling thread (it
records host events only on the thread that started it), the span also
opens `torch.profiler.record_function(name)`: that twin names the host's
work in the exported trace, and the twins' starts fit the offset between
`perf_counter` and the trace's clock (`Span.twin`).

The port's spans (PERF.md lists each site and the metric that reads it):
`aicp.wire.voxel`, `aicp.wire.upload` (`pipeline/sequence.py`),
`aicp.runner.prep_wait` (`SequenceRunner`), `aicp.app.lock_wait`,
`aicp.app.dispatch`, `aicp.app.flush`, `aicp.app.finalize_wait`,
`aicp.app.finalize` (`pipeline/app.py`), `aicp.step.prefilter`,
`aicp.step.overlap`, `aicp.step.risk`, `aicp.step.icp`, and inside the
risk stage `aicp.risk.fov`, `aicp.risk.align`, `aicp.risk.classify`
(`pipeline/fused.py`; on the card, from a key's second call, only
`aicp.risk.align`) and `aicp.risk.replay` (`pipeline/risk_graph.py`, one
per replay of a captured piece), `aicp.seg.propagation_read`
(`ops/segmentation.py`, one per host read of label propagation's
convergence flag: the CPU's eager loop) and `aicp.seg.propagation_launch`
(one per launch of the label-propagation kernel on the card outside a
capture),
`aicp.icp.sync` and `aicp.icp.solve_check` (`registration/icp.py`, one per
host read of ICP's convergence flag and of a linear-algebra call's error
flag), and `aicp.icp.replay` (one per replay of ICP's captured iteration).
"""
from __future__ import annotations

import contextlib
import itertools
import threading
import time
from collections import defaultdict, deque
from typing import NamedTuple, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

RING_SPANS = 1 << 16


class Span(NamedTuple):
    id: int
    name: str
    thread: str
    start_ns: int                # time.perf_counter_ns()
    end_ns: int
    parent: Optional[int]        # the enclosing span's id, same thread
    frame: Optional[int]         # index in App.frames
    twin: bool                   # a record_function of the same name


_OFF = contextlib.nullcontext()       # every span while tracing is off


class Tracer:
    """The ring of closed spans and each thread's stack of open ones."""

    def __init__(self, capacity: int = RING_SPANS):
        self._ring: deque = deque(maxlen=capacity)
        self._dropped = 0
        self._lock = threading.Lock()
        self._local = threading.local()
        self._ids = itertools.count(1)

    def local(self):
        """This thread's stack of open spans and its name."""
        local = self._local
        if not hasattr(local, "stack"):
            local.stack, local.name = [], threading.current_thread().name
        return local

    def keep(self, span: Span) -> None:
        with self._lock:
            if len(self._ring) == self._ring.maxlen:
                self._dropped += 1
            self._ring.append(span)

    def spans(self) -> list:
        with self._lock:
            return list(self._ring)

    def dropped(self) -> int:
        return self._dropped

    def reset(self) -> None:
        with self._lock:
            self._ring.clear()
            self._dropped = 0


class _Open:
    """An open span (tracing on)."""

    __slots__ = ("tracer", "name", "frame", "id", "parent", "twin", "start",
                 "local")

    def __init__(self, tracer: Tracer, name: str, frame: Optional[int]):
        self.tracer, self.name, self.frame = tracer, name, frame

    def __enter__(self):
        local = self.tracer.local()
        self.local = local
        up = local.stack[-1] if local.stack else None
        self.parent = up.id if up is not None else None
        if self.frame is None and up is not None:
            self.frame = up.frame
        self.id = next(self.tracer._ids)
        self.twin = None
        if torch._C._autograd._profiler_enabled():
            self.twin = torch.profiler.record_function(self.name)
            self.twin.__enter__()
        local.stack.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        self.local.stack.pop()
        if self.twin is not None:
            self.twin.__exit__(*exc)
        self.tracer.keep(Span(self.id, self.name, self.local.name, self.start,
                              end, self.parent, self.frame,
                              self.twin is not None))
        return False


_TRACER = Tracer()


def span(name: str, frame: Optional[int] = None):
    """A span named `name` around a `with` block (the module's docstring)."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Open(_TRACER, name, frame)


def spans() -> list:
    """The closed spans in the ring, oldest first."""
    return _TRACER.spans()


def dropped() -> int:
    """Spans the ring let go of since the last `reset`."""
    return _TRACER.dropped()


def reset() -> None:
    _TRACER.reset()


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
    def section(self, name: str, frame: Optional[int] = None):
        """Time the block under `name`, and open `span(name, frame)`."""
        with span(name, frame):
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
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=torch.profiler.tensorboard_trace_handler(
                     logdir)) as prof:
        yield prof
