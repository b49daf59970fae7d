"""Shared by the program-span readers: the port's own spans, read in this
process from its tracer's ring (`aicp_mapping_tpu_torch.utils.timing`),
placed on the device trace's clock, cut to the traced window and counted a
frame.

The tracer records spans while a profiler runs, on every thread; on the
thread that started the profiler each span also opens a `record_function`
of its name (a twin, `Span.twin`), which the exported trace holds. The
offset from `perf_counter` to the trace's clock is the median, over the
main thread's twins paired in order by name, of the twin's start less the
span's. A span is in the window when it starts inside `portbench.window`;
its time is cut at the window's end. The frames are the `aicp.app.dispatch`
spans in the window. Every reader returns None when there is no trace, no
tracer (a program without one), no twin or no frame.
"""
from __future__ import annotations

import collections
import dataclasses
import statistics
import threading

from portbench import stats

MAIN = threading.main_thread().name
FINALIZER = "aicp-finalizer"
DISPATCH = "aicp.app.dispatch"


@dataclasses.dataclass(frozen=True)
class Placed:
    span: object       # the tracer's Span
    ts: float          # µs, the trace's clock
    end: float

    @property
    def name(self) -> str:
        return self.span.name

    @property
    def thread(self) -> str:
        return self.span.thread


def ring():
    """The tracer's closed spans, or None where the program has no tracer."""
    try:
        from aicp_mapping_tpu_torch.utils import timing
    except ImportError:
        return None
    read = getattr(timing, "spans", None)
    return read() if read is not None else None


def twins(run, spans: list) -> list:
    """(span, trace event) pairs of the main thread's twins: per name, the
    last spans and the last annotations, in order, as many as both have."""
    by_name = collections.defaultdict(list)
    for s in spans:
        if s.twin and s.thread == MAIN:
            by_name[s.name].append(s)
    events = collections.defaultdict(list)
    for e in run.trace.host:
        if e.cat == "user_annotation" and e.name in by_name:
            events[e.name].append(e)
    pairs = []
    for name, ss in by_name.items():
        ee = sorted(events[name], key=lambda e: e.ts)
        ss = sorted(ss, key=lambda s: s.start_ns)
        k = min(len(ss), len(ee))
        if k:
            pairs += list(zip(ss[len(ss) - k:], ee[len(ee) - k:]))
    return pairs


def fit(pairs: list) -> tuple:
    """(offset µs, median residual µs) of the twins' starts."""
    diffs = [e.ts - s.start_ns * 1e-3 for s, e in pairs]
    off = statistics.median(diffs)
    return off, statistics.median(abs(d - off) for d in diffs)


def placed(run):
    """(every span on the trace's clock, those in the window, frames), or
    None."""
    if run.trace is None:
        return None
    spans = ring()
    if not spans:
        return None
    pairs = twins(run, spans)
    if not pairs:
        return None
    off, _ = fit(pairs)
    lo, hi = run.trace_window
    every = [Placed(s, s.start_ns * 1e-3 + off, s.end_ns * 1e-3 + off)
             for s in spans]
    inside = [p for p in every if lo <= p.ts < hi]
    frames = sum(1 for p in inside if p.name == DISPATCH)
    if not frames:
        return None
    return every, inside, frames


def _names(name) -> tuple:
    return (name,) if isinstance(name, str) else tuple(name)


def ms_per_frame(run, name, thread: str | None = None):
    """The time of the spans named `name` (a name or several; on `thread`,
    else any) in the window, ms a frame."""
    got = placed(run)
    if got is None:
        return None
    _, inside, frames = got
    hi = run.trace_window[1]
    names = _names(name)
    total = sum(min(p.end, hi) - p.ts for p in inside
                if p.name in names and thread in (None, p.thread))
    return total * 1e-3 / frames


def count_per_frame(run, name):
    """The count of the spans named `name` (a name or several) in the
    window, a frame."""
    got = placed(run)
    if got is None:
        return None
    _, inside, frames = got
    names = _names(name)
    return sum(1 for p in inside if p.name in names) / frames


def handoff_ms(run):
    """`aicp.app.flush` on the main thread less the time inside it that the
    finalizer spends in spans of its own (outermost), ms a frame."""
    got = placed(run)
    if got is None:
        return None
    every, inside, frames = got
    hi = run.trace_window[1]
    fin = [(p.ts, p.end) for p in every
           if p.thread == FINALIZER and p.span.parent is None]
    total = 0.0
    for p in inside:
        if p.name == "aicp.app.flush" and p.thread == MAIN:
            end = min(p.end, hi)
            total += (end - p.ts) - stats.union_length(fin, p.ts, end)
    return total * 1e-3 / frames


def _merged(intervals: list) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        elif e > s:
            out.append([s, e])
    return out


def idle_unspanned(run):
    """The share of the window's device-idle time in which no span of the
    program is open on any thread, %."""
    got = placed(run)
    if got is None:
        return None
    every, _, _ = got
    lo, hi = run.trace_window
    idle = stats.gaps([(e.ts, e.end) for e in run.trace.device_in(lo, hi)],
                      lo, hi)
    total = sum(e - s for s, e in idle)
    if total <= 0.0:
        return None
    spanned = _merged([(max(p.ts, lo), min(p.end, hi)) for p in every])
    covered, j = 0.0, 0
    for s, e in idle:
        while j < len(spanned) and spanned[j][1] <= s:
            j += 1
        k = j
        while k < len(spanned) and spanned[k][0] < e:
            covered += min(e, spanned[k][1]) - max(s, spanned[k][0])
            k += 1
    return (total - covered) / total * 100.0
