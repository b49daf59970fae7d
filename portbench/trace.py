"""Reading an exported `torch.profiler` trace: device events, host spans,
the device's busy time in a window and the host's work in its idle gaps.

`device_events` and `port_kernels` extend copies, at commit
d49b34b8df308b6b17527cfdc9cc292ea998a7ca, of
`aicp_mapping_tpu_torch/tools/profile_localize.py:_device_events` and
`_port_kernels` with each event's start, so that a window can be cut and
intervals merged.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import re

from . import stats

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("user_annotation", "cpu_op", "cuda_runtime", "cuda_driver")
_PORT = re.compile(r"aicp::(?:\(anonymous namespace\)::)?(\w+)")


@dataclasses.dataclass(frozen=True)
class Event:
    cat: str
    name: str
    ts: float          # µs, the trace's clock
    dur: float         # µs
    grid: tuple

    @property
    def end(self) -> float:
        return self.ts + self.dur


@dataclasses.dataclass
class Trace:
    device: list       # Events on the device, by start
    host: list         # host Events (annotations, operators, runtime calls)

    def annotation(self, name: str) -> Event:
        hits = [e for e in self.host
                if e.cat == "user_annotation" and e.name == name]
        if len(hits) != 1:
            raise ValueError(f"{len(hits)} spans named {name!r} in the trace")
        return hits[0]

    def window(self, name: str) -> tuple:
        a = self.annotation(name)
        return a.ts, a.end

    def device_in(self, lo: float, hi: float) -> list:
        return [e for e in self.device if e.end > lo and e.ts < hi]

    def busy_us(self, lo: float, hi: float) -> float:
        return stats.union_length(
            [(e.ts, e.end) for e in self.device_in(lo, hi)], lo, hi)


def load(path: str) -> Trace:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    dev, host = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        ev = Event(cat, e.get("name", ""), float(e["ts"]),
                   float(e.get("dur", 0.0)),
                   tuple(e.get("args", {}).get("grid", ())))
        if cat in DEVICE_CATS:
            dev.append(ev)
        elif cat in HOST_CATS:
            host.append(ev)
    dev.sort(key=lambda e: e.ts)
    return Trace(dev, host)


def port_kernel(name: str):
    """The bare name of a port kernel (namespace aicp), else None."""
    m = _PORT.search(name)
    return m.group(1) if m else None


def kernel_time_us(events: list, scans: tuple, merges: tuple) -> float:
    """Device µs of the kernels named in `scans`, and of each kernel named
    in `merges` that directly follows one of them on the device: a scan
    and the merge pass its entry point launches after it."""
    total, after_scan = 0.0, False
    for e in events:
        if e.cat != "kernel":
            continue
        k = port_kernel(e.name)
        if k in scans:
            total += e.dur
            after_scan = True
        elif k in merges and after_scan:
            total += e.dur
            after_scan = False
        else:
            after_scan = False
    return total


def top_device_ops(events: list, n: int = 10) -> list:
    by = collections.defaultdict(float)
    for e in events:
        by[e.name[:96]] += e.dur * 1e-6
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def idle_gaps(trace: Trace, lo: float, hi: float, n: int = 10) -> list:
    """The `n` longest stretches of [lo, hi] with nothing on the device,
    each named by what the host was doing at its middle: the innermost
    annotation and the innermost operator or runtime call."""
    busy = [(e.ts, e.end) for e in trace.device_in(lo, hi)]
    out = []
    for s, e in sorted(stats.gaps(busy, lo, hi),
                       key=lambda g: g[0] - g[1])[:n]:
        mid = (s + e) / 2
        inner = {}
        for h in trace.host:
            if h.ts <= mid <= h.end:
                kind = "span" if h.cat == "user_annotation" else "call"
                if kind not in inner or h.dur < inner[kind].dur:
                    inner[kind] = h
        name = "/".join(inner[k].name[:60] for k in ("span", "call")
                        if k in inner) or "host"
        out.append([name, (e - s) * 1e-6])
    return out
