"""One run of one cell: set-up, the measured window or the traced
segments, the correctness check, the metrics and the result line.

`run_cell` is what `run.py` calls on the card; tests call it on the CPU
at a tiny size. It loads the cell's entry (`entries/<entry>.py`, named by
the traffic mix) and calls only its hooks (`drivers.py` says which): the
warm-up, the window or the staged and traced segments, what the check
collects, and the entry's own comparison with the reference. The run
record handed to the metric readers (`Run`) holds the window, the host
spans, the program's frame results and counters, the device trace and the
check's by-products.
"""
from __future__ import annotations

import dataclasses
import os
import sys
import tempfile
import time

import numpy as np

from . import check, drivers, spec, stats, trace as trace_mod

FORBIDDEN = ("jax", "jaxlib", "flax", "aicp_mapping_tpu")


def process_age_s() -> float:
    """Seconds since this process started (Linux: /proc)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


@dataclasses.dataclass
class Run:
    cell: spec.Cell
    window: drivers.Window | None = None
    setup_s: float = 0.0
    spans: dict = dataclasses.field(default_factory=dict)
    results: list = dataclasses.field(default_factory=list)  # FrameResults
    staged: list = dataclasses.field(default_factory=list)   # frame indices
    traced: list = dataclasses.field(default_factory=list)
    icp_calls: dict = dataclasses.field(default_factory=dict)
    trace: trace_mod.Trace | None = None
    trace_window: tuple = (0.0, 0.0)      # µs, the trace's clock
    schedule: list = dataclasses.field(default_factory=list)
    neighbours: dict = dataclasses.field(default_factory=dict)

    @property
    def pipeline(self) -> dict:
        return self.cell.config["pipeline"]


def _sample(frames: list, n: int, seed: int, extra=()) -> list:
    """`n` of `frames` drawn from the seed, with `extra`."""
    rng = np.random.default_rng([int(seed), 7])
    pick = rng.choice(len(frames), size=min(n, len(frames)), replace=False)
    return sorted({frames[i] for i in pick} | set(extra))


def run_cell(cell: spec.Cell, seed: int, seconds: float, traced: bool,
             device="cuda", log=print) -> dict:
    """Run the cell once; returns the result line's object (with its
    `check` table last)."""
    import torch

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        from aicp_mapping_tpu_torch import _kernels
        torch.zeros(1, device=dev)
        _kernels.library()
    entry = drivers.load_module("entries", cell.traffic["entry"])
    drv = entry.Driver(cell.config, cell.traffic, seed, seconds, dev)
    run = Run(cell)
    traffic, work = cell.traffic, cell.workload
    try:
        drv.warm_up()
        if not traced:
            run.setup_s = process_age_s()
            run.window = drv.window(seconds)
        else:
            drv.spans.clear()
            run.staged = drv.staged(traffic["staged_frames"])
            activities = [torch.profiler.ProfilerActivity.CPU]
            if cuda:
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=activities)
            run.traced = drv.traced(traffic["traced_frames"], prof)
            with tempfile.TemporaryDirectory() as tmp:
                path = os.path.join(tmp, "trace.json")
                prof.export_chrome_trace(path)
                run.trace = trace_mod.load(path)
            run.trace_window = run.trace.window("portbench.window")
        drv.finish()
        memory_peak = (torch.cuda.max_memory_allocated(dev) if cuda else 0)
        run.spans = dict(drv.spans)
        run.icp_calls = dict(drv.icp_calls)
        run.results = list(drv.app.frames)
        start = min(int(work["check"]["start_frames"]),
                    len(run.results) - 1)
        if traced:
            sample = list(run.traced) + _sample(
                run.staged, work["check"]["sample_frames"], seed)
        else:
            frames = run.window.frames
            slowest = max(frames, key=lambda k: run.results[k].n_iterations)
            sample = _sample(frames, work["check"]["sample_frames"], seed,
                             extra=(slowest,))
        collected = drv.collect(sample, start)
    finally:
        drv.close()
    del drv
    if cuda:
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    got = entry.judge(cell.config, collected, dev)
    check_s = time.perf_counter() - t0
    run.neighbours = got["neighbours"]
    run.schedule = got["schedule"]
    correct, table = check.verdict(got["numbers"], work["limits"])

    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        value = spec.load_reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    if traced:
        attempted = len(run.staged) + len(run.traced)
    else:
        attempted = len(run.window.frames)
    done = set(range(len(run.results)))
    failed = sum(1 for k in (run.staged + run.traced if traced
                             else run.window.frames) if k not in done)
    out = {"correct": bool(correct), "attempted": attempted,
           "failed": failed, "metrics": metrics,
           "device": device_record(torch, dev, cell.chips, memory_peak)}
    if traced:
        lo, hi = run.trace_window
        busy = run.trace.busy_us(lo, hi) * 1e-6
        out["device"].update(busy_s=busy, window_s=(hi - lo) * 1e-6)
        out["breakdown"] = {
            "device_ops": trace_mod.top_device_ops(
                run.trace.device_in(lo, hi)),
            "idle_gaps": trace_mod.idle_gaps(run.trace, lo, hi)}
    log(f"portbench: {cell.name} seed {seed}: judged {len(got['frames'])} "
        f"frames in {check_s:.1f} s; widest: {got['worst']}")
    w = run.window
    if w is not None and w.halves:
        log(f"portbench: the window's halves, ms a frame: {w.halves}")
    if w is not None and w.latencies:
        log(f"portbench: the window's 95th percentile latency, ms: "
            f"{stats.percentile([t * 1e3 for t in w.latencies], 95.0)}")
    out["check"] = table
    return out


def device_record(torch, dev, chips: int, memory_peak: int) -> dict:
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": int(memory_peak)}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": int(chips), "memory_peak_bytes": int(memory_peak)}
