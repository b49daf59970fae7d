"""What the entries share: the scene's supply of frames, the App, the
host spans and the staged and traced wrappers.

An entry is a module `portbench/entries/<entry>.py`, found by the name a
traffic mix gives under `"entry"`. It defines `Driver`, a subclass of
`Driver` here that offers frames at its entry point (`_run`, `window`,
`staged`), and `judge(config, collected, device)`, the comparison of what
it collected with the plain reference (`check.judge` for the App frame).
A scene is a module `portbench/scenes/<kind>.py`, found by the
configuration's `scene.kind`; its `make(seed, device=..., **params)`
returns an object with `frame(i) -> (utime, points, prior)` and
`true_pose(i)`.

Each run uses frames 0, 1, 2, ... of its scene in order: the bootstrap,
the warm-up, then the measured or traced frames. The driver records host
spans around the calls it makes into the App's layers (`spans`), and in a
traced segment each ICP phase's rows and iterations per frame
(`icp_calls`), wrapping the solver as a module global.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import importlib
import math
import re
import time

_MODULE = re.compile(r"^[A-Za-z_][A-Za-z0-9_]*$")


class WindowClosed(Exception):
    """Raised inside a replay once its window has ended."""


@dataclasses.dataclass
class Window:
    start: float = 0.0         # perf_counter seconds
    end: float = 0.0
    latencies: list = dataclasses.field(default_factory=list)   # seconds
    frames: list = dataclasses.field(default_factory=list)  # frame indices
    completed: int = 0         # results that came back inside the window
    halves: tuple = ()         # ms a frame in each half (a diagnostic)


def load_module(package: str, name: str):
    """`portbench.<package>.<name>`: an entry or a scene, by its name."""
    if not _MODULE.match(name):
        raise ValueError(f"{package} name {name!r} is not a module name")
    return importlib.import_module(f"portbench.{package}.{name}")


def make_scene(config: dict, seed: int, device):
    scene = dict(config["scene"])
    return load_module("scenes", scene.pop("kind")).make(seed, device=device,
                                                         **scene)


def pipeline_config(config: dict):
    """The port's `PipelineConfig` of a configuration file."""
    from aicp_mapping_tpu_torch.pipeline.config import PipelineConfig

    cfg = PipelineConfig(**config["pipeline"])
    cfg.icp = dataclasses.replace(cfg.icp, **config["icp"])
    return cfg


class Driver:
    pipelined = False

    def __init__(self, config: dict, traffic: dict, seed: int, seconds: float,
                 device):
        import torch

        from aicp_mapping_tpu_torch.pipeline.app import App

        self.torch = torch
        self.config, self.traffic = config, traffic
        self.device = torch.device(device)
        self.cfg = pipeline_config(config)
        self.scene = make_scene(config, seed, self.device)
        n = (1 + traffic["warmup_frames"]
             + max(math.ceil(traffic["max_rate"] * seconds),
                   traffic["staged_frames"] + traffic["traced_frames"])
             + self.cfg.pipeline_depth)
        self.supply = [self.scene.frame(i) for i in range(n)]
        self.next = 0
        self.spans = collections.defaultdict(list)
        self.icp_calls = collections.defaultdict(list)
        self._frame = None
        self._annotate = False
        self.app = App(self.cfg, device=self.device)

    def _span(self, name: str):
        """A profiler annotation in the traced segment, else nothing."""
        if self._annotate:
            return self.torch.profiler.record_function(name)
        return contextlib.nullcontext()

    def sync(self) -> None:
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)

    def _take(self, n: int) -> list:
        if self.next + n > len(self.supply):
            raise RuntimeError(
                f"the scene's supply of {len(self.supply)} frames ran out "
                "before the window ended: raise the mix's max_rate")
        idx = list(range(self.next, self.next + n))
        self.next += n
        return idx

    @contextlib.contextmanager
    def _wrapped(self, module, name: str, wrapper):
        saved = getattr(module, name)
        setattr(module, name, wrapper(saved))
        try:
            yield
        finally:
            setattr(module, name, saved)

    def _synced(self, name: str):
        """A wrapper that times a call between two device syncs."""
        def wrap(fn):
            def run(*args, **kwargs):
                self.sync()
                t0 = time.perf_counter()
                out = fn(*args, **kwargs)
                self.sync()
                self.spans[name].append(time.perf_counter() - t0)
                return out
            return run
        return wrap

    # ------------------------------------------------ entry's own part ----
    def _run(self, idx: list, staged: bool = False) -> list:
        raise NotImplementedError

    def window(self, seconds: float) -> Window:
        raise NotImplementedError

    def staged(self, n: int) -> list:
        raise NotImplementedError

    # ---------------------------------------------------------- phases ----
    def warm_up(self) -> None:
        """The bootstrap and the warm-up frames; the device is idle after,
        and a pipelined App's window of frames in flight stays full."""
        self._run(self._take(1 + self.traffic["warmup_frames"]))
        self.sync()

    def finish(self) -> None:
        """Every result of the frames handed in so far recorded."""
        self.app.flush()

    def traced(self, n: int, profiler) -> list:
        """`n` frames under `profiler`, inside the annotation
        `portbench.window`; each ICP phase's rows and iterations are kept
        per frame (`icp_calls`)."""
        torch = self.torch
        from aicp_mapping_tpu_torch.pipeline import sequence
        from aicp_mapping_tpu_torch.registration import icp

        def recorded(fn):
            def run(reading_points, *args, **kwargs):
                res = fn(reading_points, *args, **kwargs)
                self.icp_calls[self._frame].append(
                    (int(reading_points.shape[0]), int(res.n_iterations)))
                return res
            return run

        def annotated(fn):
            def run(*args, **kwargs):
                with torch.profiler.record_function("portbench.wire_batch"):
                    return fn(*args, **kwargs)
            return run

        idx = self._take(n)
        self._annotate = True
        try:
            with self._wrapped(icp, "point_to_plane_icp", recorded), \
                    self._wrapped(sequence, "wire_batch", annotated), \
                    profiler:
                with torch.profiler.record_function("portbench.window"):
                    done = self._run(idx)
                    self.sync()
        finally:
            self._annotate = False
        self.finish()
        return done

    def collect(self, sample: list, start: int):
        """What the check judges, copied off the device: every frame's
        result, and the aligned clouds of the frames `check.frames_to_judge`
        picks for `sample` and the first `start` frames."""
        from . import check

        accepted = [r.accepted for r in self.app.frames]
        frames = check.frames_to_judge(
            accepted, self.cfg.reference_update_frequency, self.pipelined,
            sample, start)
        n = len(self.app.frames)
        return check.Collected(
            supply=self.supply[:n],
            truth=[self.scene.true_pose(i) for i in range(n)],
            results=check.judged_from_app(self.app, frames),
            frames=frames, start=start)

    def close(self) -> None:
        self.app.close()


def phases_of(calls: list, n_iterations: int, rows: int) -> list:
    """(rows, iterations) of each ICP phase of a frame: the phases recorded
    inside the solver, or its one phase at `rows`."""
    return list(calls) if calls else [(rows, n_iterations)]
