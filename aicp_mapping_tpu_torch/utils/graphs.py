"""CUDA graphs shared by the port's captured stages: ICP's iteration
(`registration/icp.py`) and the risk stage (`pipeline/risk_graph.py`).

- The key of a captured call (`key`): the stage's configuration, the
  device, the calling thread and its current stream (so that no two
  threads share a graph's buffers), and the inputs' shapes and dtypes.
  Each stage keeps its own cache, so the stage is the cache.
- The policy (`lookup`, `warmed`): a key's first call runs eagerly, which
  warms cuBLAS, cuSOLVER and the caching allocator, and then marks the
  key; its second call captures; later calls replay. A cache keeps
  `GRAPH_KEYS` keys, least recently used out first.
- The capture (`capture`): PyTorch's recipe on a side stream, under one
  process-wide lock, in `thread_local` mode. A launch recorded into it is
  counted at each of the graph's replays (`counted`), the first included,
  so host-side launch counts follow what runs on the card.
- One counter dict, keyed by stage (`register`, `count`, `counts`,
  `reset_counts`): captures, replays and the calls or iterations run
  eagerly.
"""
from __future__ import annotations

import threading

import torch

# The captured calls each stage keeps: a caller whose shapes vary (the SLAM
# back-end's ICP) cycles through a few.
GRAPH_KEYS = 8
_cache_lock = threading.Lock()
# PyTorch allows one capture at a time in a process.
_capture_lock = threading.Lock()
_counts: dict = {}
_count_lock = threading.Lock()
# The tally of the graph this thread is capturing (`capture`), if any.
_recording = threading.local()


def key(config, tensors, device) -> tuple:
    """(config, device, thread, current stream, the tensors' shapes and
    dtypes)."""
    dev = torch.device(device)
    stream = (torch.cuda.current_stream(dev).cuda_stream
              if dev.type == "cuda" else None)
    return (config, str(dev), threading.get_ident(), stream,
            tuple((tuple(t.shape), t.dtype) for t in tensors))


def capturing(device) -> bool:
    """Whether work on `device` is being captured into a CUDA graph on the
    current stream: a launch is then recorded, not run, and the graph's
    replays count it."""
    return (torch.device(device).type == "cuda"
            and torch.cuda.is_current_stream_capturing())


def lookup(cache, key, make, keys: int = GRAPH_KEYS):
    """The captured entry of `key` in `cache`, or None on the key's first
    call (which runs eagerly and then calls `warmed`). On the second call
    `make()` builds and captures the entry."""
    with _cache_lock:
        if key not in cache:
            return None
        cache.move_to_end(key)
        entry = cache[key]
    if entry is None:
        entry = make()
        with _cache_lock:
            cache[key] = entry
            _evict(cache, keys)
    return entry


def warmed(cache, key, keys: int = GRAPH_KEYS) -> None:
    """Mark `key` as run once eagerly: its next call captures."""
    with _cache_lock:
        cache.setdefault(key, None)
        cache.move_to_end(key)
        _evict(cache, keys)


def _evict(cache, keys: int) -> None:
    while len(cache) > keys:
        cache.popitem(last=False)


class Graph:
    """A captured CUDA graph and the counts its capture recorded
    (`counted`): each replay runs the graph, then adds them."""

    def __init__(self, graph):
        self.graph, self.tally = graph, []

    def replay(self) -> None:
        self.graph.replay()
        for fn, args in self.tally:
            fn(*args)


def counted(device, fn, *args) -> None:
    """Count device work just launched on `device`: `fn(*args)` now, or,
    where the launch was only recorded into this thread's capture, at each
    replay of that graph. A launch recorded into a capture not made by
    `capture` is not counted."""
    if not capturing(device):
        fn(*args)
        return
    tally = getattr(_recording, "tally", None)
    if tally is not None:
        tally.append((fn, args))


def capture(body, device) -> Graph:
    """`body` as a CUDA graph, by PyTorch's recipe: run it once on a side
    stream, then capture it there. `thread_local`: other threads (the
    App's finalizer) may work on the card meanwhile. The capture waits for
    the whole card first, so replays on the caller's stream follow the
    warm-up."""
    dev = torch.device(device)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        body()
    graph = Graph(torch.cuda.CUDAGraph())
    with _capture_lock, torch.cuda.graph(
            graph.graph, stream=side, capture_error_mode="thread_local"):
        _recording.tally = graph.tally
        try:
            body()
        finally:
            _recording.tally = None
    return graph


def register(stage: str, *names: str) -> None:
    """The counters of `stage`, at 0."""
    with _count_lock:
        _counts.setdefault(stage, dict.fromkeys(names, 0))


def count(stage: str, name: str, n: int = 1) -> None:
    with _count_lock:
        _counts[stage][name] += n


def counts(stage: str) -> dict:
    """The counters of `stage` since its last `reset_counts`."""
    with _count_lock:
        return dict(_counts[stage])


def reset_counts(stage: str) -> None:
    with _count_lock:
        for k in _counts[stage]:
            _counts[stage][k] = 0
