"""Process meshes over `torch.distributed`, PyTorch port of
`aicp_mapping_tpu.parallel.mesh`.

JAX runs one controller over a `Mesh` of devices and lets `shard_map`
insert the collectives. Here each rank is one process on one device (SPMD):
a `Mesh` names the ranks' layout (1-D `("points",)`, `("graph",)` or
`("edges",)`, or 2-D `("graph", "points")`), holds one process group per
axis, and gives the collectives the sharded solvers call — `psum`, `pmin`,
`pmax`, `all_gather`, `broadcast` — with a count of each one's calls and
bytes per axis (`eval.multichip.collective_stats` reads them).

Backends: NCCL when every rank has a card of its own, gloo when ranks
share a card or run on the CPU (`choose_backend`). On gloo a collective of
a CUDA tensor is staged: copied into pinned host memory, reduced there and
copied back, so every torch build runs the same operations; compute stays
on the card. A failed NCCL set-up raises; nothing retries on gloo.

`launch(fn, n, ...)` starts `n` ranks under the `spawn` start method
(rendezvous through a `file://` store in a fresh temporary directory),
joins them with a deadline, kills every rank when one fails or the
deadline passes, and raises the failure. Under `torchrun` it joins the
existing group instead.

The stateful classes (`ShardedMapLocalizer`, `PoseGraphMapper`) keep JAX's
single-controller shape: rank 0 runs them and `send`s each collective step
to the other ranks, which wait in `serve`. Every value that decides a
collective's shape, or whether it runs, comes from rank 0 by broadcast
(sizes first, then arrays) or is itself the result of a collective, so no
rank can wait on a collective the others skip.
"""
from __future__ import annotations

import collections
import datetime
import json
import math
import multiprocessing
import multiprocessing.connection
import os
import pickle
import shutil
import sys
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 600.0
# Reduction ops by name; "all_gather" and "broadcast" are counted too.
_OPS = {"psum": dist.ReduceOp.SUM, "pmin": dist.ReduceOp.MIN,
        "pmax": dist.ReduceOp.MAX}
_STOP = "stop"

RankResult = collections.namedtuple("RankResult", "value launches")


class RankFailed(RuntimeError):
    """A rank of `launch` raised, died, or missed the deadline."""


def choose_backend(device_type: str, world_size: int,
                   device_count: int) -> str:
    """NCCL when the ranks run on cards and each has one of its own, gloo
    when they share a card or run on the CPU."""
    if device_type == "cuda" and world_size <= device_count:
        return "nccl"
    return "gloo"


def rank_device(device="cuda", rank: int | None = None) -> torch.device:
    """The device of a rank: the CPU, or card (local rank % cards). A CUDA
    request without a card raises."""
    kind = torch.device(device).type
    if kind == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(f"rank_device({device!r}): CUDA is not available;"
                           " pass device='cpu' to run the ranks on the CPU")
    if rank is None:
        rank = int(os.environ.get("LOCAL_RANK", dist.get_rank()
                                  if dist.is_initialized() else 0))
    return torch.device("cuda", rank % torch.cuda.device_count())


def initialize_distributed(coordinator: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None, *,
                           backend: str | None = None, device="cuda",
                           timeout_s: float = DEFAULT_TIMEOUT_S) -> str | None:
    """Multi-process bring-up. `coordinator` is "host:port" (a TCP store
    on that address), a `tcp://` or `file://` URL; without one, the
    environment of `torchrun` (`WORLD_SIZE` set) is used, and with neither
    this is a no-op returning None. Returns the backend, chosen by
    `choose_backend` unless given, and prints it on stderr."""
    if coordinator is None and "WORLD_SIZE" not in os.environ:
        return None
    if coordinator is None:
        init, world = "env://", int(os.environ["WORLD_SIZE"])
        rank = int(os.environ["RANK"])
    else:
        init = (coordinator if "://" in coordinator
                else f"tcp://{coordinator}")
        world, rank = int(num_processes), int(process_id)
    dev = rank_device(device, int(os.environ.get("LOCAL_RANK", rank)))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if backend is None:
        backend = choose_backend(dev.type, world, torch.cuda.device_count()
                                 if dev.type == "cuda" else 0)
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown backend {backend!r}")
    dist.init_process_group(backend, init_method=init, world_size=world,
                            rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    if rank == 0:
        print(f"torch.distributed: {world} ranks, backend {backend}, "
              f"device {dev.type}", file=sys.stderr, flush=True)
    return backend


class Mesh:
    """A layout of the ranks: `shape` maps each axis name to its size (in
    order, as JAX's `Mesh.shape`), rank r has row-major coordinates
    `coords`, and each axis has the process group of the ranks that differ
    from this one along that axis only. With one rank and no process group
    every collective is the identity."""

    def __init__(self, shape, axis_names, device="cuda"):
        shape, axis_names = tuple(int(s) for s in shape), tuple(axis_names)
        if len(shape) != len(axis_names) or len(set(axis_names)) != len(
                axis_names):
            raise ValueError(f"mesh shape {shape} and axes {axis_names}")
        size = math.prod(shape)
        self.distributed = dist.is_initialized()
        world = dist.get_world_size() if self.distributed else 1
        if size != world:
            raise ValueError(f"a mesh of {size} ranks in a world of {world}")
        self.rank = dist.get_rank() if self.distributed else 0
        self.shape = dict(zip(axis_names, shape))
        self.axis_names = axis_names
        self.device = rank_device(device, self.rank)
        self.backend = dist.get_backend() if self.distributed else None
        # gloo reduces host tensors: CUDA tensors go through pinned memory
        self.staged = self.backend == "gloo" and self.device.type == "cuda"
        rest, coords = self.rank, []
        for s in reversed(shape):
            coords.append(rest % s)
            rest //= s
        self.coords = dict(zip(axis_names, reversed(coords)))
        self._groups: dict = {}
        self._ranks: dict = {}
        timeout = datetime.timedelta(seconds=DEFAULT_TIMEOUT_S)
        for a, name in enumerate(axis_names):
            # every rank creates every group, in the same order
            for members in _axis_groups(shape, a):
                if self.distributed and len(axis_names) > 1:
                    group = dist.new_group(members, timeout=timeout)
                else:
                    group = None          # the whole world
                if self.rank in members:
                    self._groups[name], self._ranks[name] = group, members
        self.counters: dict = {}

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank {self.rank} at {self.coords}, "
                f"{self.device}, backend {self.backend})")

    # -------------------- layout --------------------
    def index(self, axis: str) -> int:
        """This rank's coordinate along `axis` (JAX's `axis_index`)."""
        return self.coords[axis]

    def shard(self, n: int, axis: str) -> slice:
        """This rank's contiguous rows of `n` along `axis`, as
        `PartitionSpec(axis)` lays them out; `n` must divide evenly."""
        d = self.shape[axis]
        if n % d:
            raise ValueError(f"{n} rows do not split over {d} ranks of "
                             f"axis {axis!r}")
        i = self.index(axis)
        return slice(i * n // d, (i + 1) * n // d)

    # -------------------- counters --------------------
    def _count(self, axis: str, op: str, nbytes: int) -> None:
        c = self.counters.setdefault(axis, {}).setdefault(
            op, {"calls": 0, "bytes": 0})
        c["calls"] += 1
        c["bytes"] += int(nbytes)

    def counts(self) -> dict:
        """A copy of the counters: {axis: {op: {"calls", "bytes"}}}."""
        return json.loads(json.dumps(self.counters))

    def reset_counts(self) -> None:
        self.counters = {}

    # -------------------- collectives --------------------
    def _run(self, x: torch.Tensor, axis: str | None, call) -> torch.Tensor:
        """Apply the in-place collective `call(buffer, group)` to a copy of
        `x` (staged through pinned host memory on gloo); bool tensors
        travel as uint8."""
        dtype = x.dtype
        buf = x.detach().to(torch.uint8 if dtype == torch.bool else dtype)
        if not self.distributed:
            return buf.clone().to(dtype)
        group = None if axis is None else self._groups[axis]
        if self.staged and buf.is_cuda:
            host = torch.empty(buf.shape, dtype=buf.dtype, pin_memory=True)
            host.copy_(buf)
            call(host, group)
            out = host.to(x.device)
        else:
            out = buf.clone()
            call(out, group)
        return out.to(dtype)

    def _reduce(self, x: torch.Tensor, axis: str, op: str) -> torch.Tensor:
        self._count(axis, op, x.numel() * x.element_size())
        return self._run(x, axis, lambda b, g: dist.all_reduce(
            b, op=_OPS[op], group=g))

    def psum(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        return self._reduce(x, axis, "psum")

    def pmin(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        return self._reduce(x, axis, "pmin")

    def pmax(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        return self._reduce(x, axis, "pmax")

    def psum_many(self, xs, axis: str) -> list:
        """The `psum` of each tensor of `xs` (one dtype), in one
        collective."""
        flat = self.psum(torch.cat([x.reshape(-1) for x in xs]), axis)
        out, at = [], 0
        for x in xs:
            out.append(flat[at:at + x.numel()].reshape(x.shape))
            at += x.numel()
        return out

    def all_gather(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """(axis size, *x.shape): every rank's `x` in coordinate order
        (staged through pinned host memory on gloo, as `_run` does)."""
        dtype = x.dtype
        buf = x.detach().to(torch.uint8 if dtype == torch.bool else dtype)
        d = self.shape[axis]
        self._count(axis, "all_gather", d * buf.numel() * buf.element_size())
        if not self.distributed:
            return buf[None].clone().to(dtype)
        if self.staged and buf.is_cuda:
            host = torch.empty(buf.shape, dtype=buf.dtype, pin_memory=True)
            buf = host.copy_(buf)
        out = torch.empty((d,) + tuple(buf.shape), dtype=buf.dtype,
                          device=buf.device)
        dist.all_gather(list(out.unbind(0)), buf.contiguous(),
                        group=self._groups[axis])
        return out.to(x.device).to(dtype)

    def broadcast(self, x: torch.Tensor, axis: str | None = None,
                  count_as: str | None = None) -> torch.Tensor:
        """Rank 0's `x` (of the axis group, or of the world) on every rank;
        every rank passes a tensor of the same shape and dtype."""
        self._count(count_as or axis or "world", "broadcast",
                    x.numel() * x.element_size())
        if axis is None:
            src = 0
        else:
            src = self._ranks[axis][0]
        return self._run(x, axis, lambda b, g: dist.broadcast(
            b, src=src, group=g))

    # -------------------- controller and servers --------------------
    def send(self, name: str, tensors=(), **options) -> None:
        """Rank 0: tell every other rank (waiting in `serve`) to run command
        `name` on `tensors` with JSON `options` — first the header's length,
        then the header (name, options, each tensor's dtype and shape), then
        the tensors."""
        if self.rank != 0:
            raise RuntimeError("only rank 0 sends commands")
        head = json.dumps({"name": name, "options": options, "tensors": [
            [str(t.dtype).split(".")[1], list(t.shape)] for t in tensors]})
        self._exchange(head, tensors)

    def receive(self):
        """Ranks >= 1: the next command of rank 0, as (name, tensors on this
        rank's device, options)."""
        return self._exchange(None, ())

    def _exchange(self, head, tensors):
        if not self.distributed:
            return None
        raw = head.encode() if head is not None else b""
        n = self.broadcast(torch.tensor([len(raw)], dtype=torch.int64,
                                        device=self.device),
                           count_as="control")
        n = int(n.item())
        data = (torch.frombuffer(bytearray(raw), dtype=torch.uint8)
                .to(self.device) if head is not None else
                torch.empty((n,), dtype=torch.uint8, device=self.device))
        data = self.broadcast(data, count_as="control")
        msg = json.loads(bytes(data.cpu().numpy()).decode())
        out = []
        for i, (dtype, shape) in enumerate(msg["tensors"]):
            t = (tensors[i].to(self.device).contiguous() if head is not None
                 else torch.empty(shape, dtype=getattr(torch, dtype),
                                  device=self.device))
            out.append(self.broadcast(t, count_as="control"))
        return msg["name"], out, msg["options"]

    def serve(self, handlers: dict) -> None:
        """Ranks >= 1: run rank 0's commands — `handlers[name](tensors,
        options)` — until it sends `stop_serving`."""
        while True:
            name, tensors, options = self.receive()
            if name == _STOP:
                return
            if name not in handlers:
                raise RuntimeError(f"rank {self.rank}: unknown command "
                                   f"{name!r}")
            handlers[name](tensors, options)

    def stop_serving(self) -> None:
        """Rank 0: release the ranks waiting in `serve`."""
        if self.distributed and self.rank == 0:
            self.send(_STOP)


def _axis_groups(shape: tuple, axis: int) -> list:
    """The rank groups along `axis`: each holds the ranks whose other
    coordinates are equal, in coordinate order."""
    n = math.prod(shape)
    stride = math.prod(shape[axis + 1:])
    groups, seen = [], set()
    for r in range(n):
        if r in seen:
            continue
        base = r - ((r // stride) % shape[axis]) * stride
        members = [base + k * stride for k in range(shape[axis])]
        seen.update(members)
        groups.append(members)
    return groups


def make_mesh(n_devices: int | None = None, axis: str = "points",
              device="cuda") -> Mesh:
    """A 1-D mesh over every rank of the world (`n_devices`, when given,
    must be its size); the ranks run on `device` ("cuda": card rank %
    cards)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    n = world if n_devices is None else int(n_devices)
    return Mesh((n,), (axis,), device)


def make_mesh_2d(shape: tuple, axes=("graph", "points"),
                 device="cuda") -> Mesh:
    """A 2-D mesh of shape (rows, columns) over the world, row-major."""
    return Mesh(tuple(shape), tuple(axes), device)


# ---------------------------------------------------------------------------
# Launcher
# ---------------------------------------------------------------------------

def launch(fn, n: int, *args, backend: str | None = None, device="cuda",
           timeout_s: float = DEFAULT_TIMEOUT_S) -> list:
    """Run `fn(*args)` on `n` ranks with a process group initialised, and
    return each rank's `RankResult(value, launches)` (its value and its
    kernel launch counts) in rank order. Rank r runs on the CPU, or on
    card r % cards, and `backend` defaults to `choose_backend`'s. The ranks
    are spawned processes (`fn` and `args` are pickled) with this
    process's number of CPU threads (so that a CPU rank sums as the caller
    does): a rank that raises or dies, or a deadline of `timeout_s` that
    passes, kills every rank and raises `RankFailed`. Under `torchrun` (`WORLD_SIZE` set) this
    process is one rank of the existing group: it runs `fn` and returns its
    own result only."""
    kind = torch.device(device).type
    if kind == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("launch(device='cuda'): CUDA is not available; "
                           "pass device='cpu' to run the ranks on the CPU")
    if "WORLD_SIZE" in os.environ:
        if int(os.environ["WORLD_SIZE"]) != n:
            raise ValueError(f"launch({n}) under torchrun with WORLD_SIZE="
                             f"{os.environ['WORLD_SIZE']}")
        if not dist.is_initialized():
            initialize_distributed(backend=backend, device=kind,
                                   timeout_s=timeout_s)
        return [RankResult(fn(*args), _launch_counts())]
    if backend is None:
        backend = choose_backend(kind, n, torch.cuda.device_count()
                                 if kind == "cuda" else 0)
    ctx = multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="aicp_mesh_")
    procs = [ctx.Process(target=_rank_main, daemon=True, args=(
        fn, args, r, n, os.path.join(tmp, "rendezvous"), backend, kind,
        timeout_s, os.path.join(tmp, f"rank{r}.pkl"),
        torch.get_num_threads())) for r in range(n)]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        while any(p.exitcode is None for p in procs):
            if any(p.exitcode not in (None, 0) for p in procs):
                break
            left = deadline - time.monotonic()
            if left <= 0:
                break
            multiprocessing.connection.wait(
                [p.sentinel for p in procs if p.exitcode is None],
                timeout=min(left, 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join(10)
    try:
        results = [_read_result(os.path.join(tmp, f"rank{r}.pkl"))
                   for r in range(n)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    failed = [(r, res) for r, res in enumerate(results)
              if res is None or "error" in res]
    if failed:
        errors = [(res["at"], r, res) for r, res in failed
                  if res is not None]
        if errors:
            _, r, res = min(errors, key=lambda e: e[0])   # the first failure
            raise RankFailed(f"rank {r} of {n} failed:\n{res['error']}"
                             ) from res.get("exception")
        codes = [p.exitcode for p in procs]
        raise RankFailed(f"{n} ranks did not finish within {timeout_s} s "
                         f"or died (exit codes {codes})")
    return [RankResult(res["value"], res["launches"]) for res in results]


def _launch_counts() -> dict:
    from .. import _kernels

    return _kernels.launch_counts()


def _read_result(path: str):
    if not os.path.exists(path):
        return None
    with open(path, "rb") as f:
        return pickle.load(f)      # written by this launcher's own ranks


def _rank_main(fn, args, rank, n, store, backend, kind, timeout_s,
               out_path, threads) -> None:
    """One spawned rank: initialise the group, run `fn`, write the result
    (or the error) for the launcher, and exit."""
    torch.set_num_threads(threads)
    try:
        if kind == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(
            backend, init_method=f"file://{store}", world_size=n, rank=rank,
            timeout=datetime.timedelta(seconds=timeout_s))
        result = {"value": fn(*args), "launches": _launch_counts()}
        code = 0
    except BaseException as e:  # noqa: BLE001 - reported to the launcher
        result = {"error": traceback.format_exc(), "at": time.time()}
        try:
            pickle.dumps(e)
            result["exception"] = e
        except Exception:  # noqa: BLE001 - an unpicklable exception
            pass
        code = 1
    tmp = out_path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(result, f)
    os.replace(tmp, out_path)
    sys.stdout.flush()
    sys.stderr.flush()
    if code == 0:
        dist.destroy_process_group()
    # a failed rank leaves at once: its peers may be blocked in a
    # collective that would hold a clean shutdown
    os._exit(code)
