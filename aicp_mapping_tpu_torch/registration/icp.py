"""Auto-tuned trimmed point-to-plane ICP, PyTorch port of
`aicp_mapping_tpu.registration.icp`.

matcher:   kernel K1 (`ops.knn.nn_payload_kernel`) over the whole
           reference, or against a map-scale reference the Morton-banded
           kernel K5 (`ops.banded_nn`); on a CPU tensor their plain twins
outlier:   trimmed-distance filter with a histogram quantile, globally or
           per normal-space bucket, optional max match distance
minimizer: point-to-plane (or point-to-point) 6x6 normal equations,
           optionally degeneracy-aware (solution remapping)
checkers:  max iteration count + smoothed differential transformation

The JAX solver is one device `lax.while_loop`. Here the loop is Python
with early exit: once the checker's history is full, each iteration reads
one scalar (the convergence flag) back to the host. `T`, `n_iterations`
and the final-iteration statistics are those of the while_loop. One
iteration is `_make_step`, a step on explicit state that reads nothing
back itself; two loops drive it (`capture_plan` picks from the inputs):

- on CUDA with K1 as the matcher, off a mesh and not degeneracy-aware, the
  step is captured once per key (shapes, config, thread and stream) as a
  CUDA graph and replayed once an iteration: one launch in place of ~100,
  the solve's error code left on the device and read with the flag;
- everywhere else the eager loop, where on the card each iteration's
  `torch.linalg.solve` (and, degeneracy-aware, its `eigh`) reads its error
  flag back too.

Each host read is a span of the port's tracer (`utils.timing`):
"aicp.icp.sync" the convergence flag's (on the graph path the status that
carries it), "aicp.icp.solve_check" each eager linear-algebra call's; each
replay is a span "aicp.icp.replay".

SPMD (`config.axis_name` and a `mesh` of `parallel.mesh`): with
`shard_axis_mode="reading"` each rank holds a slice of the reading and
the whole reference; the trim histograms, the normal equations and the
inlier statistics are `psum`-reduced, so every rank steps the same
transform and reads the same convergence flag. With "reference" each rank
holds a block of the reference and the whole reading; the global nearest
neighbour is the `pmin` of the blocks' distances, ties to the lowest
block, whose payload is selected by a `psum`, after which the solve runs
without collectives (`parallel.sharded_icp`).
"""
from __future__ import annotations

import collections
import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..geometry import se3
from ..ops.banded_nn import (banded_prepare_payload, banded_window_starts,
                             morton_codes, nn_payload_banded_stream_kernel,
                             payload_rows)
from ..ops.knn import nn_payload_kernel
from ..ops.quantile import masked_quantile_hist
from ..utils import graphs
from ..utils.graphs import GRAPH_KEYS
from ..utils.timing import span

_BIG = 3.4e38
# Validity guard for NN distances: far below the no-match sentinel.
_VALID_DIST = 1e30
# The captured solves (`capture_plan`), at most `GRAPH_KEYS` of them, least
# recently used out first (`utils.graphs`).
_graphs: collections.OrderedDict = collections.OrderedDict()
graphs.register("icp", "captures", "replays", "eager_iterations")


@dataclasses.dataclass(frozen=True)
class ICPConfig:
    """Static solver configuration — the fields and defaults of the JAX
    `ICPConfig` (see its docstrings for each field's meaning).

    `use_pallas` only selects a TPU kernel in JAX and is ignored here: the
    matcher is chosen by `solver_plan`. `axis_name` names the mesh axis
    of an SPMD solve and `shard_axis_mode` ("reading" or "reference") the
    operand sharded along it; `point_to_plane_icp` then takes the mesh."""

    max_iterations: int = 20
    min_diff_trans: float = 0.01
    min_diff_rot: float = 0.001
    smooth_length: int = 4
    damping: float = 1e-6
    use_pallas: bool | None = None
    error_metric: str = "point_to_plane"
    max_match_dist: float = 0.0
    nn_mode: str = "auto"
    nn_band: int = 0
    nn_cell_size: float = 4.0
    trim_ratio: float = 0.0
    trim_normal_space: bool = False
    degeneracy_threshold: float = 0.0
    coarse_iterations: int = 0
    coarse_decimation: int = 4
    axis_name: str | None = None
    shard_axis_mode: str = "reading"


@dataclasses.dataclass(frozen=True)
class ICPResult:
    T: torch.Tensor             # (4, 4) correction: reading -> reference
    n_iterations: int
    inlier_rms: torch.Tensor    # 0-d
    match_dist2: torch.Tensor   # (M,) squared NN distances
    inlier_mask: torch.Tensor   # (M,)
    hessian: torch.Tensor       # (6, 6)
    # Per-point stats, hessian and inlier_rms are those of the FINAL SOLVED
    # ITERATION (linearized at the transform before the last update).


def solver_plan(config: ICPConfig, M: int, N: int, device) -> dict:
    """Which matcher `point_to_plane_icp` takes for (reading M, reference
    N) on `device`, and whether it runs coarse-to-fine.

    {"nn": "banded" | "kernel" | "plain", "coarse": bool}. "kernel" is K1
    over the whole reference (every shape on CUDA), "plain" its twin on
    CPU. "banded" is the Morton-banded matcher, under `nn_mode="auto"`
    chosen by shape on every device (N >= 32,768, M % 512 == 0,
    N % 1024 == 0; ROADMAP Q3): K5 at any number of reference blocks, the
    plain twin on CPU. (JAX also picks a VMEM-resident or a streaming
    kernel at 64 blocks; on the card one kernel serves both.)"""
    is_cuda = torch.device(device).type == "cuda"
    aligned = M % 512 == 0 and N % 1024 == 0
    banded = (config.nn_mode == "banded"
              or (config.nn_mode == "auto" and N >= 32768 and aligned))
    nn = "banded" if banded else ("kernel" if is_cuda else "plain")
    d = config.coarse_decimation
    coarse = (config.coarse_iterations > 0 and d > 1
              and M % (512 * d) == 0)
    return {"nn": nn, "coarse": coarse}


def capture_plan(config: ICPConfig, plan: dict, device, mesh=None) -> bool:
    """Whether a single-phase solve with `solver_plan`'s `plan` replays its
    iteration as a CUDA graph: on CUDA with K1 as the matcher, off a mesh
    (collectives cannot sit in a graph) and not degeneracy-aware
    (`torch.linalg.eigh` reads its error flag), for at least one
    iteration. Everywhere else the loop is eager: the CPU's plain twin, the
    banded matcher, the sharded modes, the degeneracy-aware solve."""
    return (torch.device(device).type == "cuda" and plan["nn"] == "kernel"
            and mesh is None and config.axis_name is None
            and config.degeneracy_threshold == 0.0
            and config.max_iterations > 0)


def graph_counts() -> dict:
    """Captures, replays (one an iteration) and iterations run eagerly,
    since the last `reset_graph_counts`."""
    return graphs.counts("icp")


def reset_graph_counts() -> None:
    graphs.reset_counts("icp")


def _count(name: str, n: int = 1) -> None:
    graphs.count("icp", name, n)


def point_to_plane_icp(reading_points: torch.Tensor,
                       reading_mask: torch.Tensor,
                       reference_points: torch.Tensor,
                       reference_normals: torch.Tensor,
                       reference_mask: torch.Tensor,
                       init_T: torch.Tensor,
                       trim_ratio,
                       config: ICPConfig = ICPConfig(), *,
                       mesh=None) -> ICPResult:
    """Trimmed point-to-plane ICP; returns the correction T with
    aligned = T @ reading. `trim_ratio` is a 0-d tensor (or float).

    With `config.axis_name` every rank of `mesh` calls this with its own
    shard (module docstring); the plan is each shard's own, and per-point
    outputs are the shard's rows."""
    axis = config.axis_name
    if axis is not None and (mesh is None or config.shard_axis_mode
                             not in ("reading", "reference")):
        raise ValueError("ICPConfig.axis_name needs a mesh and a "
                         "shard_axis_mode of 'reading' or 'reference'")
    reading_sharded = axis is not None and config.shard_axis_mode == "reading"
    ref_sharded = axis is not None and config.shard_axis_mode == "reference"
    M, N = reading_points.shape[0], reference_points.shape[0]
    plan = solver_plan(config, M, N, reading_points.device)

    if plan["coarse"]:
        d = config.coarse_decimation
        ccfg = dataclasses.replace(
            config, coarse_iterations=0,
            max_iterations=config.coarse_iterations,
            min_diff_trans=config.min_diff_trans * 2.0,
            min_diff_rot=config.min_diff_rot * 2.0)
        coarse = point_to_plane_icp(
            reading_points[::d].contiguous(),
            reading_mask[::d].contiguous(), reference_points,
            reference_normals, reference_mask, init_T, trim_ratio, ccfg,
            mesh=mesh)
        fcfg = dataclasses.replace(
            config, coarse_iterations=0,
            max_iterations=max(config.max_iterations
                               - config.coarse_iterations, 1),
            smooth_length=min(config.smooth_length, 2))
        fine = point_to_plane_icp(
            reading_points, reading_mask, reference_points,
            reference_normals, reference_mask, coarse.T, trim_ratio, fcfg,
            mesh=mesh)
        return dataclasses.replace(
            fine, n_iterations=fine.n_iterations + coarse.n_iterations)

    p2plane = config.error_metric == "point_to_plane"
    if config.error_metric not in ("point_to_plane", "point_to_point"):
        raise ValueError(f"unknown error_metric {config.error_metric!r}")
    ref_normals = reference_normals if p2plane else None
    inputs = (reading_points, reading_mask, reference_points, ref_normals,
              reference_mask, init_T, trim_ratio)
    key = None
    if capture_plan(config, plan, reading_points.device, mesh):
        key = _graph_key(config, inputs)
        rep = _graph_for(key, config, inputs)
        if rep is not None:
            return _replayed(rep, config, inputs)

    dev = reading_points.device
    if plan["nn"] == "banded":
        match, work_points, work_mask, inv_q = _banded_matcher(
            config, reading_points, reading_mask, reference_points,
            ref_normals, reference_mask, init_T,
            mesh if ref_sharded else None)
    else:
        match = _full_matcher(reference_points, ref_normals, reference_mask)
        work_points, work_mask = reading_points, reading_mask.contiguous()
        inv_q = None
    if ref_sharded:
        match = _global_matcher(match, mesh, axis, 6 if p2plane else 3)
    red_axis = axis if reading_sharded else None
    step = _make_step(config, match, work_points, work_mask,
                      work_mask.to(torch.float32), trim_ratio,
                      _checked_solve, mesh, red_axis)

    S = config.smooth_length
    T = init_T.to(torch.float32)
    hist_t = torch.full((S,), _BIG, dtype=torch.float32, device=dev)
    hist_r = torch.full((S,), _BIG, dtype=torch.float32, device=dev)
    A = torch.zeros((6, 6), dtype=torch.float32, device=dev)
    dist2 = torch.full((M,), _BIG, dtype=torch.float32, device=dev)
    w = torch.zeros((M,), dtype=torch.float32, device=dev)
    r = torch.zeros((M,), dtype=torch.float32, device=dev)
    stats = torch.zeros((2,), dtype=torch.float32, device=dev)
    it = 0
    while it < config.max_iterations:
        T, hist_t, hist_r, converged, A, dist2, w, r, stats, _ = step(
            T, hist_t, hist_r)
        it += 1
        # DifferentialTransformationChecker, once its history is full: one
        # scalar read per iteration, each a span "aicp.icp.sync"
        if it >= S:
            with span("aicp.icp.sync"):
                done = bool(converged)
            if done:
                break
    _count("eager_iterations", it)
    if key is not None:
        _warmed(key)

    if red_axis is not None:
        # the final iteration's global inlier sums, reduced in its psum
        inlier_rms = torch.sqrt(stats[1] / torch.clamp(stats[0], min=1.0))
    else:
        wsum = torch.clamp(w.sum(), min=1.0)
        inlier_rms = torch.sqrt((w * r * r).sum() / wsum)
    if inv_q is not None:
        # per-point outputs back to the caller's reading order
        dist2, w = dist2[inv_q], w[inv_q]
    return ICPResult(T=T, n_iterations=it, inlier_rms=inlier_rms,
                     match_dist2=dist2, inlier_mask=w > 0, hessian=A)


class _Step(NamedTuple):
    """What one iteration gives: the state after its update (`T`, the
    checker's histories), the checker's flag, and the iteration's
    statistics: the normal matrix, squared match distances, inlier weights
    and residuals, the reduced inlier sums (reading-sharded) and the
    solve's error code (`_unchecked_solve`; None from `_checked_solve`)."""
    T: torch.Tensor
    hist_t: torch.Tensor
    hist_r: torch.Tensor
    converged: torch.Tensor
    A: torch.Tensor
    dist2: torch.Tensor
    w: torch.Tensor
    r: torch.Tensor
    stats: Optional[torch.Tensor]
    info: Optional[torch.Tensor]


def _checked_solve(M, b):
    """`torch.linalg.solve`: on the card it reads its error flag back, one
    span "aicp.icp.solve_check" a read. Returns (x, None)."""
    with span("aicp.icp.solve_check"):
        return torch.linalg.solve(M, b), None


def _unchecked_solve(M, b):
    """The LU solve of `torch.linalg.solve` (which is `solve_ex` and a host
    check of its error code) with the code left on the device: (x, info)."""
    x, info = torch.linalg.solve_ex(M, b, check_errors=False)
    return x, info


def _make_step(config: ICPConfig, match, work_points, work_mask, m_f,
               trim_ratio, solve, mesh=None, red_axis=None):
    """One iteration of the single-phase solve on explicit state:
    step(T, hist_t, hist_r) -> `_Step`. It transforms the reading, matches
    it (`match(p, mask)` -> (dist2, payload)), trims, builds and solves the
    normal equations with `solve(M, b)` -> (x, info), updates T and the
    DifferentialTransformationChecker's histories and computes its flag.
    It reads nothing back to the host itself: the only reads are those of
    `solve` and, degeneracy-aware, `eigh` and the shards' collectives
    (`red_axis` of `mesh`, reading mode)."""
    dev = work_points.device
    p2plane = config.error_metric == "point_to_plane"

    def preduce(*xs):
        """The shards' sums of `xs` in one `psum` (reading mode)."""
        return xs if red_axis is None else mesh.psum_many(xs, red_axis)
    degen = config.degeneracy_threshold > 0.0
    mmd2 = (float(np.float32(config.max_match_dist ** 2))
            if config.max_match_dist > 0.0 else None)
    eye6 = torch.eye(6, dtype=torch.float32, device=dev)

    def iteration(T):
        p = se3.transform_points(T, work_points)
        dist2, pout = match(p, work_mask)
        q = pout[:, :3]
        n = pout[:, 3:6] if p2plane else None
        matched = work_mask & (dist2 < _VALID_DIST)
        if config.trim_normal_space and n is not None:
            bucket = torch.argmax(torch.abs(n), dim=-1)
            tb = torch.stack([
                masked_quantile_hist(dist2, matched & (bucket == k),
                                     trim_ratio, axis_name=red_axis,
                                     mesh=mesh) for k in range(3)])
            if mmd2 is not None:
                tb = torch.clamp(tb, max=mmd2)
            thresh = tb[bucket]
        else:
            thresh = masked_quantile_hist(dist2, matched, trim_ratio,
                                          axis_name=red_axis, mesh=mesh)
            if mmd2 is not None:
                thresh = torch.clamp(thresh, max=mmd2)
        valid = (dist2 < _VALID_DIST).to(torch.float32)
        w = m_f * (dist2 <= thresh).to(torch.float32) * valid
        if degen:
            # observability from the UNTRIMMED matches, in a basis centred
            # on their centroid and scaled by their RMS radius
            w_u = m_f * valid
            su, sp = preduce(w_u.sum(), (p * w_u[:, None]).sum(0))
            wsum_u = torch.clamp(su, min=1.0)
            cen = sp / wsum_u
            (sr,) = preduce((w_u * ((p - cen) ** 2).sum(-1)).sum())
            r0 = torch.sqrt(torch.clamp(sr / wsum_u, min=1e-6))
        if p2plane:
            r = (n * (p - q)).sum(-1)
            J = torch.cat([n, torch.linalg.cross(p, n, dim=-1)], dim=-1)
            Jw = J * w[:, None]
            A = Jw.T @ J
            b = -(Jw.T @ r)
            if degen:
                Jc = torch.cat([n, torch.linalg.cross(p - cen, n, dim=-1)],
                               dim=-1)
                Ac = (Jc * w[:, None]).T @ Jc
                bc = -((Jc * w[:, None]).T @ r)
                Ac_u = (Jc * w_u[:, None]).T @ Jc
        else:
            rv = p - q
            eye3 = torch.eye(3, dtype=p.dtype, device=dev).expand(
                p.shape[0], 3, 3)
            Jp = torch.cat([eye3, -se3.skew(p)], dim=-1)       # (M, 3, 6)
            A = torch.einsum("mij,m,mik->jk", Jp, w, Jp)
            b = -torch.einsum("mij,m,mi->j", Jp, w, rv)
            r = torch.linalg.norm(rv, dim=-1)
            if degen:
                Jcp = torch.cat([eye3, -se3.skew(p - cen)], dim=-1)
                Ac = torch.einsum("mij,m,mik->jk", Jcp, w, Jcp)
                bc = -torch.einsum("mij,m,mi->j", Jcp, w, rv)
                Ac_u = torch.einsum("mij,m,mik->jk", Jcp, w_u, Jcp)
        # the shards' normal equations and the inlier sums, in one psum
        # (reading mode): every rank then solves the same system
        stats = None
        if red_axis is not None:
            stats = torch.stack([w.sum(), (w * r * r).sum()])
            if degen:
                A, b, Ac, bc, Ac_u, stats = preduce(A, b, Ac, bc, Ac_u, stats)
            else:
                A, b, stats = preduce(A, b, stats)
        if degen:
            # solution remapping in the scaled centred basis: the untrimmed
            # support picks the observable subspace, the trimmed system is
            # solved in it, suppressed components stay at the prior
            s = torch.cat([torch.ones(3, dtype=torch.float32, device=dev),
                           torch.ones(3, dtype=torch.float32,
                                      device=dev) / r0])
            As_u = Ac_u * s[:, None] * s[None, :]
            As = Ac * s[:, None] * s[None, :]
            with span("aicp.icp.solve_check"):
                evals_u, V = torch.linalg.eigh(As_u)
            keep = (evals_u > config.degeneracy_threshold).to(torch.float32)
            B = V.T @ As @ V
            lam_s = config.damping * torch.trace(B) / 6.0 + 1e-12
            Bm = (B * (keep[:, None] * keep[None, :])
                  + torch.diag(1.0 - keep) + lam_s * eye6)
            x, info = solve(Bm, keep * (V.T @ (bc * s)))
            dc = (V @ x) * s                                   # [v_c, w]
            wrot = dc[3:]
            delta = torch.cat([dc[:3] - torch.linalg.cross(wrot, cen,
                                                           dim=-1), wrot])
        else:
            lam = config.damping * torch.trace(A) / 6.0 + 1e-12
            delta, info = solve(A + lam * eye6, b)
        return delta, A, dist2, w, r, stats, info

    def step(T, hist_t, hist_r):
        delta, A, dist2, w, r, stats, info = iteration(T)
        T = se3.se3_exp(delta) @ T
        hist_t = torch.cat([torch.linalg.norm(delta[:3])[None], hist_t[:-1]])
        hist_r = torch.cat([torch.linalg.norm(delta[3:])[None], hist_r[:-1]])
        converged = ((hist_t.mean() < config.min_diff_trans)
                     & (hist_r.mean() < config.min_diff_rot))
        return _Step(T, hist_t, hist_r, converged, A, dist2, w, r, stats,
                     info)

    return step


def _graph_key(config: ICPConfig, inputs) -> tuple:
    """A captured solve's key (`utils.graphs.key`), a Python trim ratio as
    a float32 0-d."""
    trim_ratio = inputs[-1]
    ratio = (trim_ratio if isinstance(trim_ratio, torch.Tensor)
             else torch.empty((), dtype=torch.float32))
    tensors = [t for t in inputs[:5] if t is not None] + [ratio]
    return graphs.key(config, tensors, inputs[0].device)


def _graph_for(key, config: ICPConfig, inputs):
    """The captured solve of `key`, or None on the key's first call
    (`utils.graphs.lookup`)."""
    def make():
        rep = _Replay(config, inputs)
        rep.load(inputs)
        rep.capture()
        return rep

    return graphs.lookup(_graphs, key, make, GRAPH_KEYS)


def _warmed(key) -> None:
    graphs.warmed(_graphs, key, GRAPH_KEYS)


class _Replay:
    """A single-phase solve on K1 as one CUDA graph an iteration
    (`capture_plan`): static copies of the inputs, the solver's state (T,
    the checker's histories, the first failed solve's `info`), and `body`,
    one `_make_step` iteration with `_unchecked_solve` that writes the
    state back. `status` is the one value the host reads: bit 0 the
    checker's flag, bit 1 a failed solve in any iteration so far. `out`
    holds the last iteration's (hessian, match_dist2, inlier_mask,
    inlier_rms); a replay overwrites them in place."""

    def __init__(self, config: ICPConfig, inputs):
        (reading_points, reading_mask, reference_points, reference_normals,
         reference_mask, _, trim_ratio) = inputs
        dev = reading_points.device

        def like(t):
            return torch.empty(t.shape, dtype=t.dtype, device=dev)
        self.points, self.mask = like(reading_points), like(reading_mask)
        self.m_f = torch.empty(self.mask.shape, dtype=torch.float32,
                               device=dev)
        self.ref, self.ref_mask = like(reference_points), like(reference_mask)
        # `payload_rows`'s layout: [x y z, the normal point-to-plane, 0...]
        self.payload = torch.zeros((self.ref.shape[0], 8),
                                   dtype=torch.float32, device=dev)
        self.ratio = (like(trim_ratio) if isinstance(trim_ratio, torch.Tensor)
                      else torch.empty((), dtype=torch.float32, device=dev))
        S = config.smooth_length
        self.T = torch.empty((4, 4), dtype=torch.float32, device=dev)
        self.hist_t = torch.empty((S,), dtype=torch.float32, device=dev)
        self.hist_r = torch.empty((S,), dtype=torch.float32, device=dev)
        self.info = torch.zeros((), dtype=torch.int32, device=dev)
        self.status = torch.zeros((), dtype=torch.int32, device=dev)
        ref, ref_mask, payload = self.ref, self.ref_mask, self.payload

        def match(p, mask):
            return nn_payload_kernel(p, mask, ref, ref_mask, payload)

        self.step = _make_step(config, match, self.points, self.mask,
                               self.m_f, self.ratio, _unchecked_solve)
        self.graph = None
        self.out = None

    def load(self, inputs) -> None:
        """A call's inputs into the static buffers and the solver's start
        state, in stream order: no host read, no host wait."""
        (reading_points, reading_mask, reference_points, reference_normals,
         reference_mask, init_T, trim_ratio) = inputs
        self.points.copy_(reading_points)
        self.mask.copy_(reading_mask)
        self.m_f.copy_(reading_mask)
        self.ref.copy_(reference_points)
        self.ref_mask.copy_(reference_mask)
        self.payload[:, :3].copy_(reference_points)
        if reference_normals is not None:
            self.payload[:, 3:6].copy_(reference_normals)
        if isinstance(trim_ratio, torch.Tensor):
            self.ratio.copy_(trim_ratio)
        else:
            self.ratio.fill_(trim_ratio)
        self.T.copy_(init_T)
        self.hist_t.fill_(_BIG)
        self.hist_r.fill_(_BIG)
        self.info.zero_()

    def body(self) -> None:
        """One iteration on the static state: what the graph holds."""
        s = self.step(self.T, self.hist_t, self.hist_r)
        self.T.copy_(s.T)
        self.hist_t.copy_(s.hist_t)
        self.hist_r.copy_(s.hist_r)
        self.info.copy_(torch.where(self.info != 0, self.info, s.info))
        self.status.copy_(s.converged.to(torch.int32)
                          + 2 * (self.info != 0).to(torch.int32))
        wsum = torch.clamp(s.w.sum(), min=1.0)
        self.out = (s.A, s.dist2, s.w > 0,
                    torch.sqrt((s.w * s.r * s.r).sum() / wsum))

    def capture(self) -> None:
        """`body` as a CUDA graph (`utils.graphs.capture`)."""
        self.graph = graphs.capture(self.body, self.T.device)
        _count("captures")


def _replayed(rep: _Replay, config: ICPConfig, inputs) -> ICPResult:
    """The single-phase solve by `rep`'s graph: the eager loop's iterations
    and early exit, one replay (a span "aicp.icp.replay", one launch of K1)
    an iteration. From `smooth_length` on each iteration reads `status`
    (a span "aicp.icp.sync"), as the eager loop reads its flag; a run
    shorter than the history reads it once at its end. A failed solve
    raises the error `torch.linalg.solve` raises. The results are copies:
    the next call overwrites the graph's buffers."""
    rep.load(inputs)
    S, it = config.smooth_length, 0
    while it < config.max_iterations:
        with span("aicp.icp.replay"):
            rep.graph.replay()
        _count("replays")
        it += 1
        if it >= S or it == config.max_iterations:
            with span("aicp.icp.sync"):
                status = int(rep.status)
            if status & 2:
                torch._linalg_check_errors(rep.info, "torch.linalg.solve",
                                           is_matrix=True)
            if status & 1 and it >= S:
                break
    A, dist2, inliers, rms = rep.out
    return ICPResult(T=rep.T.clone(), n_iterations=it, inlier_rms=rms.clone(),
                     match_dist2=dist2.clone(), inlier_mask=inliers.clone(),
                     hessian=A.clone())


def _full_matcher(ref_points, ref_normals, ref_mask):
    """K1 (or its twin) over the whole reference: (p, mask) ->
    (dist2, payload)."""
    ref_points = ref_points.contiguous()
    ref_mask = ref_mask.contiguous()
    payload = payload_rows(ref_points, ref_normals)

    def match(p, mask):
        return nn_payload_kernel(p, mask, ref_points, ref_mask, payload)

    return match


def banded_band(M: int, N: int, nn_band: int = 0) -> int:
    """The banded matcher's window in reference blocks of 1024: `nn_band`,
    or when it is 0 the auto band max(8, 4 round(N / 2M)) — the expected
    query-tile bracket of ~N / 2M blocks with 4x margin for Morton-order
    discontinuities — clipped to the reference's N / 1024 blocks."""
    band = nn_band if nn_band > 0 else max(8, 4 * max(1, round(N / (2 * M))))
    return min(band, N // 1024)


def _global_matcher(match, mesh, axis: str, k: int):
    """`match` over a reference sharded in blocks along `axis` of `mesh`
    (JAX icp.py:392-404): the global nearest neighbour is the least of the
    blocks' distances (`pmin`), exact ties go to the lowest block (a `pmin`
    of the block index), and the winner's first `k` payload columns reach
    every rank by a `psum` over zeros elsewhere, summed as their bits so
    that the payload arrives exactly. Returns replicated (dist2, payload)."""
    me = mesh.index(axis)

    def reduced(p, mask):
        dist2, pout = match(p, mask)
        d_min = mesh.pmin(dist2, axis)
        sel = torch.where(dist2 <= d_min, me, 2 ** 30).to(torch.int32)
        mine = sel == mesh.pmin(sel, axis)
        bits = torch.where(mine[:, None], pout[:, :k].contiguous().view(
            torch.int32), 0)
        return d_min, mesh.psum(bits, axis).view(torch.float32)

    return reduced


def _banded_matcher(config, reading_points, reading_mask, ref_points,
                    ref_normals, ref_mask, init_T, mesh=None):
    """The Morton-banded matcher (JAX icp.py:297-372): the reference sorted
    once with its payload; the reading sorted once by its codes under
    `init_T` and solved in that order (every loop reduction is
    order-free); each iteration re-brackets the windows from the live
    codes. Returns (match, work_points, work_mask, inv_q) with inv_q the
    permutation back to the caller's order. With `mesh` (a reference
    sharded in blocks) the Morton origin is the blocks' `pmin`, so every
    rank sorts the reading alike and its rows align across blocks."""
    M, N = reading_points.shape[0], ref_points.shape[0]
    band = banded_band(M, N, config.nn_band)
    origin = torch.where(ref_mask[:, None], ref_points, 1e30).amin(0)
    if mesh is not None:
        origin = mesh.pmin(origin, config.axis_name)
    cell = config.nn_cell_size
    rs, rpen, rcodes_s, pay_s = banded_prepare_payload(
        ref_points, ref_mask, ref_normals, origin, cell)
    p0 = se3.transform_points(init_T.to(torch.float32), reading_points)
    qperm = torch.sort(morton_codes(p0, reading_mask, origin, cell),
                       stable=True).indices
    inv_q = torch.argsort(qperm)

    def match(p, mask):
        codes = morton_codes(p, mask, origin, cell)
        starts = banded_window_starts(codes, rcodes_s, N // 1024, band, 512,
                                      1024)
        dist2, pout = nn_payload_banded_stream_kernel(
            p.contiguous(), rs, rpen, pay_s, starts, band)
        return torch.where(mask, dist2, _BIG), pout

    return (match, reading_points[qperm].contiguous(),
            reading_mask[qperm].contiguous(), inv_q)


def degeneracy_predictions(hessian: torch.Tensor):
    """(degeneracy, inverse condition number) from the normalized
    translational eigenvalues of the ICP Hessian."""
    evals_t = torch.linalg.eigvalsh(hessian[:3, :3])
    total = torch.linalg.eigvalsh(hessian).sum()
    norm = evals_t / torch.clamp(total, min=1e-12)
    return norm.min() * 100.0, norm.min() / torch.clamp(norm.max(),
                                                        min=1e-12)


def clamp_trim_ratio(overlap_percent, lo: float = 0.25,
                     hi: float = 0.70):
    """Auto-tune rule: ratio = overlap / 100 clamped to [lo, hi]."""
    return torch.clamp(overlap_percent / 100.0, lo, hi)
