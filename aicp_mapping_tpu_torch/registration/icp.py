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
and the final-iteration statistics are those of the while_loop.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..geometry import se3
from ..ops.banded_nn import (banded_prepare_payload, banded_window_starts,
                             morton_codes, nn_payload_banded_stream_kernel,
                             payload_rows)
from ..ops.knn import nn_payload_kernel
from ..ops.quantile import masked_quantile_hist

_BIG = 3.4e38
# Validity guard for NN distances: far below the no-match sentinel.
_VALID_DIST = 1e30


@dataclasses.dataclass(frozen=True)
class ICPConfig:
    """Static solver configuration — the fields and defaults of the JAX
    `ICPConfig` (see its docstrings for each field's meaning).

    `use_pallas` only selects a TPU kernel in JAX and is ignored here: the
    matcher is chosen by `solver_plan`. `axis_name` (SPMD) is not ported
    yet and raises."""

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


def point_to_plane_icp(reading_points: torch.Tensor,
                       reading_mask: torch.Tensor,
                       reference_points: torch.Tensor,
                       reference_normals: torch.Tensor,
                       reference_mask: torch.Tensor,
                       init_T: torch.Tensor,
                       trim_ratio,
                       config: ICPConfig = ICPConfig()) -> ICPResult:
    """Trimmed point-to-plane ICP; returns the correction T with
    aligned = T @ reading. `trim_ratio` is a 0-d tensor (or float)."""
    if config.axis_name is not None:
        raise NotImplementedError(
            "ICPConfig.axis_name: distributed ICP is ROADMAP Q1 #13")
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
            reference_normals, reference_mask, init_T, trim_ratio, ccfg)
        fcfg = dataclasses.replace(
            config, coarse_iterations=0,
            max_iterations=max(config.max_iterations
                               - config.coarse_iterations, 1),
            smooth_length=min(config.smooth_length, 2))
        fine = point_to_plane_icp(
            reading_points, reading_mask, reference_points,
            reference_normals, reference_mask, coarse.T, trim_ratio, fcfg)
        return dataclasses.replace(
            fine, n_iterations=fine.n_iterations + coarse.n_iterations)

    dev = reading_points.device
    p2plane = config.error_metric == "point_to_plane"
    if config.error_metric not in ("point_to_plane", "point_to_point"):
        raise ValueError(f"unknown error_metric {config.error_metric!r}")
    ref_normals = reference_normals if p2plane else None
    if plan["nn"] == "banded":
        match, work_points, work_mask, inv_q = _banded_matcher(
            config, reading_points, reading_mask, reference_points,
            ref_normals, reference_mask, init_T)
    else:
        match = _full_matcher(reference_points, ref_normals, reference_mask)
        work_points, work_mask = reading_points, reading_mask.contiguous()
        inv_q = None
    m_f = work_mask.to(torch.float32)
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
                                     trim_ratio) for k in range(3)])
            if mmd2 is not None:
                tb = torch.clamp(tb, max=mmd2)
            thresh = tb[bucket]
        else:
            thresh = masked_quantile_hist(dist2, matched, trim_ratio)
            if mmd2 is not None:
                thresh = torch.clamp(thresh, max=mmd2)
        valid = (dist2 < _VALID_DIST).to(torch.float32)
        w = m_f * (dist2 <= thresh).to(torch.float32) * valid
        if degen:
            # observability from the UNTRIMMED matches, in a basis centred
            # on their centroid and scaled by their RMS radius
            w_u = m_f * valid
            wsum_u = torch.clamp(w_u.sum(), min=1.0)
            cen = (p * w_u[:, None]).sum(0) / wsum_u
            r0 = torch.sqrt(torch.clamp(
                (w_u * ((p - cen) ** 2).sum(-1)).sum() / wsum_u, min=1e-6))
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
        if degen:
            # solution remapping in the scaled centred basis: the untrimmed
            # support picks the observable subspace, the trimmed system is
            # solved in it, suppressed components stay at the prior
            s = torch.cat([torch.ones(3, dtype=torch.float32, device=dev),
                           torch.ones(3, dtype=torch.float32,
                                      device=dev) / r0])
            As_u = Ac_u * s[:, None] * s[None, :]
            As = Ac * s[:, None] * s[None, :]
            evals_u, V = torch.linalg.eigh(As_u)
            keep = (evals_u > config.degeneracy_threshold).to(torch.float32)
            B = V.T @ As @ V
            lam_s = config.damping * torch.trace(B) / 6.0 + 1e-12
            Bm = (B * (keep[:, None] * keep[None, :])
                  + torch.diag(1.0 - keep) + lam_s * eye6)
            x = torch.linalg.solve(Bm, keep * (V.T @ (bc * s)))
            dc = (V @ x) * s                                   # [v_c, w]
            wrot = dc[3:]
            delta = torch.cat([dc[:3] - torch.linalg.cross(wrot, cen,
                                                           dim=-1), wrot])
        else:
            lam = config.damping * torch.trace(A) / 6.0 + 1e-12
            delta = torch.linalg.solve(A + lam * eye6, b)
        return delta, A, dist2, w, r

    S = config.smooth_length
    T = init_T.to(torch.float32)
    hist_t = torch.full((S,), _BIG, dtype=torch.float32, device=dev)
    hist_r = torch.full((S,), _BIG, dtype=torch.float32, device=dev)
    A = torch.zeros((6, 6), dtype=torch.float32, device=dev)
    dist2 = torch.full((M,), _BIG, dtype=torch.float32, device=dev)
    w = torch.zeros((M,), dtype=torch.float32, device=dev)
    r = torch.zeros((M,), dtype=torch.float32, device=dev)
    it = 0
    while it < config.max_iterations:
        delta, A, dist2, w, r = iteration(T)
        T = se3.se3_exp(delta) @ T
        hist_t = torch.cat([torch.linalg.norm(delta[:3])[None], hist_t[:-1]])
        hist_r = torch.cat([torch.linalg.norm(delta[3:])[None], hist_r[:-1]])
        it += 1
        # DifferentialTransformationChecker, once its history is full: one
        # scalar read per iteration
        if it >= S and bool((hist_t.mean() < config.min_diff_trans)
                            & (hist_r.mean() < config.min_diff_rot)):
            break

    wsum = torch.clamp(w.sum(), min=1.0)
    inlier_rms = torch.sqrt((w * r * r).sum() / wsum)
    if inv_q is not None:
        # per-point outputs back to the caller's reading order
        dist2, w = dist2[inv_q], w[inv_q]
    return ICPResult(T=T, n_iterations=it, inlier_rms=inlier_rms,
                     match_dist2=dist2, inlier_mask=w > 0, hessian=A)


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


def _banded_matcher(config, reading_points, reading_mask, ref_points,
                    ref_normals, ref_mask, init_T):
    """The Morton-banded matcher (JAX icp.py:297-372): the reference sorted
    once with its payload; the reading sorted once by its codes under
    `init_T` and solved in that order (every loop reduction is
    order-free); each iteration re-brackets the windows from the live
    codes. Returns (match, work_points, work_mask, inv_q) with inv_q the
    permutation back to the caller's order."""
    M, N = reading_points.shape[0], ref_points.shape[0]
    band = banded_band(M, N, config.nn_band)
    origin = torch.where(ref_mask[:, None], ref_points, 1e30).amin(0)
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
