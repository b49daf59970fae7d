"""Plane-landmark bundle adjustment with a Schur complement, PyTorch port of
the single-device part of `aicp_mapping_tpu.parallel.ba`.

  - **Landmarks** are infinite world planes pi_j = (n_j, d_j), n.p = d.
  - **Observations** are body-frame planes (m_o, e_o) with weights, tying
    keyframe k to landmark j; under world_T_body T_k = (R_k, t_k) the
    prediction is m_hat = R_k^T n_j, e_hat = d_j - n_j . t_k.
  - **Gauss-Newton with Schur elimination**: the 4x4 landmark blocks are
    eliminated per block, the reduced (6K x 6K) pose system is solved
    densely (`torch.linalg.solve_ex` in FP32, as JAX solves it outside any
    kernel), landmark increments are back-substituted.

JAX takes the Jacobians from `jax.jacfwd` of `plane_residual` at the
identity perturbation (left-multiplicative se(3) on the pose, additive on
the plane); here they are written out (`_linearize`) and held to jacfwd's
in the tests. Block accumulations are one-hot products (`posegraph.
scatter_add`), so a solve gives the same bits on every run.
`optimize_plane_ba_sharded` shards the observations over a mesh axis: each
rank accumulates its shard's blocks and one `psum` per step sums them; the
reduced Schur solve runs replicated.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..geometry import se3
from .posegraph import _edge_terms, one_hot, scatter_add


@dataclasses.dataclass(frozen=True)
class PlaneBA:
    """Problem container (all fixed-capacity, mask-padded)."""

    poses: torch.Tensor          # (K, 4, 4) world_T_body
    landmarks: torch.Tensor      # (L, 4) world planes (nx, ny, nz, d), |n| = 1
    obs_k: torch.Tensor          # (O,) int64 keyframe index
    obs_l: torch.Tensor          # (O,) int64 landmark index
    obs_plane: torch.Tensor      # (O, 4) measured body-frame plane (m, e)
    obs_w: torch.Tensor          # (O,) weight
    obs_mask: torch.Tensor       # (O,) validity

    @property
    def n_poses(self) -> int:
        return self.poses.shape[0]

    @property
    def n_landmarks(self) -> int:
        return self.landmarks.shape[0]


def plane_residual(xi: torch.Tensor, dlm: torch.Tensor, T: torch.Tensor,
                   lm: torch.Tensor, meas: torch.Tensor) -> torch.Tensor:
    """4-vector residual of observations under perturbations (xi in se(3),
    left-multiplicative on T; dlm additive on the plane); batched."""
    Tp = se3.se3_exp(xi) @ T
    n = lm[..., :3] + dlm[..., :3]
    d = lm[..., 3] + dlm[..., 3]
    m_hat = torch.einsum("...ji,...j->...i", Tp[..., :3, :3], n)
    e_hat = d - (n * Tp[..., :3, 3]).sum(-1)
    return torch.cat([m_hat - meas[..., :3],
                      (e_hat - meas[..., 3])[..., None]], dim=-1)


def _linearize(T, lm, meas):
    """Residual + Jacobians at the current estimate, batched over leading
    dimensions: r (..., 4), Jp (..., 4, 6), Jl (..., 4, 4).

    With exp(xi) = I + [w]x, v to first order: m_hat = R^T n + R^T [n]x w
    and e_hat = d - n.t - n.v + (n x t).w; the plane enters as
    dm_hat/dn = R^T, de_hat/dn = -t, de_hat/dd = 1."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    n = lm[..., :3]
    Rt = R.transpose(-1, -2)
    r = torch.cat([torch.einsum("...ij,...j->...i", Rt, n) - meas[..., :3],
                   (lm[..., 3] - (n * t).sum(-1) - meas[..., 3])[..., None]],
                  dim=-1)
    zeros3 = torch.zeros_like(Rt)
    Jp = torch.cat([
        torch.cat([zeros3, Rt @ se3.skew(n)], dim=-1),
        torch.cat([-n, torch.linalg.cross(n, t, dim=-1)], dim=-1)[..., None, :],
    ], dim=-2)
    Jl = torch.cat([
        torch.cat([Rt, torch.zeros_like(n)[..., None]], dim=-1),
        torch.cat([-t, torch.ones_like(t[..., :1])], dim=-1)[..., None, :],
    ], dim=-2)
    return r, Jp, Jl


def _accumulate(poses, landmarks, obs_k, obs_l, obs_plane, obs_w, obs_mask,
                K: int, L: int, robust_sigma_n: float = 0.0,
                robust_sigma_e: float = 0.0, dtype=torch.float32):
    """Block accumulation. With `robust_sigma_n`/`robust_sigma_e` > 0 each
    observation is IRLS-reweighted by a Huber kernel on its normalized
    residual rho = sqrt(|r_n|^2/sigma_n^2 + r_e^2/sigma_e^2) (scale
    min(1, 1/rho)). Returns (Hpp (K,6,6), Hpl (K,L,6,4), Hll (L,4,4),
    gp (K,6), gl (L,4), chi2 scalar) in `dtype`. The per-observation terms
    are float32; they are summed in float64 and rounded once, so a sum over
    shards (in float64, then rounded) gives the blocks of the unsharded
    sum: in float32 the urban drive's reduced pose system turns the
    rounding of a different summation order into 2e-5 m of pose."""
    r, Jp, Jl = _linearize(poses[obs_k], landmarks[obs_l], obs_plane)
    w_eff = obs_w * obs_mask.to(torch.float32)
    if robust_sigma_n > 0.0 and robust_sigma_e > 0.0:
        rho = torch.sqrt((r[:, :3] ** 2).sum(1) / robust_sigma_n ** 2
                         + (r[:, 3] / robust_sigma_e) ** 2)
        w_eff = w_eff * torch.clamp(1.0 / torch.clamp(rho, min=1e-9),
                                    max=1.0)
    w = w_eff[:, None, None]

    A = torch.einsum("oab,oac->obc", Jp * w, Jp)     # (O, 6, 6)
    Bo = torch.einsum("oab,oac->obc", Jp * w, Jl)    # (O, 6, 4)
    C = torch.einsum("oab,oac->obc", Jl * w, Jl)     # (O, 4, 4)
    gp_o = -torch.einsum("oab,oa->ob", Jp * w, r)    # (O, 6)
    gl_o = -torch.einsum("oab,oa->ob", Jl * w, r)    # (O, 4)

    f64 = torch.float64
    sel_k = one_hot(torch.where(obs_mask, obs_k, K), K, f64)
    sel_l = one_hot(torch.where(obs_mask, obs_l, L), L, f64)
    sel_kl = one_hot(torch.where(obs_mask, obs_k * L + obs_l, K * L), K * L,
                     f64)
    Hpp = scatter_add(sel_k, A.to(f64))
    Hll = scatter_add(sel_l, C.to(f64))
    Hpl = scatter_add(sel_kl, Bo.to(f64)).reshape(K, L, 6, 4)
    gp = scatter_add(sel_k, gp_o.to(f64))
    gl = scatter_add(sel_l, gl_o.to(f64))
    chi2 = (w_eff * (r * r).sum(1)).to(f64).sum()
    return tuple(b.to(dtype) for b in (Hpp, Hpl, Hll, gp, gl, chi2))


def _graph_edge_blocks(poses, edges, edge_Z, edge_w, edge_mask, K: int,
                       robust_delta: float = 0.0):
    """Pose-graph edge contributions in the plane BA's LEFT-multiplicative
    pose parametrization: `posegraph._edge_terms` linearizes with a right
    perturbation, xi_R = Ad(T^-1) xi_L, so J_L = J_R Ad(T^-1). Returns
    dense (K, K, 6, 6) H and (K, 6) g."""
    r, Ji, Jj, w = _edge_terms(poses, edges, edge_Z, edge_w, edge_mask,
                               robust_delta)
    Ad_inv = se3.adjoint(se3.inverse(poses))             # (K, 6, 6)
    i, j = edges[:, 0], edges[:, 1]
    Ji = Ji @ Ad_inv[i]
    Jj = Jj @ Ad_inv[j]
    Hii = torch.einsum("eab,ea,eac->ebc", Ji, w, Ji)
    Hjj = torch.einsum("eab,ea,eac->ebc", Jj, w, Jj)
    Hij = torch.einsum("eab,ea,eac->ebc", Ji, w, Jj)
    gi = -torch.einsum("eab,ea->eb", Ji, w * r)
    gj = -torch.einsum("eab,ea->eb", Jj, w * r)
    cells = torch.cat([i * K + i, j * K + j, i * K + j, j * K + i])
    H = scatter_add(one_hot(cells, K * K),
                    torch.cat([Hii, Hjj, Hij, Hij.transpose(-1, -2)]))
    g = scatter_add(one_hot(torch.cat([i, j]), K), torch.cat([gi, gj]))
    return H.reshape(K, K, 6, 6), g


def _schur_step(poses, landmarks, blocks, lm_damping: float,
                pose_damping: float, gauge_weight: float,
                edge_blocks=None):
    """One GN step from accumulated blocks: Schur-eliminate landmarks,
    solve the reduced pose system, back-substitute. Gauge: pose 0 pinned by
    a strong prior on its diagonal block. `edge_blocks` (dense pose-pose H
    and gradient from `_graph_edge_blocks`) joins the reduced system."""
    Hpp, Hpl, Hll, gp, gl, _ = blocks
    K, L = Hpl.shape[0], Hpl.shape[1]
    dev = poses.device
    I4 = torch.eye(4, dtype=torch.float32, device=dev)
    I6 = torch.eye(6, dtype=torch.float32, device=dev)

    Hll_inv = torch.linalg.inv_ex(Hll + lm_damping * I4).inverse  # (L, 4, 4)
    W = torch.einsum("kjab,jbc->kjac", Hpl, Hll_inv)        # (K, L, 6, 4)
    S = -torch.einsum("kjab,mjcb->kmac", W, Hpl)            # (K, K, 6, 6)
    eyeK = torch.eye(K, dtype=torch.float32, device=dev)
    S = S + eyeK[:, :, None, None] * (Hpp + pose_damping * I6)[:, None]
    # gauge prior on pose 0
    e00 = torch.zeros((K, K, 1, 1), dtype=torch.float32, device=dev)
    e00[0, 0] = 1.0
    S = S + e00 * (gauge_weight * I6)
    rhs = gp - torch.einsum("kjab,jb->ka", W, gl)           # (K, 6)
    if edge_blocks is not None:
        He, ge = edge_blocks
        S = S + He
        rhs = rhs + ge
    S_f = S.permute(0, 2, 1, 3).reshape(K * 6, K * 6)
    xi = torch.linalg.solve_ex(S_f, rhs.reshape(K * 6, 1)).result.reshape(
        K, 6)

    # back-substitute landmarks: dl_j = Hll_inv (gl_j - sum_k B_kj^T xi_k)
    corr = torch.einsum("kjab,ka->jb", Hpl, xi)             # (L, 4)
    dl = torch.einsum("jab,jb->ja", Hll_inv, gl - corr)

    new_poses = se3.se3_exp(xi) @ poses
    lm = landmarks + dl
    norm = torch.clamp(torch.linalg.norm(lm[:, :3], dim=1, keepdim=True),
                       min=1e-9)
    return new_poses, torch.cat([lm[:, :3] / norm, lm[:, 3:] / norm], dim=1)


def optimize_plane_ba(problem: PlaneBA, gn_iters: int = 6,
                      lm_damping: float = 1e-4, pose_damping: float = 1e-6,
                      gauge_weight: float = 1e6,
                      robust_sigma_n: float = 0.0,
                      robust_sigma_e: float = 0.0,
                      graph_edges=None, graph_Z=None, graph_w=None,
                      graph_mask=None, edge_robust_delta: float = 0.0):
    """Single-device plane BA, optionally JOINT with pose-graph edges
    (odometry + loop closures, see `_graph_edge_blocks`). Returns (poses,
    landmarks, chi2 at the last step's linearization point); reads nothing
    back to the host."""
    return _gauss_newton(problem, gn_iters, lm_damping, pose_damping,
                         gauge_weight, robust_sigma_n, robust_sigma_e,
                         (graph_edges, graph_Z, graph_w, graph_mask),
                         edge_robust_delta, lambda blocks: blocks)


def optimize_plane_ba_sharded(problem: PlaneBA, mesh, axis: str = "graph",
                              gn_iters: int = 6, lm_damping: float = 1e-4,
                              pose_damping: float = 1e-6,
                              gauge_weight: float = 1e6,
                              robust_sigma_n: float = 0.0,
                              robust_sigma_e: float = 0.0,
                              graph_edges=None, graph_Z=None, graph_w=None,
                              graph_mask=None,
                              edge_robust_delta: float = 0.0):
    """The solve of `optimize_plane_ba` with the observations sharded over
    `mesh`'s `axis`: every rank of the mesh calls it with the whole problem
    (pad with `pad_observations` so O divides evenly), accumulates its
    shard's H/g blocks, and one `psum` per step sums them; the reduced
    (6K x 6K) Schur solve, the state update and the pose-graph edge blocks
    run replicated. Returns (poses, landmarks, chi2_final) on every
    rank."""
    rows = mesh.shard(problem.obs_k.shape[0], axis)
    dev = mesh.device

    def on(t):
        return t[rows].to(dev).contiguous()

    local = PlaneBA(problem.poses.to(dev), problem.landmarks.to(dev),
                    on(problem.obs_k), on(problem.obs_l),
                    on(problem.obs_plane), on(problem.obs_w),
                    on(problem.obs_mask))
    edges = tuple(None if t is None else t.to(dev)
                  for t in (graph_edges, graph_Z, graph_w, graph_mask))
    return _gauss_newton(local, gn_iters, lm_damping, pose_damping,
                         gauge_weight, robust_sigma_n, robust_sigma_e, edges,
                         edge_robust_delta,
                         lambda blocks: mesh.psum_many(blocks, axis))


def _gauss_newton(problem: PlaneBA, gn_iters, lm_damping, pose_damping,
                  gauge_weight, robust_sigma_n, robust_sigma_e, graph,
                  edge_robust_delta, reduce):
    """The Gauss-Newton loop over `problem`'s observations, with `reduce`
    summing the accumulated blocks over the observation shards (the
    identity on one device)."""
    K, L = problem.n_poses, problem.n_landmarks
    poses, lms = problem.poses, problem.landmarks
    chi2 = None
    for _ in range(gn_iters):
        blocks = [b.to(torch.float32) for b in reduce(_accumulate(
            poses, lms, problem.obs_k, problem.obs_l, problem.obs_plane,
            problem.obs_w, problem.obs_mask, K, L, robust_sigma_n,
            robust_sigma_e, torch.float64))]
        eb = None
        if graph[0] is not None:
            eb = _graph_edge_blocks(poses, *graph, K, edge_robust_delta)
        poses, lms = _schur_step(poses, lms, blocks, lm_damping,
                                 pose_damping, gauge_weight, eb)
        chi2 = blocks[5]
    return poses, lms, chi2


def pad_observations(problem: PlaneBA, multiple: int) -> PlaneBA:
    """Pad the observation arrays so O % multiple == 0 (masked-out pads)."""
    pad = (-problem.obs_k.shape[0]) % multiple
    if pad == 0:
        return problem

    def z(x):
        return torch.cat([x, torch.zeros((pad,) + x.shape[1:], dtype=x.dtype,
                                         device=x.device)])

    return dataclasses.replace(
        problem, obs_k=z(problem.obs_k), obs_l=z(problem.obs_l),
        obs_plane=z(problem.obs_plane), obs_w=z(problem.obs_w),
        obs_mask=z(problem.obs_mask))


# ---------------------------------------------------------------------------
# Front-end helpers: planes from keyframe clouds -> BA observations
# ---------------------------------------------------------------------------

def extract_planes(points: torch.Tensor, mask: torch.Tensor,
                   normals: torch.Tensor, curvature: torch.Tensor,
                   max_planes: int = 16, min_points: int = 50):
    """Per-cloud plane extraction: Hough plane binning + per-cluster
    moments. Returns (planes (max_planes, 4) [n, d] with n.p = d, weights
    (max_planes,) = point counts, valid (max_planes,)) in the cloud's own
    frame."""
    from ..ops.segmentation import compact_labels, hough_plane_labels

    labels = hough_plane_labels(points, mask, normals, curvature)
    comp, valid_c, _ = compact_labels(labels, mask, max_planes)
    sel = one_hot(torch.where(comp >= 0, comp, max_planes), max_planes)
    w = mask.to(torch.float32)[:, None]
    sums = scatter_add(sel, torch.cat([w, points * w, normals * w], dim=1))
    cnt = sums[:, 0]
    cent = sums[:, 1:4] / torch.clamp(cnt[:, None], min=1.0)
    nsum = sums[:, 4:7]
    nrm = nsum / torch.clamp(torch.linalg.norm(nsum, dim=1, keepdim=True),
                             min=1e-9)
    planes = torch.cat([nrm, (nrm * cent).sum(1, keepdim=True)], dim=1)
    return planes, cnt, valid_c & (cnt >= min_points)


def transform_plane(T: torch.Tensor, plane: torch.Tensor) -> torch.Tensor:
    """Body-frame plane (m, e) -> world plane (n, d) under world_T_body T:
    n = R m, d = e + n . t."""
    n = T[..., :3, :3] @ plane[..., :3, None]
    n = n[..., 0]
    d = plane[..., 3] + (n * T[..., :3, 3]).sum(-1)
    return torch.cat([n, d[..., None]], dim=-1)


def build_plane_ba(keyframe_poses, keyframe_planes, keyframe_weights,
                   keyframe_valid, angle_thresh_deg: float = 10.0,
                   dist_thresh: float = 0.3,
                   reject_normal_deg: float = 0.0,
                   reject_offset_m: float = 0.0,
                   min_obs_per_landmark: int = 1, device="cuda") -> PlaneBA:
    """Associate per-keyframe body-frame planes into world landmarks and
    assemble a PlaneBA problem on `device` (host-side greedy association,
    once per back-end invocation; the card by default, `device="cpu"` to
    run on the CPU).

    keyframe_poses: (K, 4, 4); keyframe_planes: (K, P, 4) body frame;
    keyframe_weights: (K, P); keyframe_valid: (K, P) bool (numpy).

    Planes match a landmark by |angle| and offset, the observation flipped
    to the landmark's orientation ((n, d) and (-n, -d) are one plane).
    `reject_normal_deg`/`reject_offset_m` > 0 enable the chi^2 consensus
    gate: a landmark whose world-frame observations disagree by more than
    these bounds is dropped with all its observations;
    `min_obs_per_landmark=2` also drops single-observation landmarks."""
    from ..pipeline.app import check_device

    device = check_device(device, "build_plane_ba")
    poses = np.asarray(keyframe_poses, np.float32)
    planes = np.asarray(keyframe_planes, np.float32)
    weights = np.asarray(keyframe_weights, np.float32)
    valid = np.asarray(keyframe_valid, bool)
    K, Pn = planes.shape[0], planes.shape[1]
    cos_t = np.cos(np.deg2rad(angle_thresh_deg))
    world = transform_plane(torch.from_numpy(poses)[:, None],
                            torch.from_numpy(planes)).numpy()   # (K, P, 4)

    lms: list[np.ndarray] = []
    lm_world_obs: list[list[np.ndarray]] = []  # flip-corrected world planes
    obs_k, obs_l, obs_plane, obs_w = [], [], [], []
    for k in range(K):
        for p in range(Pn):
            if not valid[k, p]:
                continue
            body = planes[k, p]
            wpl = world[k, p]
            match = -1
            flip = 1.0
            for j, lm in enumerate(lms):
                dot = float(np.dot(lm[:3], wpl[:3]))
                s = 1.0 if dot >= 0 else -1.0
                if (abs(dot) >= cos_t
                        and abs(float(lm[3] - s * wpl[3])) <= dist_thresh):
                    match = j
                    flip = s
                    break
            if match < 0:
                lms.append(wpl)
                lm_world_obs.append([])
                match = len(lms) - 1
            obs_k.append(k)
            obs_l.append(match)
            obs_plane.append(flip * body)
            obs_w.append(float(weights[k, p]))
            lm_world_obs[match].append(flip * wpl)

    # chi^2 consensus gate + singleton drop
    keep = np.ones((len(lms),), bool)
    for j, wobs in enumerate(lm_world_obs):
        if len(wobs) < min_obs_per_landmark:
            keep[j] = False
            continue
        if reject_normal_deg <= 0.0 or reject_offset_m <= 0.0:
            continue
        W = np.stack(wobs)
        n_mean = W[:, :3].mean(axis=0)
        n_mean /= max(np.linalg.norm(n_mean), 1e-9)
        worst_cos = float(np.min(W[:, :3] @ n_mean))
        spread_d = float(W[:, 3].max() - W[:, 3].min())
        if (worst_cos < np.cos(np.deg2rad(reject_normal_deg))
                or spread_d > reject_offset_m):
            keep[j] = False
    if keep.any() and not keep.all():
        remap = -np.ones((len(lms),), np.int64)
        remap[np.flatnonzero(keep)] = np.arange(int(keep.sum()))
        sel = [i for i, l in enumerate(obs_l) if keep[l]]
        obs_k = [obs_k[i] for i in sel]
        obs_l = [int(remap[obs_l[i]]) for i in sel]
        obs_plane = [obs_plane[i] for i in sel]
        obs_w = [obs_w[i] for i in sel]
        lms = [lm for lm, k_ in zip(lms, keep) if k_]

    if not lms or not obs_k:
        raise ValueError("no valid planes to build a BA problem from")

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    return PlaneBA(
        poses=t(poses), landmarks=t(np.stack(lms)),
        obs_k=t(obs_k, torch.int64), obs_l=t(obs_l, torch.int64),
        obs_plane=t(np.stack(obs_plane)), obs_w=t(obs_w),
        obs_mask=torch.ones((len(obs_k),), dtype=torch.bool, device=device))
