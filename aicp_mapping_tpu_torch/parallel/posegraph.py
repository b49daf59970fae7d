"""Pose-graph optimization (Gauss-Newton over SE(3)), PyTorch port of the
single-device part of `aicp_mapping_tpu.parallel.posegraph`.

Residual convention (right perturbation, [v, w] twist ordering):
    r_e = Log( Z_e^{-1} · T_i^{-1} · T_j )
    dr/dxi_j =  Jr^{-1}(r)
    dr/dxi_i = -Jr^{-1}(r) · Ad(T_j^{-1} T_i)
with Jr^{-1}(r) expanded to second order. Node 0 is gauge-fixed.

Every node-indexed scatter-add is a product with a one-hot (nodes x edges)
matrix, so a solve gives the same bits on every run (float atomics, as
`index_add_` uses on CUDA, do not). The JAX solver runs its PCG as a device
`while_loop` inside a `scan` over Gauss-Newton steps; here both loops run
their fixed lengths with no host read: a CG iteration whose residual is
already below the tolerance leaves the state as it was, which is what the
`while_loop` computes. `optimize_pose_graph_sharded` is the same solve with
the edges sharded over a mesh axis: each rank's node-indexed sums (b, the
diagonal blocks, chi^2, every PCG mat-vec) are `psum`-reduced.

`optimize_pose_graph` solves in float64 on every device and returns the
input's dtype. In float32 (JAX's precision) the Gauss-Newton iterates of a
stiff graph do not settle: on the urban drive's first-round graph (17
keyframes, closure information up to ~15x the odometry's) chi^2 wanders
between 100.7 and 104.8 from step to step and a one-ulp change of the
input poses moves the solution by 5-9 mm, so two devices' float32 answers
differ by as much. In float64 the same solve converges in three steps and
a one-ulp input change moves it by < 10 um.
"""
from __future__ import annotations

import dataclasses

import torch

from ..geometry import se3


def one_hot(idx: torch.Tensor, n: int,
            dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(n, E) selection matrix of `idx` (E,); ids outside [0, n) select
    nothing."""
    return (idx[None, :] == torch.arange(n, device=idx.device)[:, None]
            ).to(dtype)


def scatter_add(sel: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """`jax.ops.segment_sum` of `values` (E, ...) by a `one_hot` (n, E):
    one matrix product with exact products and a fixed summation order."""
    flat = values.reshape(values.shape[0], -1)
    return (sel @ flat).reshape((sel.shape[0],) + values.shape[1:])


def _ad(xi: torch.Tensor) -> torch.Tensor:
    """adjoint (little ad) of a twist [v, w]: (..., 6, 6)."""
    sw = se3.skew(xi[..., 3:])
    sv = se3.skew(xi[..., :3])
    top = torch.cat([sw, sv], dim=-1)
    bot = torch.cat([torch.zeros_like(sw), sw], dim=-1)
    return torch.cat([top, bot], dim=-2)


def _jr_inv(r: torch.Tensor) -> torch.Tensor:
    """Inverse right Jacobian of SE(3), 2nd-order: I + ad(r)/2 + ad(r)^2/12."""
    a = _ad(r)
    eye = torch.eye(6, dtype=r.dtype, device=r.device).expand(a.shape)
    return eye + 0.5 * a + (1.0 / 12.0) * (a @ a)


@dataclasses.dataclass(frozen=True)
class PoseGraph:
    poses: torch.Tensor          # (K, 4, 4)
    edges: torch.Tensor          # (E, 2) int64 — (i, j)
    measurements: torch.Tensor   # (E, 4, 4) — Z_ij = expected T_i^{-1} T_j
    weights: torch.Tensor        # (E, 6) diagonal information [v, w]
    edge_mask: torch.Tensor      # (E,) bool

    @property
    def n_poses(self) -> int:
        return self.poses.shape[0]

    @property
    def n_edges(self) -> int:
        return self.edges.shape[0]


def make_odometry_edges(poses: torch.Tensor, weight_t: float = 100.0,
                        weight_r: float = 400.0):
    """Chain edges from consecutive poses: Z = T_i^{-1} T_{i+1}."""
    K = poses.shape[0]
    i = torch.arange(K - 1, device=poses.device)
    Z = se3.inverse(poses[:-1]) @ poses[1:]
    w = torch.tensor([weight_t] * 3 + [weight_r] * 3, dtype=torch.float32,
                     device=poses.device).repeat(K - 1, 1)
    return torch.stack([i, i + 1], dim=1), Z, w


def _edge_terms(poses, edges, measurements, weights, edge_mask,
                robust_delta: float = 0.0):
    """Per-edge residual, Jacobians and weights; `robust_delta` > 0 scales
    an edge whose weighted residual norm exceeds it by delta / |r|_w (Huber
    IRLS, re-evaluated every GN iteration)."""
    Ti = poses[edges[:, 0]]
    Tj = poses[edges[:, 1]]
    A = se3.inverse(measurements) @ se3.inverse(Ti) @ Tj
    r = se3.se3_log(A)                                   # (E, 6)
    Jri = _jr_inv(r)                                     # (E, 6, 6)
    Adji = se3.adjoint(se3.inverse(Tj) @ Ti)
    Ji = -Jri @ Adji
    w = torch.where(edge_mask[:, None], weights, 0.0)    # (E, 6)
    if robust_delta > 0.0:
        chi = torch.sqrt(torch.clamp((w * r * r).sum(1), min=1e-12))
        w = w * torch.clamp(robust_delta / chi, max=1.0)[:, None]
    return r, Ji, Jri, w


def _edge_reduce(poses, edges, measurements, weights, edge_mask, n_poses,
                 robust_delta: float = 0.0, sel=None):
    """Gradient b, block-diagonal of H, and edge terms for CG matvecs.
    `sel` is the (one_hot(i), one_hot(j)) pair of the edges, when built."""
    if sel is None:
        sel = (one_hot(edges[:, 0], n_poses), one_hot(edges[:, 1], n_poses))
    r, Ji, Jj, w = _edge_terms(poses, edges, measurements, weights,
                               edge_mask, robust_delta)
    wr = w * r
    b = (scatter_add(sel[0], torch.einsum("eab,ea->eb", Ji, wr))
         + scatter_add(sel[1], torch.einsum("eab,ea->eb", Jj, wr)))
    Hdiag = (scatter_add(sel[0], torch.einsum("eab,ea,eac->ebc", Ji, w, Ji))
             + scatter_add(sel[1],
                           torch.einsum("eab,ea,eac->ebc", Jj, w, Jj)))
    chi2 = (w * r * r).sum()
    return b, Hdiag, (r, Ji, Jj, w), chi2


def _matvec(x, edges, Ji, Jj, w, n_poses, sel=None):
    """y = H x using edge-local products + scatter-add."""
    if sel is None:
        sel = (one_hot(edges[:, 0], n_poses), one_hot(edges[:, 1], n_poses))
    z = (torch.einsum("eab,eb->ea", Ji, x[edges[:, 0]])
         + torch.einsum("eab,eb->ea", Jj, x[edges[:, 1]])) * w
    return (scatter_add(sel[0], torch.einsum("eab,ea->eb", Ji, z))
            + scatter_add(sel[1], torch.einsum("eab,ea->eb", Jj, z)))


def _gauge_fix(x):
    return torch.cat([torch.zeros_like(x[:1]), x[1:]])


def optimize_pose_graph(graph: PoseGraph, gn_iters: int = 8,
                        cg_iters: int = 48, damping: float = 1e-6,
                        robust_delta: float = 0.0):
    """Single-device Gauss-Newton + block-Jacobi PCG, in float64 (module
    docstring). Returns (optimized poses (K, 4, 4), chi2 history
    (gn_iters + 1,)) in the input's dtype; reads nothing back to the
    host."""
    return _gauss_newton(graph, gn_iters, cg_iters, damping, robust_delta,
                         lambda *xs: xs)


def optimize_pose_graph_sharded(graph: PoseGraph, mesh, axis: str = "edges",
                                gn_iters: int = 8, cg_iters: int = 48,
                                damping: float = 1e-6,
                                robust_delta: float = 0.0):
    """The solve of `optimize_pose_graph` with the edges sharded over
    `mesh`'s `axis` and the poses replicated: every rank of the mesh calls
    it with the whole graph and keeps its rows of the edges; b, the
    diagonal blocks and chi^2 take one `psum` per Gauss-Newton step and
    each PCG mat-vec one more. Requires n_edges % axis size == 0 (pad with
    `pad_edges`). Returns (poses, chi2 history) on every rank."""
    rows = mesh.shard(graph.n_edges, axis)

    def on(t):
        return t[rows].to(mesh.device).contiguous()

    local = PoseGraph(graph.poses.to(mesh.device), on(graph.edges),
                      on(graph.measurements), on(graph.weights),
                      on(graph.edge_mask))

    return _gauss_newton(local, gn_iters, cg_iters, damping, robust_delta,
                         lambda *xs: mesh.psum_many(xs, axis))


def _gauss_newton(graph: PoseGraph, gn_iters: int, cg_iters: int,
                  damping: float, robust_delta: float, reduce):
    """The Gauss-Newton + PCG loop over `graph`'s edges, with `reduce`
    summing node-indexed tensors over the edge shards (the identity on one
    device)."""
    K = graph.n_poses
    dev = graph.poses.device
    f64 = torch.float64
    edges = graph.edges
    sel = (one_hot(edges[:, 0], K, f64), one_hot(edges[:, 1], K, f64))
    eye6 = torch.eye(6, dtype=f64, device=dev)
    args = (edges, graph.measurements.to(f64), graph.weights.to(f64),
            graph.edge_mask, K, robust_delta, sel)
    poses = graph.poses.to(f64)
    chi2s = []
    for _ in range(gn_iters):
        b, Hdiag, (_, Ji, Jj, w), chi2 = _edge_reduce(poses, *args)
        b, Hdiag, chi2 = reduce(b, Hdiag, chi2)
        lam = damping * (1.0 + torch.diagonal(Hdiag, dim1=-2,
                                              dim2=-1).sum(-1).mean())
        Minv = torch.linalg.inv_ex(Hdiag + lam * eye6).inverse

        def A(x):
            (hx,) = reduce(_matvec(x, edges, Ji, Jj, w, K, sel))
            return _gauge_fix(hx + lam * x)

        def apply_M(x):
            return _gauge_fix(torch.einsum("kab,kb->ka", Minv, x))

        # PCG for H dx = -b; `live` is the while_loop's condition
        rr = _gauge_fix(-b)
        x = torch.zeros((K, 6), dtype=poses.dtype, device=dev)
        p = zz = apply_M(rr)
        live = torch.ones((), dtype=torch.bool, device=dev)
        for _ in range(cg_iters):
            live = live & ((rr * rr).sum() > 1e-14)
            Ap = A(p)
            rz = (rr * zz).sum()
            alpha = rz / torch.clamp((p * Ap).sum(), min=1e-20)
            rr_new = rr - alpha * Ap
            zz_new = apply_M(rr_new)
            beta = (rr_new * zz_new).sum() / torch.clamp(rz, min=1e-20)
            x = torch.where(live, x + alpha * p, x)
            p = torch.where(live, zz_new + beta * p, p)
            rr = torch.where(live, rr_new, rr)
            zz = torch.where(live, zz_new, zz)
        poses = poses @ se3.se3_exp(x)
        chi2s.append(chi2)
    chi2s.append(reduce(_edge_reduce(poses, *args)[3])[0])
    dtype = graph.poses.dtype
    return poses.to(dtype), torch.stack(chi2s).to(dtype)


def pad_edges(edges, measurements, weights, multiple: int):
    """Pad the edge set to a multiple (masked) for even sharding."""
    E = edges.shape[0]
    pad = -(-E // multiple) * multiple - E
    dev = edges.device
    mask = torch.cat([torch.ones((E,), dtype=torch.bool, device=dev),
                      torch.zeros((pad,), dtype=torch.bool, device=dev)])
    edges = torch.cat([edges, torch.zeros((pad, 2), dtype=edges.dtype,
                                          device=dev)])
    measurements = torch.cat([
        measurements, torch.eye(4, dtype=measurements.dtype,
                                device=dev).repeat(pad, 1, 1)])
    weights = torch.cat([weights, torch.zeros((pad, 6), dtype=weights.dtype,
                                              device=dev)])
    return edges, measurements, weights, mask
