"""Pose-graph-backed SLAM mapper: AICP front-end + back-end, PyTorch port of
`aicp_mapping_tpu.pipeline.mapper` on a single device.

  1. the AICP pipeline (`App`) runs as the odometry front-end;
  2. every reference cloud is a keyframe;
  3. loop closures between non-adjacent keyframes are proposed by
     occupancy overlap, ranked, and verified in the relative frame by a
     degeneracy-aware trimmed point-to-plane ICP (K1 on the card), with a
     structural 1-D correlation along the weak direction (`_corr_peaks`,
     numpy as in JAX);
  4. the keyframe pose graph is optimized by Gauss-Newton with Huber
     edges and consistency rejection; plane BA may refine it jointly with
     the graph's edges; the map is rebuilt.

The back-end runs on the App's device. It reads the device only where a
value decides what runs next (a closure gate, the correlation search, the
consistency test, BA's trust region) and counts those reads
(`backend_counts`).

With a mesh (`PoseGraphMapper(app, mesh=..., mesh_axis=...)`) the PGO is
edge-sharded and the plane BA observation-sharded over the mesh axis. The
mapper runs on rank 0 (with its App) and `send`s each solve to the other
ranks, which wait in `serve_backend`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..cloud import Cloud
from ..ops.normals import radius_normals
from ..overlap.voxel_overlap import compute_overlap
from ..parallel.posegraph import (PoseGraph, optimize_pose_graph,
                                  optimize_pose_graph_sharded, pad_edges)
from ..registration.icp import clamp_trim_ratio, point_to_plane_icp

# Back-end work since the last reset: candidate pairs registered, ICP calls
# (closure verification and re-polish) and reads of device values back to
# the host.
_counts = {"candidates": 0, "icp_calls": 0, "host_reads": 0}


def backend_counts() -> dict:
    return dict(_counts)


def reset_backend_counts() -> None:
    _counts.update(candidates=0, icp_calls=0, host_reads=0)


def _read(*tensors) -> list:
    """One device-to-host read of `tensors` (f32 or bool) as numpy arrays."""
    _counts["host_reads"] += 1
    flat = torch.cat([t.reshape(-1).to(torch.float32) for t in tensors])
    host = flat.cpu().numpy()
    out, at = [], 0
    for t in tensors:
        a = host[at:at + t.numel()].reshape(t.shape)
        out.append(a > 0.5 if t.dtype == torch.bool else a)
        at += t.numel()
    return out


@dataclasses.dataclass
class Keyframe:
    index: int                  # graph cloud index in the App
    utime: int
    pose: np.ndarray            # (4, 4) corrected world pose
    cloud: Cloud                # world-frame filtered cloud


@dataclasses.dataclass
class LoopClosure:
    i: int                      # keyframe indices
    j: int
    measurement: np.ndarray     # (4, 4) Z_ij
    overlap: float
    inlier_rms: float
    # per-axis information weights [v, w] in the edge-local frame, from the
    # verification ICP's Hessian
    info: Optional[np.ndarray] = None


def serve_backend(mesh, axis: str = "graph") -> None:
    """Ranks >= 1 of a mesh-sharded back-end: join rank 0's PGO and BA
    solves (`PoseGraphMapper` with this mesh) until it calls
    `mesh.stop_serving()`."""
    from ..parallel.ba import PlaneBA, optimize_plane_ba_sharded

    def pgo(t, o):
        optimize_pose_graph_sharded(PoseGraph(*t), mesh, axis=axis, **o)

    def ba(t, o):
        optimize_plane_ba_sharded(PlaneBA(*t[:7]), mesh, axis=axis,
                                  graph_edges=t[7], graph_Z=t[8],
                                  graph_w=t[9], graph_mask=t[10], **o)

    mesh.serve({"pgo": pgo, "ba": ba})


class PoseGraphMapper:
    def __init__(self, app, mesh=None, mesh_axis: str = "graph",
                 min_loop_overlap: float = 35.0,
                 min_keyframe_gap: int = 3,
                 max_loop_distance: float = 10.0,
                 odom_weight_t: float = 100.0,
                 odom_weight_r: float = 400.0,
                 closure_budget: int = 24,
                 max_seam_t: float = 2.0,
                 max_seam_rot_deg: float = 15.0,
                 closure_rms: float = 0.3,
                 closure_degeneracy: float = 30.0,
                 closure_info_floor: float = 150.0):
        self.app = app
        self.mesh, self.mesh_axis = mesh, mesh_axis
        self.device = torch.device(app.device)
        self.min_loop_overlap = min_loop_overlap
        self.min_keyframe_gap = min_keyframe_gap
        self.max_loop_distance = max_loop_distance
        self.odom_weight_t = odom_weight_t
        self.odom_weight_r = odom_weight_r
        # closure verification: `closure_budget` candidates per proposal
        # round pay for ICP (ranked by prior overlap); `max_seam_t` /
        # `max_seam_rot_deg` bound the correction of the pose-derived prior
        # in the relative frame; the degeneracy-aware solve keeps
        # unobservable directions at the prior and `closure_info_floor`
        # turns its Hessian into per-axis edge weights.
        self.closure_budget = closure_budget
        self.max_seam_t = max_seam_t
        self.max_seam_rot_deg = max_seam_rot_deg
        self.closure_rms = closure_rms
        self.closure_degeneracy = closure_degeneracy
        self.closure_info_floor = closure_info_floor
        # Huber scale of the PGO's edges (posegraph._edge_terms)
        self.pgo_robust_delta = 10.0
        self.loop_closures: list[LoopClosure] = []
        self.last_ba_summary: Optional[dict] = None
        self._normals_cache: dict[int, torch.Tensor] = {}

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    # -------------------- keyframes --------------------
    def keyframes(self) -> list[Keyframe]:
        return [Keyframe(index=idx, utime=c.utime,
                         pose=np.asarray(c.corrected_pose), cloud=c.cloud)
                for idx, c in enumerate(self.app.graph.clouds)
                if c.is_reference]

    def _body_cloud(self, kf: Keyframe) -> Cloud:
        """Keyframe cloud in its OWN body frame (graph clouds are stored
        world-frame; closure registration runs in the relative frame)."""
        return kf.cloud.transform(self._tensor(
            np.linalg.inv(kf.pose).astype(np.float32)))

    def _body_normals(self, kf: Keyframe, body: Cloud) -> torch.Tensor:
        """Per-keyframe body-frame normals (K3 below 16,384 points), cached
        by graph index: each keyframe serves several candidate pairs."""
        cached = self._normals_cache.get(kf.index)
        if cached is None:
            cached, _, _ = radius_normals(
                body.points, body.mask, 0.4,
                torch.zeros(3, dtype=torch.float32, device=self.device))
            self._normals_cache[kf.index] = cached
        return cached

    @staticmethod
    def _corr_peaks(pa, na, ma, pb_al, nb_al, mb, u, search=3.0,
                    bin_w=0.10, n_peaks=3, min_sep=0.5):
        """Structural 1-D correlation along a weak direction u (frame a):
        histogram the u-coordinate of points whose normals face along u
        (weighted by |n.u|) in both clouds over their mutual coverage
        window, correlate, and return the top shift candidates."""
        wa = np.abs(na @ u)
        wb = np.abs(nb_al @ u)
        sa = ma & (wa > 0.5)
        sb = mb & (wb > 0.5)
        if sa.sum() < 40 or sb.sum() < 40:
            return []
        xa = pa[sa] @ u
        xb = pb_al[sb] @ u
        lo = max(xa.min(), xb.min()) - search
        hi = min(xa.max(), xb.max()) + search
        ka = (xa >= lo) & (xa <= hi)
        kb = (xb >= lo) & (xb <= hi)
        if ka.sum() < 40 or kb.sum() < 40:
            return []
        nbins = max(int(np.ceil((hi - lo) / bin_w)), 8)
        ha, _ = np.histogram(xa[ka], bins=nbins,
                             range=(lo, lo + nbins * bin_w),
                             weights=wa[sa][ka])
        hb, _ = np.histogram(xb[kb], bins=nbins,
                             range=(lo, lo + nbins * bin_w),
                             weights=wb[sb][kb])
        ker = np.array([0.25, 0.5, 1.0, 0.5, 0.25])
        ha = np.convolve(ha, ker, mode="same")
        hb = np.convolve(hb, ker, mode="same")
        ha /= max(np.linalg.norm(ha), 1e-9)
        hb /= max(np.linalg.norm(hb), 1e-9)
        ks = int(round(search / bin_w))
        deltas, scores = [], []
        for k in range(-ks, ks + 1):
            if k < 0:
                s = float(ha[:k] @ hb[-k:])
            elif k > 0:
                s = float(ha[k:] @ hb[:-k])
            else:
                s = float(ha @ hb)
            deltas.append(k * bin_w)
            scores.append(s)
        order = np.argsort(-np.asarray(scores))
        peaks = []
        for idx in order:
            d = deltas[idx]
            if abs(d) < bin_w:
                continue          # the 0-shift candidate is always tried
            if all(abs(d - p) >= min_sep for p in peaks):
                peaks.append(float(d))
            if len(peaks) >= n_peaks:
                break
        return peaks

    # -------------------- loop closures --------------------
    def propose_loop_closures(self) -> list[LoopClosure]:
        """Relative-frame closure proposal: distance-gated candidates are
        ranked by prior occupancy overlap (one read for all pairs) and the
        top `closure_budget` are registered in the relative frame from the
        pose-derived prior Z0 = T_i^-1 T_j. A closure is accepted on the
        post-fit alignment: inlier rms, bounds on the prior's correction,
        and the overlap of the aligned clouds."""
        kfs = self.keyframes()
        cfg = self.app.cfg
        pairs = []
        for a in range(len(kfs)):
            for b in range(a + self.min_keyframe_gap + 1, len(kfs)):
                d = np.linalg.norm(kfs[a].pose[:3, 3] - kfs[b].pose[:3, 3])
                if d <= self.max_loop_distance:
                    pairs.append((a, b))
        if not pairs:
            self.loop_closures = []
            return []

        # Rank by prior overlap: overlap of rigidly co-transformed clouds is
        # frame-invariant up to voxel-grid alignment, so the world-frame
        # clouds serve directly.
        (ovs,) = _read(torch.stack([compute_overlap(
            kfs[a].cloud.points, kfs[a].cloud.mask, kfs[b].cloud.points,
            kfs[b].cloud.mask, cfg.octree_resolution).overlap_percent
            for a, b in pairs]))
        order = np.argsort(-ovs, kind="stable")[: self.closure_budget]
        _counts["candidates"] += len(order)

        closure_icp = dataclasses.replace(
            cfg.icp, degeneracy_threshold=self.closure_degeneracy)
        bodies: dict[int, tuple] = {}

        def body(k):
            """(body cloud, normals, host points, mask, normals) of
            keyframe k, read once per proposal round."""
            if k not in bodies:
                c = self._body_cloud(kfs[k])
                n = self._body_normals(kfs[k], c)
                bodies[k] = (c, n, *_read(c.points, c.mask, n))
            return bodies[k]

        def icp(Z, trim):
            _counts["icp_calls"] += 1
            res = point_to_plane_icp(body_b.points, body_b.mask,
                                     body_a.points, normals_a, body_a.mask,
                                     self._tensor(Z), trim, closure_icp)
            T, H, rms = _read(res.T, res.hessian, res.inlier_rms)
            return float(rms), np.asarray(T, np.float64), np.asarray(
                H, np.float64)

        found = []
        cos_rot = float(np.cos(np.deg2rad(self.max_seam_rot_deg)))
        for ci in order.tolist():
            a, b = pairs[ci]
            ka, kb = kfs[a], kfs[b]
            body_a, normals_a, pa, ma_np, na = body(a)
            body_b, _, pb, mb_np, nb = body(b)
            Z0 = (np.linalg.inv(ka.pose) @ kb.pose).astype(np.float32)
            # weak-prior trim floor: the prior may carry the full seam
            trim = clamp_trim_ratio(torch.tensor(
                float(ovs[ci]), dtype=torch.float32, device=self.device),
                lo=0.5)
            best = icp(Z0, trim)                  # (rms, a_T_b, Hessian)

            # Along-weak-axis disambiguation: correlate structural
            # histograms along the Hessian's weakest translation direction
            # and re-polish from each peak; the lowest trimmed rms wins.
            Z = best[1]
            u = np.linalg.eigh(best[2][:3, :3])[1][:, 0]
            pb_al = pb @ Z[:3, :3].T + Z[:3, 3]
            nb_al = nb @ Z[:3, :3].T
            for d in self._corr_peaks(pa, na, ma_np, pb_al, nb_al, mb_np,
                                      u, search=self.max_seam_t + 1.0):
                Zc = Z.copy()
                Zc[:3, 3] += d * u
                cand = icp(Zc.astype(np.float32), trim)
                if cand[0] < best[0]:
                    best = cand
            rms, Z, H = best
            # Seam-scale prior-correction bounds, in the relative frame.
            D = np.linalg.inv(Z0) @ Z
            d_t = float(np.linalg.norm(D[:3, 3]))
            cos_d = (float(np.trace(D[:3, :3])) - 1.0) / 2.0
            if rms > self.closure_rms or d_t > self.max_seam_t \
                    or cos_d < cos_rot:
                continue
            # The semantic gate: overlap of the ALIGNED clouds.
            aligned_b = body_b.transform(self._tensor(Z.astype(np.float32)))
            (post_ov,) = _read(compute_overlap(
                body_a.points, body_a.mask, aligned_b.points, aligned_b.mask,
                cfg.octree_resolution).overlap_percent)
            post_ov = float(post_ov)
            if post_ov < self.min_loop_overlap:
                continue
            # Per-axis information from the verification Hessian (frame a,
            # [v, w]) in points-equivalents, rotated into the edge-local
            # residual axes by the |R|^2 map, floored at
            # `closure_info_floor` points.
            dt = np.clip(np.diag(H[:3, :3]) / self.closure_info_floor,
                         0.0, 1.0)
            r0sq = max(np.trace(H[3:, 3:])
                       / max(np.trace(H[:3, :3]), 1e-6), 1e-6)
            dr = np.clip(np.diag(H[3:, 3:]) / r0sq
                         / self.closure_info_floor, 0.0, 1.0)
            Rz2 = Z[:3, :3].astype(np.float64) ** 2
            conf = np.concatenate([Rz2.T @ dt, Rz2.T @ dr])
            s = 1.0 / max(rms, 0.01) ** 2
            info = (s * conf * np.array([1.0] * 3 + [4.0] * 3)
                    ).astype(np.float32)
            found.append(LoopClosure(a, b, Z.astype(np.float32),
                                     post_ov, rms, info=info))
        self.loop_closures = found
        return found

    # -------------------- optimization --------------------
    def build_graph(self, kfs: list[Keyframe]) -> PoseGraph:
        K = len(kfs)
        ei, ej, Z_list, w_list = [], [], [], []
        # odometry edges from the front-end's corrected chain
        for a in range(K - 1):
            ei.append(a)
            ej.append(a + 1)
            Z_list.append(np.linalg.inv(kfs[a].pose) @ kfs[a + 1].pose)
            w_list.append([self.odom_weight_t] * 3 + [self.odom_weight_r] * 3)
        for lc in self.loop_closures:
            ei.append(lc.i)
            ej.append(lc.j)
            Z_list.append(lc.measurement)
            if lc.info is not None:
                # anisotropic: per-axis information from the verification
                # Hessian (degenerate directions get ~zero weight)
                w_list.append(list(np.asarray(lc.info, np.float64)))
            else:
                s = 1.0 / max(lc.inlier_rms, 0.01) ** 2
                w_list.append([s] * 3 + [4.0 * s] * 3)
        edges = torch.as_tensor(np.stack([ei, ej], axis=1).astype(np.int64),
                                device=self.device)
        return PoseGraph(
            self._tensor(np.stack([k.pose for k in kfs])), edges,
            self._tensor(np.stack(Z_list)), self._tensor(w_list),
            torch.ones((edges.shape[0],), dtype=torch.bool,
                       device=self.device))

    def optimize(self, gn_iters: int = 8,
                 consistency_reject_t: float = 0.15) -> list[Keyframe]:
        """Run PGO over keyframes; returns keyframes with updated poses and
        updates the App's graph clouds + map in place. After each solve,
        closures whose residual translation at the optimized poses exceeds
        `consistency_reject_t` are rejected and the graph re-solved (up to
        3 solves)."""
        kfs = self.keyframes()
        if len(kfs) < 2:
            return kfs
        opt_np = None
        for _round in range(3):
            opt, _ = self._solve_pgo(self.build_graph(kfs), gn_iters)
            (opt_np,) = _read(opt)
            keep = []
            for lc in self.loop_closures:
                r = (np.linalg.inv(lc.measurement)
                     @ np.linalg.inv(opt_np[lc.i]) @ opt_np[lc.j])
                if np.linalg.norm(r[:3, 3]) <= consistency_reject_t:
                    keep.append(lc)
            if len(keep) == len(self.loop_closures) or not keep:
                break
            self.loop_closures = keep
        return self._apply_poses(kfs, opt_np)

    def _solve_pgo(self, graph: PoseGraph, gn_iters: int):
        """The PGO, edge-sharded over the mesh when there is one (edges
        padded to a multiple of the axis size, masked)."""
        opts = dict(gn_iters=gn_iters, robust_delta=self.pgo_robust_delta)
        if self.mesh is None:
            return optimize_pose_graph(graph, **opts)
        e, z, w, m = pad_edges(graph.edges, graph.measurements,
                               graph.weights, self.mesh.shape[self.mesh_axis])
        graph = PoseGraph(graph.poses, e, z, w, m)
        self.mesh.send("pgo", [graph.poses, e, z, w, m], **opts)
        return optimize_pose_graph_sharded(graph, self.mesh,
                                           axis=self.mesh_axis, **opts)

    def _apply_poses(self, kfs: list[Keyframe],
                     opt_np: np.ndarray) -> list[Keyframe]:
        """Apply optimized poses to keyframe clouds + the App graph; rebuild
        the aligned map (one read)."""
        for k, kf in enumerate(kfs):
            delta = opt_np[k] @ np.linalg.inv(kf.pose)
            moved = kf.cloud.transform(self._tensor(delta.astype(np.float32)))
            cloud_rec = self.app.graph.clouds[kf.index]
            cloud_rec.cloud = moved
            cloud_rec.corrected_pose = opt_np[k].astype(np.float32)
            kf.pose = opt_np[k]
            kf.cloud = moved
        if kfs:
            pts, mask = _read(torch.cat([kf.cloud.points for kf in kfs]),
                              torch.cat([kf.cloud.mask for kf in kfs]))
            self.app.aligned_map_np = pts[mask]
        return kfs

    def run_plane_ba(self, gn_iters: int = 6, max_planes: int = 12,
                     min_points: int = 50,
                     pose_damping: float = 1.0,
                     robust_sigma_n: float = 0.09,
                     robust_sigma_e: float = 0.10,
                     reject_normal_deg: float = 8.0,
                     reject_offset_m: float = 0.25,
                     max_pose_delta: float = 0.75,
                     min_landmarks: int = 3) -> list[Keyframe]:
        """Plane-landmark bundle adjustment refinement (parallel/ba.py),
        improve or refuse: planes are extracted per keyframe at the current
        poses (K3 normals), associated into world landmarks with the chi^2
        consensus gate, and refined jointly with the pose graph's edges by
        the Huber-robust Schur-complement GN. With fewer than
        `min_landmarks` consensus landmarks, or a solve that moves a pose by
        more than `max_pose_delta`, the poses stay at their PGO values and
        `last_ba_summary["ran"]` is False. `pose_damping` pins each pose
        to its current estimate (planes leave in-plane directions free)."""
        from ..parallel.ba import (build_plane_ba, extract_planes,
                                   optimize_plane_ba,
                                   optimize_plane_ba_sharded,
                                   pad_observations)

        kfs = self.keyframes()
        self.last_ba_summary = {"ran": False, "reason": "too few keyframes"}
        if len(kfs) < 2:
            return kfs
        zero = torch.zeros(3, dtype=torch.float32, device=self.device)
        extracted = []
        for kf in kfs:
            body = self._body_cloud(kf)
            normals, curv, _ = radius_normals(body.points, body.mask, 0.4,
                                              zero)
            extracted.append(extract_planes(body.points, body.mask, normals,
                                            curv, max_planes=max_planes,
                                            min_points=min_points))
        planes, w, v = _read(*(torch.stack(x) for x in zip(*extracted)))

        poses = np.stack([kf.pose for kf in kfs]).astype(np.float32)
        try:
            prob = build_plane_ba(poses, planes, w, v,
                                  reject_normal_deg=reject_normal_deg,
                                  reject_offset_m=reject_offset_m,
                                  min_obs_per_landmark=2, device=self.device)
        except ValueError:
            self.last_ba_summary = {"ran": False,
                                    "reason": "no consensus landmarks"}
            return kfs
        if prob.n_landmarks < min_landmarks:
            self.last_ba_summary = {
                "ran": False, "reason": "too few consensus landmarks",
                "n_landmarks": prob.n_landmarks}
            return kfs
        # JOINT refinement with the pose graph's edges (odometry chain + the
        # verified, info-weighted loop closures)
        graph = self.build_graph(kfs)
        opts = dict(gn_iters=gn_iters, pose_damping=pose_damping,
                    robust_sigma_n=robust_sigma_n,
                    robust_sigma_e=robust_sigma_e,
                    edge_robust_delta=self.pgo_robust_delta)
        edges = (graph.edges, graph.measurements, graph.weights,
                 graph.edge_mask)
        if self.mesh is None:
            opt, _, _ = optimize_plane_ba(
                prob, graph_edges=edges[0], graph_Z=edges[1],
                graph_w=edges[2], graph_mask=edges[3], **opts)
        else:
            prob = pad_observations(prob, self.mesh.shape[self.mesh_axis])
            self.mesh.send("ba", [prob.poses, prob.landmarks, prob.obs_k,
                                  prob.obs_l, prob.obs_plane, prob.obs_w,
                                  prob.obs_mask, *edges], **opts)
            opt, _, _ = optimize_plane_ba_sharded(
                prob, self.mesh, axis=self.mesh_axis, graph_edges=edges[0],
                graph_Z=edges[1], graph_w=edges[2], graph_mask=edges[3],
                **opts)
        (opt,) = _read(opt)
        deltas = np.linalg.norm(opt[:, :3, 3] - poses[:, :3, 3], axis=1)
        if not np.all(np.isfinite(opt)) or deltas.max() > max_pose_delta:
            self.last_ba_summary = {
                "ran": False, "reason": "solve exceeded trust region",
                "max_delta_m": float(deltas.max())}
            return kfs
        self.last_ba_summary = {
            "ran": True, "n_landmarks": int(prob.n_landmarks),
            "n_observations": int(prob.obs_k.shape[0]),
            "max_delta_m": float(deltas.max())}
        return self._apply_poses(kfs, opt)

    def run_backend(self) -> dict:
        """Propose + optimize; returns a summary."""
        lcs = self.propose_loop_closures()
        kfs = self.optimize()
        return {
            "n_keyframes": len(kfs),
            "n_loop_closures": len(lcs),
            "loop_closures": [(lc.i, lc.j, lc.overlap) for lc in lcs],
        }
