"""State carried between two Apps as plain Python and numpy — from the JAX
package's App into the port's, or between two of the port's Apps (or
localizers) on different devices — so that a per-frame comparison starts
every frame from identical state instead of accumulating drift.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .classification.classifier import RiskClassifier, SVMModel
from .cloud import AlignedCloud, Cloud
from .parallel.ba import PlaneBA
from .parallel.localizer import ShardedMapLocalizer
from .parallel.posegraph import PoseGraph
from .pipeline.app import App, check_device
from .pipeline.config import PipelineConfig
from .registration.icp import ICPConfig


def config_from_dict(d: dict) -> PipelineConfig:
    """The port's PipelineConfig from `dataclasses.asdict` of either
    package's config (same field names; the ICP chain is a nested dict)."""
    d = dict(d)
    icp = d.pop("icp", None)
    cfg = PipelineConfig(**d)
    if icp is not None:
        cfg.icp = ICPConfig(**icp)
    return cfg


def _np(t):
    return None if t is None else t.cpu().numpy()


def _arr(x) -> np.ndarray:
    """A tensor of either package (torch or JAX) as numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def app_state_to_numpy(app: App) -> dict:
    """The state `app_state_from_numpy` restores, as numpy arrays and ints
    (None where the App has no graph reference or no prior map)."""
    pts, mask, normals = app._ref_device or (None, None, None)
    prior = app.prior_map
    return dict(ref_points=_np(pts), ref_mask=_np(mask),
                ref_normals=_np(normals),
                ref_pose=(None if app._ref_pose is None
                          else np.array(app._ref_pose, np.float32)),
                total_correction=np.array(app.total_correction, np.float32),
                graph_ids=(app.graph.n_clouds,
                           app.graph.current_reference_id, app._since_ref_disp,
                           int(app._registered_any)),
                prior_map=None if prior is None else prior.to_numpy(),
                aligned_map=np.array(app.aligned_map_np))


def app_state_from_numpy(app: App, ref_points, ref_mask, ref_normals,
                         ref_pose, total_correction, graph_ids,
                         prior_map=None, aligned_map=None) -> None:
    """Seed `app` with another App's state: the current graph reference
    (points, mask, normals on the app's device, and its pose; None for a
    map-mode App that has none), the total correction, `graph_ids` =
    (number of clouds in the graph, current reference id, clouds added
    since the reference was adopted[, whether a registration has run]), the
    prior map's points and the built map. The earlier clouds themselves
    are not carried: the graph holds placeholder records with the right
    count and reference flags."""
    n_clouds, ref_id, since_ref, *registered = (int(v) for v in graph_ids)
    dev = app.device
    app._ref_device = None
    if ref_points is not None:
        app._ref_device = (
            torch.as_tensor(np.asarray(ref_points, np.float32), device=dev),
            torch.as_tensor(np.asarray(ref_mask, bool), device=dev),
            torch.as_tensor(np.asarray(ref_normals, np.float32), device=dev))
    app._ref_pose = (None if ref_pose is None
                     else np.array(ref_pose, np.float32))
    app._set_total(np.array(total_correction, np.float32))
    app._since_ref_disp = since_ref
    app._registered_any = bool(registered[0]) if registered else n_clouds > 0
    if prior_map is not None:
        app.prior_map = app._map_cloud(prior_map)
    if aligned_map is not None:
        app.aligned_map_np = aligned_map
    empty = Cloud(torch.zeros((0, 3), device=dev),
                  torch.zeros((0,), dtype=torch.bool, device=dev))
    eye = np.eye(4, dtype=np.float32)
    app.graph.clouds = [
        dataclasses.replace(AlignedCloud.create(-1, empty, eye),
                            is_reference=(i == ref_id))
        for i in range(n_clouds)]
    app.graph.current_reference_id = ref_id


def localizer_state_to_numpy(loc: ShardedMapLocalizer) -> dict:
    """The localizer's prepared map in its blocked layout — per-block
    points (D, B, 3), masks (D, B) and normals (D, B, 3), the block size B
    and the crop key's `rev_bits` — with its App's state and its frame
    counter, as numpy. Over a mesh, rank 0 calls this while the other
    ranks `serve` (the blocks are gathered from them)."""
    points, mask, normals = loc.map_blocks()
    return dict(map_points=_np(points), map_mask=_np(mask),
                map_normals=_np(normals), block_size=loc.block_size,
                rev_bits=loc._rev_bits,
                app=app_state_to_numpy(loc.app), frame_idx=loc._frame_idx)


def localizer_from_state(state: dict, config: ICPConfig | None = None, *,
                         device="cuda", mesh=None, axis: str = "points",
                         **options) -> ShardedMapLocalizer:
    """A localizer on `device` over the prepared blocks of
    `localizer_state_to_numpy`'s `state` — points, masks and normals as
    they are, so no normals pass runs — seeded with its App state (None:
    a fresh App) and frame counter. Over `mesh` (SPMD: every rank calls
    this) each rank holds its block of `axis`; without one the localizer
    holds every block, which crops the same rows. The state may come from
    the JAX package's localizer (its sharded map arrays reshaped into
    blocks). `config` and `options` are `ShardedMapLocalizer`'s, less
    those that prepare the map (`normal_radius`, `block_cell`)."""
    check_device(device if mesh is None else mesh.device,
                 "localizer_from_state")
    points = np.asarray(state["map_points"], np.float32)
    mask = np.asarray(state["map_mask"], bool)
    normals = np.asarray(state["map_normals"], np.float32)
    n_blocks = points.shape[0]
    if mesh is not None:
        if mesh.shape[axis] != n_blocks:
            raise ValueError(f"{n_blocks} blocks over {mesh.shape[axis]} "
                             f"ranks of axis {axis!r}")
        i = mesh.index(axis)
        points, mask, normals = points[i], mask[i], normals[i]
    points, mask, normals = (points.reshape(-1, 3), mask.reshape(-1),
                             normals.reshape(-1, 3))
    loc = ShardedMapLocalizer.__new__(ShardedMapLocalizer)
    loc._setup(config, device, mesh=mesh, axis=axis, **options)
    dev = loc.device
    loc._set_map(torch.as_tensor(points, device=dev),
                 torch.as_tensor(mask, device=dev),
                 torch.as_tensor(normals, device=dev),
                 n_blocks if mesh is not None else 1)
    if loc._rev_bits != int(state["rev_bits"]):
        raise ValueError(f"rev_bits {state['rev_bits']} of the state, "
                         f"{loc._rev_bits} of its blocks")
    if loc.app is not None and state.get("app") is not None:
        app_state_from_numpy(loc.app, **state["app"])
    loc._frame_idx = int(state["frame_idx"])
    return loc


def classifier_to_numpy(clf) -> dict:
    """A risk classifier's model (`w`, `b`, `mean`, `std`) and `threshold`
    as numpy: the JAX package's `RiskClassifier` or the port's."""
    m = clf.model
    return dict(**{k: np.array(getattr(m, k), np.float32)
                   for k in ("w", "b", "mean", "std")},
                threshold=float(clf.threshold))


def classifier_from_numpy(w, b, mean, std, threshold=0.5) -> RiskClassifier:
    """The port's `RiskClassifier` holding the given model (on the CPU; the
    App moves it to its device)."""
    clf = RiskClassifier(threshold=float(threshold))
    clf.model = SVMModel(*(torch.as_tensor(np.asarray(a, np.float32))
                           for a in (w, b, mean, std)))
    return clf


def _fields_to_numpy(obj, cls) -> dict:
    return {f.name: _arr(getattr(obj, f.name))
            for f in dataclasses.fields(cls)}


def pose_graph_to_numpy(graph) -> dict:
    """Either package's `PoseGraph` as numpy arrays (its field names)."""
    return _fields_to_numpy(graph, PoseGraph)


def pose_graph_from_numpy(poses, edges, measurements, weights, edge_mask,
                          device="cuda") -> PoseGraph:
    """The port's `PoseGraph` on `device` from numpy arrays (JAX's int32
    edges become int64)."""
    dev = check_device(device, "pose_graph_from_numpy")

    def t(a, dtype):
        return torch.as_tensor(np.asarray(a), device=dev).to(dtype)

    return PoseGraph(t(poses, torch.float32), t(edges, torch.int64),
                     t(measurements, torch.float32),
                     t(weights, torch.float32), t(edge_mask, torch.bool))


def plane_ba_to_numpy(problem) -> dict:
    """Either package's `PlaneBA` as numpy arrays (its field names)."""
    return _fields_to_numpy(problem, PlaneBA)


def plane_ba_from_numpy(poses, landmarks, obs_k, obs_l, obs_plane, obs_w,
                        obs_mask, device="cuda") -> PlaneBA:
    """The port's `PlaneBA` on `device` from numpy arrays."""
    dev = check_device(device, "plane_ba_from_numpy")

    def t(a, dtype):
        return torch.as_tensor(np.asarray(a), device=dev).to(dtype)

    return PlaneBA(t(poses, torch.float32), t(landmarks, torch.float32),
                   t(obs_k, torch.int64), t(obs_l, torch.int64),
                   t(obs_plane, torch.float32), t(obs_w, torch.float32),
                   t(obs_mask, torch.bool))


def mapper_state_to_numpy(mapper) -> dict:
    """Either package's `PoseGraphMapper` state as plain Python and numpy:
    its keyframes (graph index, utime, pose, world-frame points and mask),
    its loop closures (i, j, measurement, overlap, inlier rms, info) and
    `last_ba_summary`."""
    kfs = [dict(index=k.index, utime=int(k.utime),
                pose=np.array(k.pose, np.float32),
                points=_arr(k.cloud.points), mask=_arr(k.cloud.mask))
           for k in mapper.keyframes()]
    closures = [dict(i=lc.i, j=lc.j,
                     measurement=np.array(lc.measurement, np.float32),
                     overlap=float(lc.overlap),
                     inlier_rms=float(lc.inlier_rms),
                     info=None if lc.info is None else np.array(lc.info))
                for lc in mapper.loop_closures]
    return dict(keyframes=kfs, loop_closures=closures,
                last_ba_summary=mapper.last_ba_summary)
