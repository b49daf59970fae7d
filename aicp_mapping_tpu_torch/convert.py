"""State carried between two Apps as plain Python and numpy — from the JAX
package's App into the port's, or between two of the port's Apps (or
localizers) on different devices — so that a per-frame comparison starts
every frame from identical state instead of accumulating drift.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .cloud import AlignedCloud, Cloud
from .parallel.localizer import ShardedMapLocalizer
from .pipeline.app import App
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
                           app.graph.current_reference_id, app._since_ref,
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
    app.total_correction = np.array(total_correction, np.float32)
    app._since_ref = since_ref
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
    """The localizer's prepared map (Morton-ordered, padded points, mask
    and normals), its App's state and its frame counter, as numpy."""
    return dict(map_points=_np(loc.map_points), map_mask=_np(loc.map_mask),
                map_normals=_np(loc.map_normals),
                app=app_state_to_numpy(loc.app), frame_idx=loc._frame_idx)


def localizer_from_state(state: dict, config: ICPConfig | None = None, *,
                         device="cpu", **options) -> ShardedMapLocalizer:
    """A localizer on `device` over the prepared map of
    `localizer_state_to_numpy`'s `state` — its points, mask and normals as
    they are, so no normals pass runs — seeded with its App state and
    frame counter. `config` and `options` are `ShardedMapLocalizer`'s,
    less those that prepare the map (`normal_radius`, `block_cell`)."""
    loc = ShardedMapLocalizer.__new__(ShardedMapLocalizer)
    loc._setup(config, device, **options)
    dev = loc.device
    loc._set_map(
        torch.as_tensor(np.asarray(state["map_points"], np.float32),
                        device=dev),
        torch.as_tensor(np.asarray(state["map_mask"], bool), device=dev),
        torch.as_tensor(np.asarray(state["map_normals"], np.float32),
                        device=dev))
    app_state_from_numpy(loc.app, **state["app"])
    loc._frame_idx = int(state["frame_idx"])
    return loc
