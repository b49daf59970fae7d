"""State carried between two Apps as plain Python and numpy — from the JAX
package's App into the port's, or between two of the port's Apps on
different devices — so that a per-frame comparison starts every frame from
identical state instead of accumulating drift.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .cloud import AlignedCloud, Cloud
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


def app_state_to_numpy(app: App) -> dict:
    """The state `app_state_from_numpy` restores, as numpy arrays and ints."""
    pts, mask, normals = app._ref_device
    return dict(ref_points=pts.cpu().numpy(), ref_mask=mask.cpu().numpy(),
                ref_normals=normals.cpu().numpy(),
                ref_pose=np.array(app._ref_pose, np.float32),
                total_correction=np.array(app.total_correction, np.float32),
                graph_ids=(app.graph.n_clouds,
                           app.graph.current_reference_id, app._since_ref))


def app_state_from_numpy(app: App, ref_points, ref_mask, ref_normals,
                         ref_pose, total_correction, graph_ids) -> None:
    """Seed `app` with another App's state: the current reference
    (points, mask, normals on the app's device, and its pose), the total
    correction, and `graph_ids` = (number of clouds in the graph, current
    reference id, clouds added since the reference was adopted). The
    earlier clouds themselves are not carried: the graph holds placeholder
    records with the right count and reference flags."""
    n_clouds, ref_id, since_ref = (int(v) for v in graph_ids)
    dev = app.device
    app._ref_device = (
        torch.as_tensor(np.asarray(ref_points, np.float32), device=dev),
        torch.as_tensor(np.asarray(ref_mask, bool), device=dev),
        torch.as_tensor(np.asarray(ref_normals, np.float32), device=dev))
    app._ref_pose = np.array(ref_pose, np.float32)
    app.total_correction = np.array(total_correction, np.float32)
    app._since_ref = since_ref
    empty = Cloud(torch.zeros((0, 3), device=dev),
                  torch.zeros((0,), dtype=torch.bool, device=dev))
    eye = np.eye(4, dtype=np.float32)
    app.graph.clouds = [
        dataclasses.replace(AlignedCloud.create(-1, empty, eye),
                            is_reference=(i == ref_id))
        for i in range(n_clouds)]
    app.graph.current_reference_id = ref_id
