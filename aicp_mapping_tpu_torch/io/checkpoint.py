"""Checkpoint / resume of pipeline state, PyTorch port of
`aicp_mapping_tpu.io.checkpoint`.

The App state — the clouds graph (poses, corrections, filtered points),
the total correction, the aligned map, the prior map, the device-resident
reference with its normals, the frame diagnostics — goes to one compressed
`<path>.npz` and a `<path>.json` manifest in the JAX package's format
(`CHECKPOINT_VERSION` 1, the same array names and manifest keys), so a
checkpoint written by either package loads in the other. A mapping session
adds `<path>.mapper.json` (loop closures and the mapper's gates).
`load_checkpoint` builds the App on the card unless the caller asks for
the CPU.
"""
from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

CHECKPOINT_VERSION = 1


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if hasattr(t, "detach") else np.asarray(t)


def save_checkpoint(app, path: str) -> None:
    """Serialize `App` state to `<path>.npz` + `<path>.json`.

    Finalizes any in-flight pipelined frames first: a checkpoint taken
    between submit_cloud and flush would otherwise drop up to
    pipeline_depth frames and save a speculative reference that is
    inconsistent with the saved graph."""
    app.flush()
    arrays: dict[str, np.ndarray] = {}
    clouds_meta = []
    for i, c in enumerate(app.graph.clouds):
        arrays[f"cloud_{i}_points"] = _np(c.cloud.points)
        arrays[f"cloud_{i}_mask"] = _np(c.cloud.mask)
        arrays[f"cloud_{i}_poses"] = np.stack([
            np.asarray(c.odom_pose), np.asarray(c.prior_pose),
            np.asarray(c.correction), np.asarray(c.corrected_pose)])
        clouds_meta.append({
            "utime": int(c.utime),
            "is_reference": bool(c.is_reference),
            "its_reference_id": int(c.its_reference_id),
        })
    arrays["total_correction"] = np.asarray(app.total_correction)
    arrays["aligned_map"] = np.asarray(app.aligned_map_np)
    if app.prior_map is not None:
        arrays["prior_map_points"] = _np(app.prior_map.points)
        arrays["prior_map_mask"] = _np(app.prior_map.mask)
    if app._ref_device is not None:
        # the device-resident reference: its normals came from the frame
        # step's aligned outputs, so they are saved, not recomputed, for a
        # bit-identical resume
        rp, rm, rn = app._ref_device
        arrays["ref_points"] = _np(rp)
        arrays["ref_mask"] = _np(rm)
        arrays["ref_normals"] = _np(rn)
        arrays["ref_pose"] = np.asarray(app._ref_pose)

    frames = []
    for f in app.frames:
        d = dataclasses.asdict(f)
        d["correction"] = np.asarray(f.correction).tolist()
        d["corrected_pose"] = np.asarray(f.corrected_pose).tolist()
        frames.append(d)

    manifest = {
        "version": CHECKPOINT_VERSION,
        "config": dataclasses.asdict(app.cfg),
        "n_clouds": len(app.graph.clouds),
        "current_reference_id": app.graph.current_reference_id,
        "updates_counter": app.updates_counter,
        "since_ref_disp": app._since_ref_disp,
        "registered_any": app._registered_any,
        "clouds": clouds_meta,
        "frames": frames,
    }
    np.savez_compressed(path + ".npz", **arrays)
    tmp = path + ".json.tmp"
    with open(tmp, "w") as f:
        json.dump(manifest, f)
    os.replace(tmp, path + ".json")


def load_checkpoint(path: str, device="cuda", visualizer=None,
                    classifier=None):
    """Reconstruct an `App` on `device` from a checkpoint written by either
    package's `save_checkpoint`."""
    import torch

    from ..cloud import AlignedCloud, Cloud
    from ..convert import config_from_dict
    from ..ops.normals import radius_normals
    from ..pipeline.app import App, FrameResult

    with open(path + ".json") as f:
        manifest = json.load(f)
    if manifest["version"] != CHECKPOINT_VERSION:
        raise ValueError(
            f"unsupported checkpoint version {manifest['version']}")
    data = np.load(path + ".npz")

    cfg = config_from_dict(manifest["config"])
    app = App(cfg, device=device, visualizer=visualizer,
              classifier=classifier)
    dev = app.device

    def put(a):
        return torch.as_tensor(np.asarray(a), device=dev)

    app._set_total(data["total_correction"])
    app.aligned_map_np = data["aligned_map"]
    if "prior_map_points" in data:
        app.prior_map = Cloud(put(data["prior_map_points"]),
                              put(data["prior_map_mask"]))
    app.updates_counter = manifest["updates_counter"]
    # the dispatch-side windowed-reference counter: checkpoints without it
    # fall back to the graph-derived phase
    app._since_ref_disp = manifest.get(
        "since_ref_disp",
        (manifest["n_clouds"] - (manifest["current_reference_id"] + 1))
        % max(int(cfg.reference_update_frequency), 1))
    app._registered_any = manifest.get("registered_any",
                                       manifest["n_clouds"] > 0)

    for i, meta in enumerate(manifest["clouds"]):
        poses = data[f"cloud_{i}_poses"]
        app.graph.add(AlignedCloud(
            utime=meta["utime"],
            cloud=Cloud(put(data[f"cloud_{i}_points"]),
                        put(data[f"cloud_{i}_mask"])),
            odom_pose=np.asarray(poses[0]),
            prior_pose=np.asarray(poses[1]),
            correction=np.asarray(poses[2]),
            corrected_pose=np.asarray(poses[3]),
            is_reference=meta["is_reference"],
            its_reference_id=meta["its_reference_id"]))
    app.graph.current_reference_id = manifest["current_reference_id"]

    if "ref_points" in data:
        app._ref_device = (put(data["ref_points"]), put(data["ref_mask"]),
                           put(data["ref_normals"]))
        app._ref_pose = np.asarray(data["ref_pose"], np.float32)
    elif not app.graph.is_empty():
        # a checkpoint without the reference arrays: rebuilt from the graph
        # reference, normals recomputed (the resume is then approximate)
        ref = app.graph.clouds[app.graph.current_reference_id]
        pose = np.asarray(ref.corrected_pose, np.float32)
        normals, _, _ = radius_normals(ref.cloud.points, ref.cloud.mask, 0.4,
                                       put(pose[:3, 3]))
        app._ref_device = (ref.cloud.points, ref.cloud.mask, normals)
        app._ref_pose = pose

    for d in manifest["frames"]:
        d["correction"] = np.asarray(d["correction"], np.float32)
        d["corrected_pose"] = np.asarray(d["corrected_pose"], np.float32)
        app.frames.append(FrameResult(**d))
    return app


def save_mapper_checkpoint(mapper, path: str) -> None:
    """Serialize a PoseGraphMapper (App + back-end state) so a mapping
    session with loop closures can resume: `<path>.{npz,json}` for the App
    plus `<path>.mapper.json` for the closures and gates. Each closure also
    carries its per-axis information (`info`), which the JAX package's
    loader ignores."""
    save_checkpoint(mapper.app, path)
    doc = {
        "version": CHECKPOINT_VERSION,
        "params": {
            "min_loop_overlap": mapper.min_loop_overlap,
            "min_keyframe_gap": mapper.min_keyframe_gap,
            "max_loop_distance": mapper.max_loop_distance,
            "odom_weight_t": mapper.odom_weight_t,
            "odom_weight_r": mapper.odom_weight_r,
        },
        "loop_closures": [
            {"i": lc.i, "j": lc.j,
             "measurement": np.asarray(lc.measurement).tolist(),
             "overlap": float(lc.overlap),
             "inlier_rms": float(lc.inlier_rms),
             **({} if lc.info is None
                else {"info": np.asarray(lc.info).tolist()})}
            for lc in mapper.loop_closures
        ],
    }
    tmp = path + ".mapper.json.tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, path + ".mapper.json")


def load_mapper_checkpoint(path: str, mesh=None, mesh_axis: str = "graph",
                           device="cuda", visualizer=None, classifier=None):
    """Reconstruct a PoseGraphMapper (and its App) from either package's
    `save_mapper_checkpoint`. The mesh is runtime topology, not state: pass
    it when resuming over ranks (the App then lives on the mesh's
    device)."""
    from ..pipeline.mapper import LoopClosure, PoseGraphMapper

    app = load_checkpoint(path, device=device if mesh is None
                          else mesh.device, visualizer=visualizer,
                          classifier=classifier)
    with open(path + ".mapper.json") as f:
        doc = json.load(f)
    if doc["version"] != CHECKPOINT_VERSION:
        raise ValueError(f"unsupported mapper checkpoint {doc['version']}")
    mapper = PoseGraphMapper(app, mesh=mesh, mesh_axis=mesh_axis,
                             **doc["params"])
    mapper.loop_closures = [
        LoopClosure(i=lc["i"], j=lc["j"],
                    measurement=np.asarray(lc["measurement"], np.float32),
                    overlap=lc["overlap"], inlier_rms=lc["inlier_rms"],
                    info=(np.asarray(lc["info"], np.float32)
                          if "info" in lc else None))
        for lc in doc["loop_closures"]
    ]
    return mapper
