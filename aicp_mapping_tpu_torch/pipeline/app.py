"""The AICP pipeline state machine, PyTorch port of
`aicp_mapping_tpu.pipeline.app`.

Host Python makes the per-frame decisions (bootstrap, reference policy,
gates' bookkeeping); the frame step (`pipeline.fused.make_app_frame_step`)
runs on `App(config, device=...)`'s device — the card unless the caller
asks for the CPU.

A frame is dispatched by `submit_cloud` and finalized later: up to
`pipeline_depth` frames are in flight, the oldest `pipeline_depth // 2`
are finalized together once the window is full, and `flush` finalizes the
rest. Dispatch chains the total correction on the device (each step takes
the previous step's `new_total`), adopts a windowed reference update
speculatively, and copies the frame's scalars to pinned host memory behind
a CUDA event; finalize waits on those events only, then runs the host
bookkeeping (gates, graph, maps), rolling a rejected frame's speculative
reference back unless a later frame adopted a newer one (the `_ref_gen`
generation token). With `async_finalize` a finalizer thread does the
waiting and the bookkeeping, its errors raised at the next `drain_results`
or `flush`. `process_cloud` is submit + flush: the synchronous path.

Also: failure prediction (FOV overlap, alignability, the risk classifier
and its gate; the `min_overlap_percent` gate) discarding the correction
and forcing a reference update, the accept gate with the
first-registration exemption, robot and debug working modes, the map
modes (a prior map or an external `reference_provider` such as
`parallel.ShardedMapLocalizer` with the overlap pinned at 50, the built
map and `go_back_to_map`, `load_map_from_file`,
`merge_aligned_clouds_to_map`), `debug_dir` PCD dumps, `correct_pose` and
`inject_correction`.

A visualizer sink (`utils.visualizer`) gets what the JAX App publishes,
at the same points and in frame order: the bootstrap cloud, pose and map;
each finalized frame's metrics; the poses, thinned to one per metre of
travel; a new reference cloud and the map, read to the host only when the
sink is not a `NullVisualizer`. Those reads run in finalize, on whichever
thread finalizes, after the frame's scalars event (`_Scalars`) has been
waited on, so they go on a stream of their own and wait for nothing
dispatched since. `timing` (`utils.timing.TimingUtils`) records, on
either finalize path, the wait on a batch's scalars
("aicp.app.finalize_wait", JAX's "frameStep") and each frame's host tail
("aicp.app.finalize", JAX's "fullLoop"); each section is also a span of
the port's tracer (`utils.timing.span`), as are the dispatch
("aicp.app.dispatch"), `flush` ("aicp.app.flush") and a blocking wait for
the state lock ("aicp.app.lock_wait"). The App's spans carry the frame's
index in `frames`, assigned at dispatch.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import queue
import threading
from typing import Optional

import numpy as np
import torch

from ..classification.classifier import RiskClassifier
from ..cloud import AlignedCloud, AlignedCloudsGraph, Cloud
from ..io.pcd import write_pcd
from ..ops.normals import radius_normals
from ..ops.voxel import crop_box
from ..utils import timing
from ..utils.timing import TimingUtils
from ..utils.visualizer import NullVisualizer, Visualizer
from .config import PipelineConfig
from .fused import _pre_voxelized, _prefilter, make_app_frame_step


@dataclasses.dataclass
class FrameResult:
    """Per-frame diagnostics (the JAX `FrameResult` fields)."""

    utime: int
    reference_id: int
    reading_id: int
    octree_overlap: float
    fov_overlap: float
    alignability: float
    risk: float
    correction: np.ndarray      # (4, 4)
    accepted: bool
    registered: bool            # False when gated or first cloud
    n_iterations: int
    inlier_rms: float
    corrected_pose: np.ndarray  # (4, 4)
    filtered_size: int


def check_device(device, who: str) -> torch.device:
    """`device` as a torch.device; a CUDA device without a card raises (an
    entry point never falls back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{who}(device={str(device)!r}): CUDA is not "
                           "available; pass device='cpu' to run on the CPU")
    return dev


class _Scalars:
    """One frame's scalars on their way to the host (the gated and raw
    corrections and the new total, 16 each, then risk_ok, accepted,
    overlap, FOV overlap, alignability, risk, inlier rms and the filtered
    count). On a card the dispatch copies them into pinned host memory
    with `non_blocking` and records a CUDA event behind the copy on its
    stream; `get` waits on that event, not on the whole device."""

    def __init__(self, out):
        vec = torch.cat([
            out.correction.reshape(-1), out.correction_raw.reshape(-1),
            out.new_total.reshape(-1),
            torch.stack([out.risk_ok.float(), out.accepted.float(),
                         out.overlap_percent, out.fov_overlap,
                         out.alignability, out.risk, out.inlier_rms,
                         out.filtered_count.float()])])
        self.stream = self.event = None
        if vec.device.type == "cuda":
            self.host = torch.empty(vec.shape, dtype=vec.dtype,
                                    pin_memory=True)
            self.host.copy_(vec, non_blocking=True)
            self.stream = torch.cuda.current_stream(vec.device)
            self.event = torch.cuda.Event()
            self.event.record(self.stream)
        else:
            self.host = vec

    def get(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()

    def on_stream(self):
        """Device work of the frame's finalize goes on its dispatch's
        stream (a finalizer thread has its own current stream)."""
        if self.stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream)


class App:
    def __init__(self, config: PipelineConfig, device="cuda",
                 reference_provider=None,
                 classifier: Optional[RiskClassifier] = None,
                 visualizer: Optional[Visualizer] = None):
        self.device = check_device(device, "App")
        self.cfg = config
        self.vis = visualizer or NullVisualizer()
        self.timing = TimingUtils(verbose=config.verbose)
        # the stream of the sink's reads of finalized frames' clouds
        self._read_stream = (torch.cuda.Stream(self.device)
                             if self.device.type == "cuda" else None)
        # Optional external reference for prior-map localization: any
        # object with provide_reference(pose_est) -> (points, mask, normals)
        # tensors on this App's device (parallel.ShardedMapLocalizer).
        self.reference_provider = reference_provider
        self.graph = AlignedCloudsGraph()
        # The total correction: a host mirror refreshed at finalize, and
        # its device twin chained through each dispatched step's new_total
        # (under pipelining the host value is up to pipeline_depth frames
        # stale).
        self.total_correction = np.eye(4, dtype=np.float32)
        self._total_dev = torch.eye(4, device=self.device)
        self.updates_counter = 0
        self.frames: list[FrameResult] = []
        # Current graph reference on the device: (points, mask, normals),
        # its world pose, clouds dispatched since it was adopted, and a
        # generation token bumped at every adoption or rollback.
        self._ref_device: Optional[tuple] = None
        self._ref_pose: Optional[np.ndarray] = None
        self._since_ref_disp = 0
        self._ref_gen = 0
        # True once a registration frame has been dispatched: only the
        # first registration into an empty graph is exempt from the accept
        # gate.
        self._registered_any = False
        # Frames dispatched and not yet finalized, oldest first, and the
        # frames dispatched and not yet recorded in `frames` (those pending
        # and those handed to the finalizer): a frame's index in `frames`
        # is known at its dispatch.
        self._pending: list[dict] = []
        self._unrecorded = 0
        # _state_lock serializes dispatch and finalize bookkeeping; the
        # async finalizer waits for the device outside it.
        self._state_lock = threading.RLock()
        self._fin_queue: Optional[queue.Queue] = None
        self._fin_results: list[FrameResult] = []
        self._fin_error: Optional[Exception] = None
        # Prior map (a Cloud at map capacity) and the built map: reference
        # clouds appended as device clouds, materialized to numpy lazily.
        self.prior_map: Optional[Cloud] = None
        self._map_parts: list[np.ndarray] = []
        self._map_pending: list[Cloud] = []
        self._map_np: Optional[np.ndarray] = None
        self.classifier = classifier
        if classifier is None and config.classifier_path:
            self.classifier = RiskClassifier(threshold=config.risk_threshold)
            self.classifier.load(config.classifier_path)
        has_clf = (self.classifier is not None
                   and self.classifier.model is not None)
        self._app_step = make_app_frame_step(
            config, with_risk=config.failure_prediction_mode,
            with_classifier=has_clf)
        self._clf_params = (tuple(dataclasses.astuple(
            self.classifier.model.to(self.device))) if has_clf else ())
        if config.async_finalize:
            self._fin_queue = queue.Queue()
            self._fin_thread = threading.Thread(
                target=self._finalizer_loop, name="aicp-finalizer",
                daemon=True)
            self._fin_thread.start()

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    def _set_total(self, total) -> None:
        """Set the total correction on the host and the device."""
        self.total_correction = np.asarray(total, np.float32)
        self._total_dev = self._tensor(self.total_correction)

    # ------------------------------------------------------------------
    # maps
    # ------------------------------------------------------------------
    @property
    def aligned_map_np(self) -> np.ndarray:
        """The accumulated aligned map (the reference clouds), as numpy."""
        with self._state_lock:
            if self._map_pending:
                self._map_parts.extend(self._finalized_np(c)
                                       for c in self._map_pending)
                self._map_pending.clear()
                self._map_np = None
            if self._map_np is None:
                self._map_np = (np.concatenate(self._map_parts)
                                if self._map_parts
                                else np.zeros((0, 3), np.float32))
            return self._map_np

    def _finalized_np(self, cloud: Cloud) -> np.ndarray:
        """A finalized frame's cloud as numpy. Finalize has waited on the
        frame's scalars event, so its work is done: the copy runs on the
        read stream and does not wait for frames dispatched since."""
        if self._read_stream is None:
            return cloud.to_numpy()
        with torch.cuda.stream(self._read_stream):
            return cloud.to_numpy()

    @aligned_map_np.setter
    def aligned_map_np(self, value) -> None:
        value = np.asarray(value, np.float32).reshape(-1, 3)
        self._map_parts = [value] if len(value) else []
        self._map_pending = []
        self._map_np = None

    def _map_cloud(self, points: np.ndarray) -> Cloud:
        return Cloud.from_numpy(points, capacity=self.cfg.map_capacity,
                                device=self.device)

    def filter_cloud(self, cloud: Cloud, viewpoint) -> Cloud:
        """The frame path's voxel + planes-only prefilter of one cloud."""
        pts, mask, _ = _prefilter(self.cfg, cloud.points.to(self.device),
                                  cloud.mask.to(self.device),
                                  self._tensor(viewpoint))
        return Cloud(pts, mask)

    def set_prior_map(self, cloud: Cloud) -> None:
        """Load-map service: prefilter at the zero viewpoint and store at
        map capacity."""
        filtered = self.filter_cloud(cloud, np.zeros(3, np.float32))
        self.prior_map = self._map_cloud(filtered.to_numpy())

    def set_initial_guess(self, pose_in_map: np.ndarray,
                          world_to_body: np.ndarray) -> None:
        """Seed the total correction with pose_in_map @ odometry^-1, so
        corrected poses start in the map frame."""
        self._set_total(
            np.asarray(pose_in_map, np.float32)
            @ np.linalg.inv(np.asarray(world_to_body, np.float32)))

    def go_back_to_map(self) -> None:
        """Go-back service: the built map becomes the prior map and the App
        turns to localization only."""
        self.prior_map = self._map_cloud(self.aligned_map_np)
        self.cfg.localize_against_prior_map = True

    def _crop_map(self, map_pts, map_mask, pose):
        """The map points in the box around `pose`, compacted to the front
        (stable, by index) and cut to `filtered_capacity`."""
        c = self.cfg.crop_map_around_base
        inside = crop_box(map_pts, map_mask, pose, -c, c)
        perm = torch.sort((~inside).to(torch.int8), stable=True).indices
        perm = perm[:self.cfg.filtered_capacity]
        return map_pts[perm], inside[perm]

    def _set_reference(self, pose_est: np.ndarray):
        """(points, mask, normals, pose, ref_id, fixed_overlap) of this
        frame's reference. In prior-map localization every frame registers
        against the cropped prior map with the overlap pinned at 50; with
        load_map_from_file only the first frame does; built-map mode crops
        the accumulated aligned map; otherwise the current graph reference
        (ref_id None: resolved after the frame)."""
        cfg = self.cfg
        use_map = (cfg.localize_against_prior_map
                   or (cfg.load_map_from_file and self.graph.is_empty()))
        fixed = 50.0 if cfg.localize_against_prior_map else -1.0
        pose = np.asarray(pose_est, np.float32)
        if use_map and self.reference_provider is not None:
            pts, mask, normals = self.reference_provider.provide_reference(
                pose)
            return pts, mask, normals, pose, -1, fixed
        if use_map or cfg.localize_against_built_map:
            if use_map:
                assert self.prior_map is not None, "prior map not loaded"
                src = self.prior_map
            else:
                src = self._map_cloud(self.aligned_map_np)
            pts, mask = self._crop_map(src.points, src.mask,
                                       self._tensor(pose))
            normals, _, _ = radius_normals(pts, mask, 0.4,
                                           self._tensor(pose[:3, 3]))
            return pts, mask, normals, pose, -1, fixed
        pts, mask, normals = self._ref_device
        return pts, mask, normals, self._ref_pose, None, -1.0

    # ------------------------------------------------------------------
    # frames
    # ------------------------------------------------------------------
    def process_cloud(self, cloud: AlignedCloud) -> Optional[FrameResult]:
        """The synchronous entry point: dispatch the frame and finalize
        everything in flight."""
        first = self.submit_cloud(cloud)
        res = self.flush()
        if res:
            return res[-1]
        return first[-1] if first else None

    def submit_cloud(self, cloud: AlignedCloud) -> list[FrameResult]:
        """Dispatch this frame's step; once `pipeline_depth` frames are in
        flight, finalize the oldest `pipeline_depth // 2` (with
        `async_finalize`: hand them to the finalizer thread) and return the
        results finished so far, in order (often none).

        Under pipelining a risk-forced reference update or a rejection is
        seen when its frame is finalized, so the frames dispatched in
        between register against the speculatively chosen reference — the
        JAX package's pipelined semantics."""
        with self._locked():
            frame = len(self.frames) + self._unrecorded
            with timing.span("aicp.app.dispatch", frame):
                boot = self._dispatch(cloud, frame)
            self._unrecorded += 1
            if boot is not None:
                return [boot]
            return self._finalize_due()

    @contextlib.contextmanager
    def _locked(self):
        """The state lock; a span "aicp.app.lock_wait" covers the wait when
        another thread holds it."""
        if not self._state_lock.acquire(blocking=False):
            with timing.span("aicp.app.lock_wait"):
                self._state_lock.acquire()
        try:
            yield
        finally:
            self._state_lock.release()

    def _dispatch(self, cloud: AlignedCloud,
                  frame: int) -> Optional[FrameResult]:
        """Dispatch frame `frame`'s step and queue it for finalize; the
        first cloud of a graph is bootstrapped and its result returned."""
        cfg = self.cfg
        if (_pre_voxelized(cfg, cloud.cloud.capacity)
                and not cloud.cloud.pre_voxelized):
            raise ValueError(
                "cloud at <= downsample_capacity would skip the device "
                "voxel stage but was not host-voxelized; build it with "
                "pipeline.sequence.wire_cloud (or submit at raw capacity)")
        points = cloud.cloud.points.to(self.device)
        mask = cloud.cloud.mask.to(self.device)
        if (not cfg.localize_against_prior_map and not cfg.load_map_from_file
                and self.graph.is_empty() and not self._pending):
            return self._bootstrap(cloud, points, mask)

        odom_pose = np.asarray(cloud.prior_pose, np.float32)
        # the host's estimate of the reading's pose (stale under
        # pipelining): it steers the map crop and the risk stage's
        # reference pose only; the step applies the device total itself
        debug = cfg.working_mode != "robot"
        pose_est = self.total_correction @ odom_pose if debug else odom_pose
        (ref_pts, ref_mask, ref_normals, ref_pose, ref_id,
         fixed_overlap) = self._set_reference(pose_est)
        # First-registration exemption from the accept gate: a
        # relocalization against a prior / loaded map legitimately starts
        # with a correction over max_correction_magnitude.
        allow_large = self.graph.is_empty() and not self._registered_any
        self._registered_any = True
        out = self._app_step(points, mask, self._tensor(odom_pose),
                             self._total_dev, ref_pts, ref_normals, ref_mask,
                             self._tensor(ref_pose), fixed_overlap,
                             allow_large, *self._clf_params)
        self._total_dev = out.new_total

        # Speculative reference update in graph mode: adopt this frame's
        # aligned outputs (the loaded map's first frame, or the windowed
        # update); finalize keeps or rolls it back.
        saved_ref = (self._ref_device, self._ref_pose, self._since_ref_disp)
        spec_update = None
        if (not cfg.localize_against_prior_map
                and not cfg.localize_against_built_map):
            self._since_ref_disp += 1
            if cfg.load_map_from_file and self._ref_device is None:
                spec_update = "loadmap"
            elif self._since_ref_disp % cfg.reference_update_frequency == 0:
                spec_update = "window"
            if spec_update:
                self._ref_device = (out.aligned_points, out.filtered_mask,
                                    out.aligned_normals)
                self._ref_pose = pose_est
                self._since_ref_disp = 0
                self._ref_gen += 1

        self._pending.append(dict(
            cloud=cloud, out=out, scalars=_Scalars(out),
            n_iter=out.n_iterations, ref_id=ref_id, odom_pose=odom_pose,
            saved_ref=saved_ref, spec_update=spec_update,
            ref_gen=self._ref_gen, frame=frame))
        return None

    def _finalize_due(self) -> list[FrameResult]:
        """Once `pipeline_depth` frames are in flight, finalize the oldest
        half (or hand it to the finalizer); the results finished so far."""
        depth = max(int(self.cfg.pipeline_depth), 1)
        if len(self._pending) < depth:
            return []
        # finalize only the oldest half: the youngest frames' work may
        # still be running
        n = max(1, depth // 2)
        batch, self._pending = self._pending[:n], self._pending[n:]
        if self._fin_queue is not None:
            self._fin_queue.put(batch)
            return self._drain_results_locked()
        return self._finalize_batch(batch)

    def flush(self) -> list[FrameResult]:
        """Finalize every frame in flight and return the results not yet
        delivered."""
        with timing.span("aicp.app.flush"):
            if self._fin_queue is not None:
                with self._locked():
                    batch, self._pending = self._pending, []
                    if batch:
                        self._fin_queue.put(batch)
                self._fin_queue.join()
                with self._locked():
                    return self._drain_results_locked()
            with self._locked():
                batch, self._pending = self._pending, []
                return self._finalize_batch(batch)

    def drain_results(self) -> list[FrameResult]:
        """Async finalize: the results the finalizer thread finished since
        the last call, in submission order."""
        with self._state_lock:
            return self._drain_results_locked()

    def _drain_results_locked(self) -> list[FrameResult]:
        if self._fin_error is not None:
            err, self._fin_error = self._fin_error, None
            raise RuntimeError("async finalize failed") from err
        out, self._fin_results = self._fin_results, []
        return out

    def _finalizer_loop(self) -> None:
        """The async finalizer: waits for a batch's scalars outside the
        state lock, then runs its bookkeeping under it. One thread and a
        FIFO queue keep the results in submission order; an error is kept
        for the next drain_results / flush."""
        q = self._fin_queue
        while True:
            batch = q.get()
            try:
                if batch is None:
                    return
                hosts = self._wait_scalars(batch)
                with self._locked(), batch[0]["scalars"].on_stream():
                    self._fin_results.extend(
                        self._finalize(p, h) for p, h in zip(batch, hosts))
            except Exception as e:   # raised at the next drain / flush
                self._fin_error = e
            finally:
                q.task_done()

    def close(self) -> None:
        """Finalize what is in flight and stop the finalizer thread (no-op
        without async finalize)."""
        if self._fin_queue is None:
            return
        try:
            self.flush()
        finally:
            self._fin_queue.put(None)
            self._fin_thread.join(timeout=60)
            self._fin_queue = None

    def _finalize_batch(self, batch: list) -> list[FrameResult]:
        """Finalize `batch` on this thread: wait for its scalars, then the
        bookkeeping of each frame in order."""
        if not batch:
            return []
        hosts = self._wait_scalars(batch)
        return [self._finalize(p, h) for p, h in zip(batch, hosts)]

    def _wait_scalars(self, batch: list) -> list[np.ndarray]:
        """The batch's scalars on the host (a wait on their events), timed
        as "aicp.app.finalize_wait" under the batch's first frame."""
        with self.timing.section("aicp.app.finalize_wait",
                                 batch[0]["frame"]):
            return [p["scalars"].get() for p in batch]

    def _finalize(self, pending: dict, host: np.ndarray) -> FrameResult:
        with self.timing.section("aicp.app.finalize", pending["frame"]):
            return self._finalize_frame(pending, host)

    def _finalize_frame(self, pending: dict,
                        host: np.ndarray) -> FrameResult:
        """The host tail of a frame: gates, graph bookkeeping, maps and
        the sink's publishes."""
        cfg = self.cfg
        vis = self.vis
        cloud: AlignedCloud = pending["cloud"]
        out = pending["out"]
        ref_id = pending["ref_id"]
        if ref_id is None:      # graph reference: resolved here
            ref_id = self.graph.current_reference_id
        correction = host[0:16].reshape(4, 4)
        correction_raw = host[16:32].reshape(4, 4)
        new_total = host[32:48].reshape(4, 4)
        (risk_ok, accepted, overlap, fov, align, risk, rms,
         fsize) = host[48:56].tolist()
        risk_ok, accepted = bool(risk_ok), bool(accepted)
        n_iter = pending["n_iter"] if risk_ok else 0
        rms = rms if risk_ok else 0.0
        fsize = int(fsize)

        if cfg.working_mode != "robot":
            # host mirror of the device-side pre-transform by the total
            # correction accumulated before this frame
            cloud.prior_pose = self.total_correction @ pending["odom_pose"]
            cloud.corrected_pose = cloud.prior_pose
        read_f = Cloud(out.filtered_points, out.filtered_mask)
        if cfg.debug_dir:
            self._dump_debug_cloud(read_f, "prefiltered")
        if cfg.failure_prediction_mode:
            vis.publish_metric("fov_overlap", fov, cloud.utime)
            vis.publish_metric("alignability", align, cloud.utime)
            vis.publish_metric("alignment_risk", risk, cloud.utime)
        vis.publish_metric("octree_overlap", overlap, cloud.utime)

        if not accepted:
            # wrong alignment: frame dropped; its speculative reference is
            # undone unless a later frame has adopted a newer one (the
            # device total needs no undo: it chained I @ prev_total)
            if self._ref_gen == pending["ref_gen"]:
                (self._ref_device, self._ref_pose,
                 self._since_ref_disp) = pending["saved_ref"]
                self._ref_gen += 1
            return self._record(FrameResult(
                utime=cloud.utime, reference_id=ref_id,
                reading_id=self.graph.n_clouds, octree_overlap=overlap,
                fov_overlap=fov, alignability=align, risk=risk,
                correction=correction_raw, accepted=False,
                registered=risk_ok, n_iterations=n_iter, inlier_rms=rms,
                corrected_pose=np.asarray(cloud.corrected_pose),
                filtered_size=fsize))

        if risk_ok:
            aligned = Cloud(out.aligned_points, out.filtered_mask)
            if cfg.debug_dir:
                self._dump_debug_cloud(aligned, "aligned")
            cloud.update(aligned, correction, is_reference=False,
                         its_reference_id=self.graph.current_reference_id)
            self.graph.add(cloud)
            if pending["spec_update"]:
                # the dispatch side decided the update; finalize keeps the
                # graph in step and, while this frame's adoption is still
                # current, refines its pose to the corrected one
                self.graph.update_reference(self.graph.n_clouds - 1)
                if pending["spec_update"] == "window":
                    self.updates_counter += 1
                if self._ref_gen == pending["ref_gen"]:
                    self._ref_pose = np.asarray(cloud.corrected_pose)
            elif (cfg.localize_against_built_map
                  and not cfg.localize_against_prior_map):
                # built-map mode registers against the cropped map; the
                # windowed graph bookkeeping still runs for reference ids
                since = (self.graph.n_clouds
                         - (self.graph.current_reference_id + 1))
                if since % cfg.reference_update_frequency == 0:
                    self.graph.update_reference(self.graph.n_clouds - 1)
                    self.updates_counter += 1
        else:
            # risk or overlap gated: trust the prior for one step, force a
            # reference update
            cloud.update(read_f, is_reference=True,
                         its_reference_id=self.graph.current_reference_id)
            self.graph.add(cloud)
            self.graph.update_reference(self.graph.n_clouds - 1)
            self.updates_counter += 1
            self._ref_device = (out.filtered_points, out.filtered_mask,
                                out.filtered_normals)
            self._ref_pose = np.asarray(cloud.corrected_pose)
            self._since_ref_disp = 0
            self._ref_gen += 1

        self.total_correction = new_total
        last = self.graph.last()
        n_prev = self.graph.n_clouds - 1
        rel = np.linalg.inv(vis.get_path()[-1]) @ last.corrected_pose
        if np.linalg.norm(rel[:3, 3]) > 1.0:     # one pose marker a metre
            vis.publish_pose(last.corrected_pose, 0, "", cloud.utime)
            vis.publish_prior_pose(last.prior_pose, 0, "", cloud.utime)
            vis.publish_odom_pose(last.odom_pose, 0, "", cloud.utime)
            vis.publish_odom_to_map(np.linalg.inv(
                last.corrected_pose @ np.linalg.inv(last.odom_pose)),
                cloud.utime)
        merging = (cfg.localize_against_prior_map
                   and cfg.merge_aligned_clouds_to_map
                   and self.prior_map is not None)
        if last.is_reference:
            self._map_pending.append(last.cloud)
            self._map_np = None
            if not isinstance(vis, NullVisualizer):
                # the map's materialization reads the new reference once;
                # it is the map's last part
                map_np = self.aligned_map_np
                vis.publish_cloud(self._map_parts[-1], 0, "", cloud.utime)
                vis.publish_map(map_np, cloud.utime, 1)
        elif (cfg.localize_against_prior_map
              and n_prev % cfg.reference_update_frequency == 0):
            vis.publish_pose(last.corrected_pose, 0, "", cloud.utime)
            if merging:
                self.prior_map = self._map_cloud(np.concatenate(
                    [self.prior_map.to_numpy(), last.cloud.to_numpy()]))
        if merging and n_prev % 30 == 0:
            # amortized prior-map re-filter every 30 clouds
            self.prior_map = self._map_cloud(self.filter_cloud(
                self.prior_map, np.zeros(3, np.float32)).to_numpy())
        return self._record(FrameResult(
            utime=cloud.utime, reference_id=ref_id, reading_id=n_prev,
            octree_overlap=overlap, fov_overlap=fov, alignability=align,
            risk=risk, correction=correction, accepted=True,
            registered=risk_ok, n_iterations=n_iter, inlier_rms=rms,
            corrected_pose=np.asarray(last.corrected_pose),
            filtered_size=fsize))

    def _bootstrap(self, cloud: AlignedCloud, points, mask) -> FrameResult:
        """First cloud: prefilter it and make it the graph's reference and
        the built map's first cloud."""
        viewpoint = self._tensor(np.asarray(cloud.prior_pose)[:3, 3])
        fpts, fmask, fnormals = _prefilter(self.cfg, points, mask, viewpoint)
        filtered = Cloud(fpts, fmask)
        cloud.update(filtered, is_reference=True, its_reference_id=0)
        self.graph.initialize(cloud)
        self._ref_device = (fpts, fmask, fnormals)
        self._ref_pose = np.asarray(cloud.corrected_pose)
        self._ref_gen += 1
        self.aligned_map_np = filtered.to_numpy()
        self.vis.publish_cloud(self.aligned_map_np, 0, "", cloud.utime)
        self.vis.publish_pose(cloud.corrected_pose, 0, "", cloud.utime)
        self.vis.publish_map(self.aligned_map_np, cloud.utime, 1)
        return self._record(FrameResult(
            utime=cloud.utime, reference_id=0, reading_id=0,
            octree_overlap=-1.0, fov_overlap=-1.0, alignability=-1.0,
            risk=-1.0, correction=np.eye(4, dtype=np.float32),
            accepted=True, registered=False, n_iterations=0, inlier_rms=0.0,
            corrected_pose=np.asarray(cloud.corrected_pose),
            filtered_size=int(filtered.count())))

    def _record(self, res: FrameResult) -> FrameResult:
        self.frames.append(res)
        self._unrecorded -= 1
        return res

    def _dump_debug_cloud(self, cloud: Cloud, tag: str) -> None:
        """`debug_dir/cloud_<clouds in the graph:04d>_<tag>.pcd`, the JAX
        package's debug dumps."""
        os.makedirs(self.cfg.debug_dir, exist_ok=True)
        write_pcd(os.path.join(
            self.cfg.debug_dir,
            f"cloud_{self.graph.n_clouds:04d}_{tag}.pcd"), cloud.to_numpy())

    # ------------------------------------------------------------------
    # outputs
    # ------------------------------------------------------------------
    def inject_correction(self, correction: np.ndarray) -> None:
        """Fault injection: apply an artificial correction to the output
        chain (the reference's fake pose-correction scripts)."""
        self._set_total(np.asarray(correction, np.float32)
                        @ self.total_correction)

    def correct_pose(self, world_to_body: np.ndarray) -> np.ndarray:
        """Live odometry composed with the latest total correction, without
        waiting for a registration."""
        return self.total_correction @ np.asarray(world_to_body, np.float32)
